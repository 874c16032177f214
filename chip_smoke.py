#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

Builds the port's CUDA kernels from this checkout (one nvcc per source,
all at once), checks each against its plain PyTorch twin, drives the
port's serving paths through ``Predictor`` and ``MicroBatcher``, times
kernels against plain versions, and trains: bf16 mixed-precision train
steps through ``make_train_step`` on both Mixer routes (the forward kernel
with the plain block's backward, and under ``config.pallas_bwd`` the
backward kernels), ResMLP-S24 and gMLP-S steps, and AS-MLP-T steps with
drop-path; then runs the port's kernel lab over the Mixer-B/16 stack,
serves the eighteen families that have no kernel of their own (nineteen
models), checks the DCN ops, trains the nineteen, drives the serving
and evaluation layer (folder eval, the HTTP server, deploy, checkpoints),
and trains with the recipes (train_recipes: mixup/cutmix, label
smoothing, EMA, a warmup-cosine schedule) on both Mixer routes, with
probes, FLOPs and the train example's folder, metrics and checkpoints, runs
the parallel layer in a one-rank world, and splits the Mixer's channel MLP
over ranks (tensor parallelism: the split kernel entry in one process, then
two processes sharing the card over gloo), and runs the harness layer (the
per-model compare runs, the tuned-table generator, create_model). Models: Mixer-B/16 @224
(d_model 768, depth 12, token_dim 384; bench.py's config), ResMLP-S24 @224 (d_model 384, depth 24, expansion 4;
compare.py's), gMLP-S @224 (d_model 256, d_ffn 1536, depth 30;
compare.py's) and AS-MLP-T @224 (embed 96, depths [2, 2, 6, 2], shift 5:
the factory's defaults, compare.py's), full width and depth, random
weights from seed 0; and in phase 8, at the widths of compare.py's CONFIGS
and full depth: ViP (patch 14, d_model 256, depth 30, segments 16,
weighted), S2-MLP-wide (S2MLPv1_wide), S2-MLPv2 (patches [7, 2], d_model
[192, 384], depths [4, 14]), RaftMLP (two levels of dims 64 and 128),
Swin-MLP-T, DynaMixer-T, MS-MLP-T (embed 96, depths [2, 2, 6, 2], shift
5), Hire-MLP-Tiny (the factory's defaults), CycleMLP-B2, ActiveMLP-xT
(depths [2, 2, 4, 2], share [2, 4, 4, 8], intv 2), and the BatchNorm
families ConvMixer-768/32 (kernel 7, patch 7), SparseMLP (the factory's
defaults), RepMLPNet-B224, WaveMLP-T, MorphMLP-T and ConvMLP-M, and GFNet
(the factory's defaults: embed 768, depth 12, patch 16), GFNet-H-B
(GFNetPyramid, embed [96, 192, 384, 768], depths [3, 3, 27, 3]) and
Sequencer2D-S. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each one fails loudly; there is no CPU fallback):
  1. the card, the kernels' build time, and the tile, ring stages and
     shared memory of the blocks' GEMM core (gemm_sm90.cuh);
  2. every kernel vs its twin at the full block shape (B=8), two ragged
     small shapes and, for the W8A8 Mixer and ResMLP kernels and the
     Mixer training kernels, a chunked shape (CD ≥ 2048, ragged chunk and
     tokens), every output within 1.6e-2 of max(1, max|ref|); two calls on
     the same inputs agree bit for bit. The training kernels and the W8A8
     gMLP and ResMLP blocks also run at the train step's b128 and at b131;
     there each weight gradient's sum over images has partials of several
     images and a short last one (printed, and checked to occur), and the
     token and channel weight backwards' twins sum in the kernel's groups
     and slabs. The axial shift, a copy, equals its twin bit
     for bit at every AS-MLP-T stage shape (B=8) and five ragged shapes,
     both axes, both signs, bf16 and float32, and its autograd wrapper's
     backward on a non-contiguous gradient equals the twin at sign -1.
     The GEMM core alone (gemm_tn, both epilogues): Mixer-B/16's two
     channel products at B=8 and three ragged (M, N, K), each counted on the
     wgmma core, the first two also on the WMMA core, and a K % 8 != 0 shape
     counted on the WMMA route (the wgmma core refuses it), within the same
     band, two calls bit-equal. Its other modes alone: gemm_bf16 (MN-major
     A and/or B, row slabs with one f32 partial each) at Mixer-B/16's four
     channel backward products at B=8 and ragged ones (a short last slab),
     on the wgmma core and the WMMA core, and rows 72 bytes apart on the
     WMMA route; gemm_bf16 with batch entries at the bf16 gMLP block's
     three products at B=8 and b256 (Wsp shared in rows of 200, vn an
     N-major entry an image) and a ragged token product, on both cores;
     gemm_s8 (int8 with row and column scales, entries batched or shared)
     at gMLP-S's three products and the W8A8 Mixer-B/16 block's four at B=8
     and b256 and ragged ones, the Mixer's second channel product in the
     chunked mode (4 chunks of 768 codes; and 4 of 544, ending inside a
     128-code K step; one chunk; batched 32-code chunks), on the s8 wgmma
     core and mma.sync, bit-equal to its twin; the dual mode
     (gemm_bf16_dual: two products of one tile, both stored) at Mixer-B/16's
     two pairs (the channel data backward's and the token backward's) at
     B=8 and b256 and ragged shapes, an MN-major A among them, on both
     cores, and rows 72 bytes apart on the WMMA route; the Group mode
     (gemm_bf16_group: a sum over images, a group of images in each tile's
     K loop) at the token backward's dWt2 and dWt1 at B=8, b128 and b131 in
     its groups (partials of several images and a short last one, printed
     and checked to occur), a ragged one, the b131 dWt2 on the WMMA core's
     gemm_sum and rows 72 bytes apart on the WMMA route. Kernel 1 and the
     four training kernels also run at the forward's three route cases
     (MIXER_ROUTE_SHAPES: N = 33 with every product of the forward on the
     wgmma core; TD = 50, its second token product on WMMA; D = 36, every
     product on WMMA), the bf16 gMLP
     and ResMLP blocks at D=36 and at D=44, F=100, where their bf16
     products (some or all) take the WMMA route; at every shape the route
     counts of those kernels and of the W8A8 gMLP, Mixer and ResMLP blocks
     (three, four and three s8 wgmma products a call) are checked; the
     ResMLP blocks' three products alone (gemm_bf16 with Wt shared in rows
     of 200 and h an N-major entry an image; gemm_s8) at B=8 and b256 on
     both cores of each type, and kernel 1's two token products alone
     (gemm_bf16: Wt1 shared in rows of round_up(N, 8), Wt2 in rows of TD,
     xn and t N-major entries an image) at B=8, N=33 and b256 on the wgmma
     core, at B=8 on WMMA too;
  3. logits on 64 random images: Mixer-B/16 bf16 kernel path vs the plain
     bf16 path and the float32 forward (TF32 off); Mixer-B/16 int8 vs the
     bf16 kernel path and f32; ResMLP-S24 (γ = 0.1, perturbed affines)
     bf16 kernel path vs plain bf16 and f32, int8 vs f32; gMLP-S the same,
     and its blocks must move the logits (vs channel_proj2 zeroed) by at
     least 10x the kernel path's deviation from f32; AS-MLP-T bf16 kernel
     path vs plain bf16 and f32, int8 vs f32, and its shift must move the
     logits (vs shift_size 1, the identity shift) by at least 10x the
     kernel path's deviation from f32. Bands: bf16 5e-2 of
     max|logit| and 90% top-1, int8 0.1 and 90%. Launches rise by depth
     per forward (by 24, two shifts a block, for AS-MLP-T); a Mixer-B/16
     bf16 forward runs 4 x depth products (two token, two channel) on the
     wgmma core and none on the WMMA core, a Mixer-B/16 int8 forward 4 x
     depth products on
     the s8 wgmma core and none on mma.sync, a gMLP-S or ResMLP-S24 bf16
     forward 3 x depth on the wgmma core and none on WMMA, and a gMLP-S or
     ResMLP-S24 int8 forward 3 x depth on the s8 wgmma core and none on
     mma.sync (so do the serving runs of phase 4, each block library's
     products checked at every run);
  4. serving: (a) Mixer-B/16 bf16 Predictor(batch_size=32) behind
     MicroBatcher, 64 requests from 8 threads plus 2 resized ones;
     (b) Mixer-B/16 compute="int8" and bf16 Predictors on one model, and
     (c) ResMLP-S24 and (e) gMLP-S int8 and bf16 Predictors on one model,
     each pair served at the same time from 8 threads, so that an int8
     flag shared between threads would show; every batched answer equals
     predict() alone; launches equal depth × forwards per kernel;
     (d) ResMLP-S24 and (f) gMLP-S weights="int8" Predictors agree with
     the bf16 ones; (g) AS-MLP-T int8 and bf16 Predictors on one model
     served at once, shift launches 24 × the forwards of both, and (h) its
     weights="int8" Predictor agrees with the bf16 one;
  5. CUDA-event timings at b256: each kernel vs its twin, kernels 1 and 5
     (one forward body) also in turns on one input (the shift at
     AS-MLP-T's stage-1 shape, both axes; the W8A8 gMLP block beside the
     bytes of its f32 intermediates, the W8A8 Mixer, bf16 gMLP and both
     ResMLP blocks beside the bytes of their data flows); the GEMM core at
     the two channel products, on each core and against cuBLAS's
     torch.matmul; its other modes at gMLP-S's and ResMLP-S24's three int8
     products and the W8A8 Mixer block's four (against mma.sync and
     torch._int_mm), gMLP-S's and ResMLP-S24's three bf16 products,
     Mixer-B/16's two token products (f32 output, against WMMA and the
     batched torch.matmul(wt1, xn) and torch.matmul(wt2, t), beside their
     data flow's floor in kernel 1) and its four channel backward products
     (against WMMA and torch.matmul); the dual mode at the two backward
     pairs (against WMMA and two torch.matmul calls) and the Group mode at
     dWt2 and dWt1 (against
     WMMA's gemm_sum and torch.einsum); rows 6 and 7's data-flow floors
     before and after their redesign; the forwards
     kernel vs plain (Mixer-B/16, gMLP-S and AS-MLP-T bf16) and int8 vs
     bf16 (all four models);
  6. training, bf16 with f32 master weights: (a) all 13 gradients of one
     full-shape Mixer block (B=8), kernel route vs autograd of the kernel
     twin and vs the recompute route, per tensor; (b) Mixer-B/16 at b32:
     every parameter's gradient on the kernel route, the recompute route
     and the plain bf16 path against float32 (TF32 off), as one global
     relative L2 error, ≤ 1.7e-2, and ≤ 1.1e-2 between the two kernel
     routes and ≤ 1.5e-2 between either and the plain path (3x the values
     read on an H100);
     (c) 10 AdamW steps at b128 on one batch, each route with remat off
     and on: the loss descends, and remat gives the same losses; (d) the
     launches per step, depth × (1, or 2 for a forward kernel under
     remat), and the products of the block forward and the three backwards
     (4, 5, 3 and 4 a block: 16), all on the wgmma core, with a dual launch
     a token or channel data backward and two Group launches a token
     backward; (e) one
     ResMLP-S24 (γ = 0.1) and one gMLP-S step, gradients against their
     plain bf16 paths (≤ 3e-2, as (a)), each forward's 3 x depth products
     on the wgmma core; (f) Mixer-B/16 train img/s at b128 on each route
     and the plain path, and gMLP-S's and ResMLP-S24's on their kernel and
     plain paths, in turns, with peak memory; AS-MLP-T: (g) b32 gradients of the kernel
     path against the plain bf16 path (≤ 3e-2) and both against float32
     (global relative L2), 48 shift launches a step; (h) 10 AdamW steps at
     b128 with drop_path_rate 0.1 and a seeded generator, remat off and on:
     the loss descends, remat gives the same losses, 480 (720 under remat)
     shift launches; (i) train img/s at b128, kernel path and plain path
     in turns, with peak memory;
  7. the kernel lab (``jittor_mlp_tpu_torch.tools.kernel_lab``, the port of
     tools/kernel_lab.py) through its own functions: its check of the wide,
     noscratch and tokmajor kernels against kernel 1 at b8, then every
     variant of its table over the 12-block Mixer-B/16 stack at b256 (img/s
     and TFLOP/s; prod4 and noscratch4 launch what prod2 and noscratch2 do
     and are reported as them); each lab kernel launches 12 times a pass of
     its own variants, warm-up included, and all four of its products (the
     token pair through kernel 1's code, the channel pair) run on the wgmma
     core. Phase 2 also holds the four lab
     kernels against their twins at every bt and mode the lab uses, at b8,
     the stack's b256 and three ragged shapes, with each call's products on
     each core held to LAB_ROUTED, and phase 5 times them at b256;
  8. the eighteen families without a kernel, in nineteen models (plain
     PyTorch: cuBLAS products, cuDNN convolutions, gathers, cuFFT, cuDNN's
     LSTM), each built by its factory on
     the card (the six BatchNorm families in f32 first, their running
     statistics recalibrated there with the port's recalibrate_bn on four
     seeded batches of 32, then exported: at the seed's mean 0 and var 1
     the eval forward grows without bound and no band would measure
     anything):
     float32 logits on the card (TF32 off) against the same state dict on
     the CPU at b2, within 1e-3 of
     max|logit|; bf16 against card f32 on 64 images within 5e-2 of
     max|logit| and 90% top-1, compute="int8" within 0.1 (its top-1
     agreement printed: near ties of random-init logits); the
     blocks (each residual branch's last layer zeroed: identity blocks)
     move the bf16 logits at least 10x the bf16 deviation from f32; bf16
     and weights="int8" Predictors answer 16 images batched as they answer
     each alone; b256 img/s in bf16 and int8 (CUDA events) and peak memory.
     No port kernel launches in this run. ViP's and S2-MLPv2's gates read
     the mean over their tokens (``mean_gate``), and MS-MLP-T's and
     GFNet-H-B's layer scales are 0.5 (``layer_scale``), as state-dict edits
     of the seed's draw. Before the families: ``ops/lstm.bilstm`` (cuDNN)
     against ``bilstm_plain`` (the step loop) at Sequencer2D-S's stage-1
     shape (8192 sequences of 32 steps, C 192, H 48) in float32 (TF32 off,
     within 1e-4 of max|ref|) and in bf16, cuDNN's RNN kernels seen in
     the profiler (within 5e-2 of max|ref| of the float32 loop on the same
     bf16 values), no weight-compaction warning; GFNet's float32 filter
     (cuFFT) against a float64 CPU ``torch.fft`` of the same input at
     56 × 56 × 96 (within 1e-5 of max|ref|); their ms.
     A branch that ends in a bias-free conv is zeroed through the
     BatchNorm after it. For the BatchNorm families it prints the running
     variances that weights="int8" rounds to 0; RepMLPNet-B224's folded
     form (locality_injection()) keeps the f32 logits within 1e-3 of
     max|logit| of the unfolded model. Recalibrated, ConvMixer-768/32's
     and RepMLPNet-B224's random draws amplify rounding through their
     depth (the JAX package's bf16 forward as much as the port's), so
     their bands run each block on the f32 model's input to it (every
     block within 5e-2 in bf16 and 0.1 in int8 of its f32 output, and the
     logits after it in the bands above); their free-running deviations
     are printed;
  9. the DCN ops (``ops/dcn.py``; no model of the zoo calls them): DCN(256,
     256, 3, stride 1, padding 1) on (16, 256, 64, 64), its
     ``conv_offset_mask`` drawn so that offsets reach past the map's edges,
     and DCNPooling(1/16, pooled 7, output 256, trans, 4 samples a bin,
     trans_std 0.1; ``offset_mask_fc`` drawn so that trans and the mask
     vary) over 128 RoIs on (2, 256, 50, 50): card float32 (TF32 off)
     against the CPU within 1e-4 of max|ref|, bf16 against card float32
     within 5e-2; their ms. No port kernel launches in this run;
 10. the nineteen models of phase 8 train through ``make_train_step``, at
     the same widths and edits, drop-path at the factory's default rate
     (0.1 where that is 0): (a) at b2 in float32 (TF32 off), drop-path
     off, the loss and every gradient on the card against the CPU
     (within 1e-4 relative and 1e-3 global relative L2), and the bf16
     gradients against the card's float32 ones (within 5e-2; printed only
     for ConvMixer-768/32, RepMLPNet-B224 and ConvMLP-M); (b) one bf16
     AdamW step on 8 images with a cuda generator: a finite loss, every
     parameter with a gradient moved, every running statistic moved, and
     in each drop-path family the train forward with a generator away
     from the one without; (c) b128 bf16 train img/s (1 warm-up and 3
     timed steps, CUDA events) and peak memory, under remat or at b64
     where b128 does not fit; then the bf16 BiLSTM's cost on the step's
     cast copies against cuDNN's buffer. No port kernel launches in this
     run;
 11. the serving and evaluation layer on Mixer-B/16 @224, seed 0, bf16:
     (a) the native host libraries (``native_available()`` held,
     ``decode_available()`` printed), 600 PNGs of 256 × 320 written without
     PIL in 10 class folders, decoded at 256 equal to the sources' center
     crops bit for bit (through the native decoder, or PIL where the card
     has none; the line says which); (b) ``examples/eval.evaluate`` over
     ``ImageFolderDataset(decode_size=224)`` and ``BatchIterator(256)``:
     600 counted (the last batch padded from 88), each top-5 equal to a
     direct forward's on the same decoded batch, the hits recomputed, 36
     block launches, img/s end to end; (c) ``examples/serve.make_server``
     at --batch 32 on port 0: 8 clients POST 16 PNGs each, every answer
     equal to ``Predictor.predict`` on the decoded image, /stats, a
     malformed body's one-line 400, client p50/p99, launches 12 a
     forward; (d) ``deploy`` at b32, bf16 and ``int8=True``: 12 op nodes,
     12 launches a call, logits bit-equal to the eager forward, a b31
     input raises, ms against eager; (e) ``save_params``/``load_params``
     bit-equal, ``quantized_nbytes`` against the f32 bytes, an int8
     checkpoint's Predictor agreeing with bf16 on ≥ 15 of 16 images,
     ``save_train_state``/``restore_train_state`` around a b32 kernel-route
     step giving the next loss bit for bit; (f) ``utils.timing.throughput``
     of the b256 forward within 10% of phase 5's img/s, and the forward
     through the block op against the direct ctypes launch at b256 and b32;
 12. the training recipes (``train_recipes``): (a) the recipe step on
     Mixer-B/16 @224 at b128 bf16 (mixup 0.8, cutmix 1.0, smoothing 0.1,
     EMA 0.9999, AdamW with a warmup-cosine schedule) on the kernel route,
     the recompute route and the plain bf16 path from the same weights and
     generator seed: the first step's gradients between the routes within
     1.1e-2 and each route against the plain path within 1.5e-2 (phase
     6b's bands), 12 launches of each of the route's kernels a step, the
     masters, EMA, Adam state and gradients float32, the EMA within 4
     float32 ulps of its recurrence recomputed on the CPU, each update's
     lr equal to the schedule's; on each path, in turns (twice each, one
     warm-up and 3 timed steps, CUDA events), make_train_step, the recipe
     step, and the recipe step with its EMA off and with its mix and EMA
     off: the recipe's img/s beside phase 6f's make_train_step img/s and
     each variant's ms; the ms of smoothing with the mix (each mode) and
     of the EMA update alone;
     (b) ConvMLP-M at b64 bf16 under the recipe: every running statistic
     moves with the default bn_momentum, none with None; (c)
     ``utils.probes.capture`` on AS-MLP-T at b8: the card's f32 (TF32 off)
     and bf16 values at each tag against the CPU's f32 (f32 within 1e-3
     of max|ref|; bf16 printed), 48 shift launches; (d) ``Model.flops``
     of Mixer-B/16, AS-MLP-T and GFNet equal on the CPU (f32) and the card
     (f32, and after to_bf16(): the block ops' flop formulas); (e)
     ``examples.train.main`` with --data-dir, --mixed-precision,
     --metrics and --ckpt-dir on 40 seeded PNGs: 4 steps straight, then 2
     and a resume of 2 (the parameters printed as bit-equal or not, held
     within 1e-3 of max|param|), one metrics line a step, the last two
     checkpoints kept.
 13. the parallel layer (``parallel``) in a one-rank NCCL world on this
     card (a ``HashStore``, no port) and its 1 × 1 ('data', 'model') mesh,
     where every collective is an identity but every code path, kernel and
     microbatch schedule runs: (a) Mixer-B/16 @224 b128 bf16 AdamW on the
     kernel route, ``make_train_step(mesh=)`` against without: the loss and
     every parameter after one step bit-equal; (b)
     ``pipeline_runner(mesh, microbatches=4, data_axis="data")`` against
     the dense model: the loss within 1e-2 relative and the gradients
     within phase 6b's 1.5e-2 relative L2, then one pipelined
     ``make_train_step(mesh=)`` step (the blocks placed by
     ``pipeline_shardings``) launching each of the four training kernels 48
     times (12 blocks × 4 microbatches), and its img/s in turns with the
     dense step's and the mesh step's without a runner (CUDA events), then
     for each of the three a step's host issue time, wall time and card
     busy time (``torch.profiler``'s kernel times), and
     ``reduce_gradients``' host time; (c)
     ``token_parallel_runner`` on Mixer-B/16 and ResMLP-S24 at b256: bf16
     logits within 5e-2 of
     max|logit| of the dense f32 forward with ≥ 90% top-1 agreement, f32
     (TF32 off) within 1e-3; (d) ``Model.shard(mesh)`` on the bf16 kernel
     path and the recipe step with ``mesh=`` (mixup, cutmix, EMA), each
     bit-equal to the same call without the mesh; (e) a CPU check, not the
     card's: ``multihost.run_local_selftest()``, two gloo processes'
     data-parallel step of a small Mixer against the dense step, within
     1e-5. Multi-card speed and numerics are not measured here.
 14. tensor parallelism over the 'model' axis (``parallel/tensor.py``):
     (a) in this process, no collective: Mixer-B/16's block at b256 bf16
     (block_inputs, seed 0) with its channel MLP split over P = 2 and 4
     ranks, each rank's split entry (``mixer_block_bf16_tp``: the f32
     partial), the partials summed in rank order and the finishing pass,
     against row 1's whole ``fused_mixer_block`` and the plain split block
     within 1.6e-2 of max(1, max|ref|); two calls bit-equal; the entry
     and the pass against their twins; every product on the wgmma core;
     and before it rank 0's split entry at P = 2 at the forward's three
     route cases (MIXER_ROUTE_SHAPES) against its twin in the same band,
     two calls bit-equal, its products on the cores ROUTED gives at CD / 2;
     ms per rank of the entry at P = 2 and 4 beside row 1's, the
     pass's ms, in turns; (b) two processes of this script (``--tp-rank``)
     in a gloo world sharing this card, the 1 × 2 ('data', 'model') mesh
     (NCCL takes one card a rank): ``Model.shard(mesh)`` of Mixer-B/16 at
     b64, f32 (the plain split path) within 1e-4 of max|logit| of the
     unsharded f32 forward, bf16 (the split kernel entry) within 5e-2 of
     the unsharded bf16 forward with ≥ 99% top-1 agreement, 12 split
     entries, 12 finishing passes and 12 splits a forward, no whole kernel;
     two f32 and two bf16 AdamW steps of ``init_sharded`` +
     ``make_train_step(mesh=)`` at b32 on the recompute route against the
     dense steps (f32: losses within 1e-5 relative, parameters within
     1e-4 of each tensor's max, the first step's gradients gathered
     within 1e-4 relative L2; bf16: losses within 1e-4, the first step's
     gradients within 1e-2 relative L2 in all and 3e-2 in each tensor,
     parameters within 2e-4 of max(1, max|w|), 12 split entries a step),
     and each rank's parameters and AdamW state
     (``torch.cuda.memory_allocated``) against the dense model's (under
     0.6 of it). Speed across cards is not measured.
 15. the harness layer through its entry points, in at most about a minute:
     (a) ``tools/compare.main`` on Mixer-B/16 as the serving sweep runs it
     (b256 bf16 and int8 img/s over 3 forwards a timed run, the seven
     serving statistics at b64, and the card's f32 forward against the
     CPU's at b2 within 1e-3 of max|logit|), then as the train sweep runs
     it (b32, --try-remat, 5 steps a timed run): every field the generator
     reads present and finite, the record naming this card and its power
     limit, rows 1 and 2 launched 12 times a bf16 or int8 forward, each
     launch's four products on its wgmma core; (b)
     compare's serving run on S2-MLPv2 (seed 0): the rule's choice on this
     reading equals the committed ``tuned.SERVE`` row, and
     ``Predictor(S2MLPv2())`` resolves that dtype, its top-5 labels on 16
     images equal to the forward's in that dtype; (c) ``tools/gen_tuned``
     on (a)'s and (b)'s records writes a module that imports, whose rows
     are the rule's choices; (d) ``examples/create_model --model
     MLPMixerForImageClassification --time``: params, GFLOPs, the (8, 1000)
     output and ms per forward.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import functools
import json
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 1.6e-2  # two bf16 ulps of the output scale
# Phase 6b, the global relative L2 error of Mixer-B/16's bf16 gradients:
# 3x the values read on an H100 (PERF.md, Findings): each bf16 path vs float32
# 5.2e-3 to 5.7e-3; the kernel route vs the recompute route 3.7e-3; either
# vs the plain bf16 path 5.1e-3.
GRAD_VS_F32 = 1.7e-2
GRAD_ROUTES = 1.1e-2  # kernel route vs recompute route
GRAD_PLAIN = 1.5e-2  # a kernel route vs the plain bf16 path
GRAD_BLOCK = 3e-2  # phases 6a and 6e: each tensor, or one model's, between two bf16 paths
MIXER_B16 = dict(d_model=768, depth=12, token_dim=384)
RESMLP_S24 = dict(d_model=384, depth=24, expansion_factor=4)
GMLP_S = dict(image_size=224, patch_size=16, d_model=256, d_ffn=1536, depth=30)
DEPTH = MIXER_B16["depth"]  # one kernel launch per block
RES_DEPTH = RESMLP_S24["depth"]
GMLP_DEPTH = GMLP_S["depth"]
AS_MLP_T = {}  # the AS_MLP factory's defaults: embed 96, depths [2, 2, 6, 2], shift 5
SHIFTS = 2 * (2 + 2 + 6 + 2)  # shift launches per AS-MLP-T forward: two per block
# Phase 6g: AS-MLP-T's bf16 gradients against float32, global relative L2:
# 3x the value read on an H100 (1.23e-2 on either bf16 path, PERF.md)
AS_GRAD_VS_F32 = 3.7e-2
# the shift's phase-2 shapes (B, H, W, C) and shift sizes: every AS-MLP-T
# stage at B=8, then ragged ones: C=10 at shift 3, four groups (C=16,
# shift 5), groups of 7, 7, 6 (C=20, shift 3), H ≠ W, C < shift
SHIFT_SHAPES = [((8, 56, 56, 96), 5), ((8, 28, 28, 192), 5), ((8, 14, 14, 384), 5),
                ((8, 7, 7, 768), 5), ((2, 6, 7, 10), 3), ((2, 5, 6, 16), 5), ((2, 6, 5, 20), 3),
                ((1, 4, 9, 12), 5), ((2, 5, 4, 3), 5)]
# H100 SXM data sheet: dense tensor-core peaks and HBM rate
PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _draw(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    def lin(out, fan_in):  # weight (out, fan_in), bias (out,)
        return rn(out, fan_in, scale=fan_in ** -0.5), rn(out, scale=0.5)

    return rn, lin


def block_inputs(B, N, D, TD, CD, seed):
    """bf16 Mixer-block inputs on the card, from a seeded CUDA generator.

    Weights are scaled by 1/sqrt(fan_in) and biases drawn with std 0.5, so
    the outputs are O(1) and one misplaced bias element moves an output by
    far more than the tolerance band."""
    rn, lin = _draw(seed)

    def ln():  # LayerNorm weight, bias (D,)
        return rn(D, scale=0.1, mean=1.0), rn(D, scale=0.1)

    x = rn(B, N, D)
    w = (*ln(), *lin(TD, N), *lin(N, TD), *ln(), *lin(CD, D), *lin(D, CD))
    return x, w


def resmlp_inputs(B, N, D, F, seed):
    """bf16 ResMLP-block inputs on the card: weights as in block_inputs;
    affines α = 1 + 0.1·randn, β = 0.5·randn and gammas 1 + 0.1·randn, all
    O(1) (ResMLP-S24 starts γ at 1e-5, where a wrong block would move the
    output by almost nothing)."""
    rn, lin = _draw(seed)

    def aff():
        return rn(D, scale=0.1, mean=1.0), rn(D, scale=0.5)

    x = rn(B, N, D)
    a1, b1 = aff()
    g1 = rn(D, scale=0.1, mean=1.0)
    wt, bt = lin(N, N)
    a2, b2 = aff()
    g2 = rn(D, scale=0.1, mean=1.0)
    return x, (a1, b1, g1, wt, bt, a2, b2, g2, *lin(F, D), *lin(D, F))


def gmlp_inputs(B, N, D, F, seed):
    """bf16 gMLP-block inputs on the card: weights and biases as in
    block_inputs, LayerNorm affines near 1, the spatial bias with mean 1.0
    (the model's init value) and std 0.5."""
    rn, lin = _draw(seed)

    def ln(n):
        return rn(n, scale=0.1, mean=1.0), rn(n, scale=0.1)

    x = rn(B, N, D)
    ln1w, ln1b = ln(D)
    w1, b1 = lin(2 * F, D)
    sgu_w, sgu_b = ln(F)
    wsp = lin(N, N)[0]
    bs = rn(N, scale=0.5, mean=1.0)
    return x, (ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, *lin(D, F))


def train_inputs(kernel):
    """Inputs of a Mixer training kernel: block_inputs, and for the backward
    kernels an O(1) upstream gradient (dh for the token kernel, g for the
    channel kernels, where x stands in for h)."""

    def make(B, N, D, TD, CD, seed):
        x, w = block_inputs(B, N, D, TD, CD, seed)
        if kernel == "fwd_with_h":
            return x, w
        g = _draw(seed + 1)[0](B, N, D)
        ln1w, ln1b, wt1, bt1, wt2, _, ln2w, ln2b, wc1, bc1, wc2, _ = w
        if kernel == "token_bwd":
            return x, (g, ln1w, ln1b, wt1, bt1, wt2)
        return x, (g, ln2w, ln2b, bc1, wc1, wc2)

    return make


KERNEL_MODULES = ("mixer_block", "mixer_block_int8", "resmlp_block", "resmlp_block_int8",
                  "gmlp_block", "gmlp_block_int8", "mixer_block_bwd", "axial_shift", "kernel_lab",
                  "gemm_sm90")
PALLAS = "jittor_mlp_tpu/ops/pallas/"
SHIFT_REPLACES = PALLAS + "shift_kernel.py:50"
# The kernel lab's kernels: wrapper → (source, the TPU kernel it replaces).
# The variants (bt and mode) each runs are the lab's own table, lab_variants.
LAB_KERNELS = {
    "tokmajor_block": ("lab_tokmajor.cu", "tools/kernel_lab.py:124 (_call_tokmajor, body "
                       "_kernel_tokmajor :89)"),
    "wide_block": ("lab_wide.cu", "tools/kernel_lab.py:255 (_call, body _kernel_wide :39)"),
    "noscratch_block": ("lab_ablate.cu",
                        "tools/kernel_lab.py:255 (_call, body _kernel_noscratch :224)"),
    "ablate_block": ("lab_ablate.cu",
                     "tools/kernel_lab.py:255 (_call, bodies _make_kernel_ablate :166)"),
}
# the lab's check and stack shapes (b8, b256) and three ragged ones
# (LAB_ROUTED): D = 36 (the wide and token-major token products on the
# wgmma core at every bt, eight columns straddling two images; the others'
# on WMMA), TD = 50 (every kernel's second token product on WMMA), and
# D = 30 at N = 33 (the wide and token-major token products on WMMA at
# bt 2, on the wgmma core at bt 4 and 8)
LAB_SHAPES = [(8, 196, 768, 384, 3072), (8, 20, 36, 24, 72), (8, 33, 136, 50, 200),
              (8, 33, 30, 24, 72), (256, 196, 768, 384, 3072)]
LAB_TIMED = "gelu_tanh"  # the ablate kernel's mode in its phase-5 row: all of the block's work
LAB_ITERS = 10  # timed stack passes per variant in phase 7, after one warm-up pass
TRAIN_KERNELS = {"fwd_with_h": "mixer_block_bwd.py:129", "token_bwd": "mixer_block_bwd.py:220",
                 "chan_data_bwd": "mixer_block_bwd.py:306", "chan_wgt_bwd": "mixer_block_bwd.py:397"}
# Beyond the shared shapes: chunked CD, the train step's b128, and b131, where
# the last f32 partial of each weight-gradient sum takes fewer images
# than the others (on an H100: dWt1/dWt2 in 33 partials of 4 images, the
# last of 3; dWc1/dWc2 in 2 slabs of 66 images, the last of 65).
TRAIN_SHAPES = [(2, 33, 136, 50, 2056), (128, 196, 768, 384, 3072), (131, 196, 768, 384, 3072)]
# argument of the weight that gives the inner width (TD, CD) of a
# weight-gradient kernel's grouped sums
GROUPED = {"token_bwd": 3, "chan_wgt_bwd": 4}
# kernels whose products run on gemm_sm90.cuh's core, and the routes of one
# call's products at (B, N, D, TD, CD) or (B, N, D, F): a bf16 product takes
# the wgmma core where TMA can load both operands (rows a multiple of 16
# bytes apart: D and CD, or D and F, multiples of 8), else the WMMA core;
# the W8A8 blocks' products take the s8 wgmma core (their operands are
# padded to 32 codes), none mma.sync.


def _bf16_routes(*on_sm90):
    return {"sm90": sum(on_sm90), "wmma": len(on_sm90) - sum(on_sm90)}


def _mixer_forward_routes(s, width=None):
    """The Mixer block forward's four products (mixer_forward.cuh): Wt1·xn
    an entry of W columns (Wt1 copied into rows of round_up(N, 8), xn rows
    W apart), Wt2·t an entry (Wt2 rows TD apart, t rows W apart), hn·Wc1ᵀ
    (rows D apart), c·Wc2ᵀ (rows CD apart; CD_r for the split entry). W is
    ``width``, by default D: an entry an image."""
    W = s[2] if width is None else width
    return _bf16_routes(W % 8 == 0, W % 8 == s[3] % 8 == 0, s[2] % 8 == 0, s[4] % 8 == 0)


ROUTED = {
    "fused_mixer_block": _mixer_forward_routes,
    "fwd_with_h": _mixer_forward_routes,
    # the dual product (two: hn·Wc1ᵀ, g·Wc2 with Wc2ᵀ copied; rows D apart),
    # then dhn = dcp·Wc1 (dcp rows CD apart)
    "chan_data_bwd": lambda s: _bf16_routes(s[2] % 8 == 0, s[2] % 8 == 0,
                                            s[2] % 8 == s[4] % 8 == 0),
    # the dual product an image (two), dWt2 and dWt1 in image groups, dxn:
    # xn, dh, t and dtp rows D apart, the weights copied into rows of Np
    "token_bwd": lambda s: _bf16_routes(*[s[2] % 8 == 0] * 5),
    # the two recompute products, then dcpᵀ·hn and gᵀ·c (rows CD and D apart)
    "chan_wgt_bwd": lambda s: _bf16_routes(s[2] % 8 == 0, *[s[2] % 8 == s[4] % 8 == 0] * 3),
    # xn·W1ᵀ (rows D apart), Wsp·vn (vn rows F apart), g·W2ᵀ (rows F apart)
    "fused_gmlp_block": lambda s: _bf16_routes(s[2] % 8 == 0, s[3] % 8 == 0, s[3] % 8 == 0),
    "fused_gmlp_block_int8": lambda s: {"sm90_s8": 3, "mma_s8": 0},
    # Wt·h per image (h rows D apart), h2b·W1ᵀ (rows D apart), c·W2ᵀ (rows F apart)
    "fused_resmlp_block": lambda s: _bf16_routes(s[2] % 8 == 0, s[2] % 8 == 0, s[3] % 8 == 0),
    # the token product, FF1, FF2 (chunked where F >= 2048 and F % 4 == 0)
    "fused_resmlp_block_int8": lambda s: {"sm90_s8": 3, "mma_s8": 0},
    # the two token products, the two channel products (the second chunked)
    "fused_mixer_block_int8": lambda s: {"sm90_s8": 4, "mma_s8": 0},
}
# The lab kernels' token-product width W at (shape, bt): bt images side by
# side in the wide and token-major kernels, one image in the others (their
# kernel does not depend on bt).
LAB_WIDTH = {"tokmajor_block": lambda s, bt: bt * s[2], "wide_block": lambda s, bt: bt * s[2],
             "noscratch_block": lambda s, bt: s[2], "ablate_block": lambda s, bt: s[2]}
# the routes of one lab call's four products at (shape, bt): kernel 1's
# code (mixer_forward.cuh's token products, gemm_tn) at that width
LAB_ROUTED = {fn: (lambda s, bt, w=w: _mixer_forward_routes(s, w(s, bt)))
              for fn, w in LAB_WIDTH.items()}
# products on the GEMM cores per block of each routed forward kernel at the
# models' widths (every operand one TMA can load), by library: (route,
# products a launch); and on the bf16 wgmma core per Mixer-B/16 block of a
# kernel-route step: the forward's four (two token, two channel), the token
# backward's five (a dual product counts two), the channel data backward's
# three and the channel weight backward's four: 16
BLOCK_PRODUCTS = {"mixer_block": ("sm90", 4), "mixer_block_int8": ("sm90_s8", 4),
                  "gmlp_block": ("sm90", 3), "gmlp_block_int8": ("sm90_s8", 3),
                  "resmlp_block": ("sm90", 3), "resmlp_block_int8": ("sm90_s8", 3)}
BWD_PRODUCTS = {"fwd_with_h": 4, "token_bwd": 5, "chan_data_bwd": 3, "chan_wgt_bwd": 4}
# the wgmma core's dual and Group launches per launch of each backward kernel
BWD_MODES = {"token_bwd": {"dual": 1, "group": 2}, "chan_data_bwd": {"dual": 1, "group": 0}}
# the kernels line's rows of a block library's products on the core
PRODUCT_ROWS = {"mixer_block_int8": "gemm_s8_mixer_sm90", "gmlp_block": "gemm_bf16_gmlp_sm90",
                "gmlp_block_int8": "gemm_s8_sm90", "resmlp_block": "gemm_bf16_resmlp_sm90",
                "resmlp_block_int8": "gemm_s8_resmlp_sm90"}
# The GEMM core's phase-2 shapes (M, N, K): Mixer-B/16's two channel
# products at B = 8, then ragged M, N and K (one row; K = 40 and 136 end
# in a part of a 64-wide K step; N = 72 and 200 in a part of a 256-wide
# tile); each with the GELU and the residual epilogue, on the wgmma core.
GEMM_SHAPES = [(1568, 3072, 768), (1568, 768, 3072), (97, 72, 40), (165, 200, 136),
               (1, 3072, 768)]
GEMM_WMMA_SHAPE = (33, 40, 50)  # K % 8 != 0: rows 100 bytes apart, the WMMA route
GEMM_TIMED = [(256 * 196, 3072, 768), (256 * 196, 768, 3072)]  # b256's channel products
GEMM_REPLACES = PALLAS + "mixer_block.py:157 (the channel half of fused_mixer_block)"
# Kernel 1's, the forward-with-h's and the split entry's route cases
# (ROUTED): both token products on the wgmma core at a ragged N (N = 33:
# Wt1 copied into rows of 40); the second on the WMMA core (TD = 50: Wt2's
# rows 100 bytes apart); every product on the WMMA core (D = 36, CD = 100:
# rows 72 and 200 bytes apart, which TMA cannot load).
MIXER_ROUTE_SHAPES = [(4, 33, 136, 48, 200), (5, 33, 136, 50, 200), (2, 33, 36, 50, 100)]


def kernel_table(mods):
    """name → (module, wrapper, twin, inputs, shapes, source, replaced, depth)."""
    mixer_shapes = [(8, 196, 768, 384, 3072), (3, 20, 40, 24, 72), (5, 33, 136, 50, 200)]
    # kernel 1 and the training kernels also at the forward's route cases
    fwd_shapes = mixer_shapes[:2] + MIXER_ROUTE_SHAPES
    res_shapes = [(8, 196, 384, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    # the bf16 ResMLP block also at D = 36 (the token product's h and FF1's
    # rows 72 bytes apart: the WMMA route, FF2 on wgmma) and D = 44, F = 100
    # (all three on WMMA) (ROUTED)
    res_bf16_shapes = res_shapes + [(3, 20, 36, 72), (2, 13, 44, 100)]
    # the W8A8 ResMLP block: a chunked shape (F = 2056: four chunks of 514
    # codes padded to 544, each ending inside a 128-code K step), and, as its
    # token product is one launch over the images, the batches the path runs
    # it at: b128 and b131 (a short last entry)
    res_int8_shapes = res_shapes + [(2, 33, 136, 2056), (128, 196, 384, 1536),
                                    (131, 196, 384, 1536)]
    gmlp_shapes = [(8, 196, 256, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    # the bf16 gMLP block also at D = 36 (GEMM1's rows 72 bytes apart: the
    # WMMA route, the other two on wgmma) and D = 44, F = 100 (all three on
    # WMMA) (ROUTED)
    gmlp_bf16_shapes = gmlp_shapes + [(3, 20, 36, 72), (2, 13, 44, 100)]
    # the W8A8 gMLP block's token product is one launch over the images (a
    # 3-D tensor map for all but the last, a 2-D one for the last), so it is
    # also held at the batches the path runs it at: b128 and b131
    gmlp_int8_shapes = gmlp_shapes + [(128, 196, 256, 1536), (131, 196, 256, 1536)]
    return {
        "fused_mixer_block": (
            mods["mixer_block"], "fused_mixer_block", "mixer_block_ref", block_inputs,
            fwd_shapes, "mixer_block.cu", "mixer_block.py:157", DEPTH),
        "fused_mixer_block_int8": (
            mods["mixer_block_int8"], "fused_mixer_block_int8", "mixer_block_int8_ref",
            block_inputs, mixer_shapes + [(2, 33, 136, 50, 2056)],
            "mixer_block_int8.cu", "mixer_block_int8.py:121", DEPTH),
        "fused_resmlp_block": (
            mods["resmlp_block"], "fused_resmlp_block", "resmlp_block_ref", resmlp_inputs,
            res_bf16_shapes, "resmlp_block.cu", "resmlp_block.py:54", RES_DEPTH),
        "fused_resmlp_block_int8": (
            mods["resmlp_block_int8"], "fused_resmlp_block_int8", "resmlp_block_int8_ref",
            resmlp_inputs, res_int8_shapes, "resmlp_block_int8.cu", "resmlp_block_int8.py:69",
            RES_DEPTH),
        "fused_gmlp_block": (
            mods["gmlp_block"], "fused_gmlp_block", "gmlp_block_ref", gmlp_inputs,
            gmlp_bf16_shapes, "gmlp_block.cu", "gmlp_block.py:57", GMLP_DEPTH),
        "fused_gmlp_block_int8": (
            mods["gmlp_block_int8"], "fused_gmlp_block_int8", "gmlp_block_int8_ref",
            gmlp_inputs, gmlp_int8_shapes, "gmlp_block_int8.cu", "gmlp_block_int8.py:61",
            GMLP_DEPTH),
        **{k: (mods["mixer_block_bwd"], k, f"{k}_ref", train_inputs(k),
               fwd_shapes + TRAIN_SHAPES,
               "mixer_block_bwd.cu", replaced, DEPTH)
           for k, replaced in TRAIN_KERNELS.items()},
    }


def launches(mod, fn):
    """The launch count of wrapper fn of a kernel module."""
    return mod.LAUNCHES[fn] if isinstance(mod.LAUNCHES, dict) else mod.LAUNCHES


def outputs(got):
    return got if isinstance(got, tuple) else (got,)


def grouping(mod, fn, x, w):
    """(images per f32 partial, partials, images in the last) of a
    weight-gradient kernel's sums over images, as the kernel groups them."""
    per = mod.images_per_group(fn, x, w[GROUPED[fn]].shape[0])
    n = -(-x.shape[0] // per)
    return per, n, x.shape[0] - (n - 1) * per


def gemm_inputs(M, N, K, residual, seed):
    """a (M, K), b (N, K), bias (N,) and the keyword of one epilogue, bf16 on
    the card, scaled as block_inputs scales a channel product's."""
    rn, lin = _draw(seed)
    b, bias = lin(N, K)
    kw = {"residual": rn(M, N)} if residual else {"act": "gelu_tanh"}
    return rn(M, K), b, bias, kw


def phase_gemm(mod):
    """Phase 2 for the GEMM core of the channel products: gemm_tn on the
    auto route at GEMM_SHAPES (each counted on the wgmma core) and on the
    WMMA core at the first two, at GEMM_WMMA_SHAPE on the auto route
    (counted on the WMMA core; the wgmma core refuses it), both epilogues:
    within TOL of max(1, max|ref|) of gemm_tn_ref, two calls bit-equal, one
    launch a call. Returns the largest max|Δ|."""
    worst = 0.0
    cases = ([(shape, "auto", "sm90") for shape in GEMM_SHAPES]
             + [(shape, "legacy", "wmma") for shape in GEMM_SHAPES[:2]]
             + [(GEMM_WMMA_SHAPE, "auto", "wmma")])
    for shape, core, route in cases:
        for residual in (False, True):
            a, b, bias, kw = gemm_inputs(*shape, residual, seed=sum(shape) + residual)
            tag = f"gemm_tn {shape} {'residual' if residual else 'gelu_tanh'} core={core}"
            before, routes0 = mod.LAUNCHES, mod.routes()
            got = mod.gemm_tn(a, b, bias, core=core, **kw)
            torch.cuda.synchronize()
            again = mod.gemm_tn(a, b, bias, core=core, **kw)
            torch.cuda.synchronize()
            routes1 = mod.routes()
            moved = {k: routes1[k] - routes0[k] for k in routes1}
            want_routes = {k: 2 * (k == route) for k in routes1}
            check(mod.LAUNCHES == before + 2, f"{tag}: LAUNCHES did not rise by 1 a call")
            check(moved == want_routes, f"{tag}: routes {moved}, want {want_routes}")
            check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
            want = mod.gemm_tn_ref(a, b, bias, **kw)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            rel = err / max(1.0, want.float().abs().max().item())
            worst = max(worst, err)
            print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (limit {TOL}); two calls "
                  f"bit-equal; on the {route} core ({json.dumps(moved)})", flush=True)
            check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
            del a, b, bias, kw, got, again, want
    a, b, bias, kw = gemm_inputs(*GEMM_WMMA_SHAPE, False, seed=0)
    try:
        mod.gemm_tn(a, b, bias, core="sm90", **kw)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, f"gemm_tn core=sm90 at {GEMM_WMMA_SHAPE} (rows 100 bytes apart) did not raise")
    print(f"[2] gemm_tn core=sm90 at {GEMM_WMMA_SHAPE}: refused (TMA needs 16-byte row strides)",
          flush=True)
    return worst


# The core's bf16 modes alone (gemm_bf16): Mixer-B/16's four channel
# backward products at B = 8 (rows 1568, slabs of 4 images: 2 partials) as
# (M, N, K, a_mn, b_mn, slab): hn·Wc1ᵀ, g·Wc2 (Wc2 N-major), dcpᵀ·hn and
# gᵀ·c (both operands MN-major, row slabs); then ragged ones (M, N against
# the 192 tile, K against the 64-row step): an MN-major A alone, slabs of
# 66 rows over 165 (the last 33), one slab; and rows 72 bytes apart
# (M = 36), which take the WMMA route with the same slabs.
CORE_BF16 = [(1568, 3072, 768, False, False, None), (1568, 3072, 768, False, True, None),
             (3072, 768, 1568, True, True, 784), (768, 3072, 1568, True, True, 784),
             (200, 72, 136, True, False, None), (200, 136, 165, True, True, 66),
             (40, 200, 136, True, True, None)]
CORE_BF16_WMMA = (36, 50, 100, True, True, 40)
# The bf16 gMLP block's three products alone (gemm_bf16 with batch
# entries) at gMLP-S's B = 8, as (entries, M, N, K, A's row length, b_mn):
# GEMM1 (B·N rows, 2F, D), the token product per image (Wsp shared, in rows
# of Np = 200 read as its first N = 196 columns; vn an N-major entry an
# image) and GEMM2 (B·N, D = 256 against the 192 tile, F); then a ragged
# token product (N = 20 in rows of 24, F = 72).
GMLP_BF16 = [(1, 1568, 3072, 256, 256, False), (8, 196, 1536, 196, 200, True),
             (1, 1568, 256, 1536, 1536, False), (3, 20, 72, 20, 24, True)]
GMLP_BF16_TIMED = [(1, 256 * 196, 3072, 256, 256, False), (256, 196, 1536, 196, 200, True),
                   (1, 256 * 196, 256, 1536, 1536, False)]
# The core's int8 form alone (gemm_s8) at gMLP-S's three products at B = 8:
# (entries, M, N, K, a batched, b batched, chunk): GEMM1 (B·N rows, 2F, Dp),
# the token product per image (qWsp shared, qv an entry an image: N, F,
# Np) and GEMM2 (B·N, D = 256 against a 192-wide tile, Fp); then ragged
# ones.
CORE_S8 = [(1, 1568, 3072, 256, False, False, None), (8, 196, 1536, 224, False, True, None),
           (1, 1568, 256, 1536, False, False, None), (1, 97, 72, 64, False, False, None),
           (3, 20, 200, 32, True, True, None), (1, 1, 3072, 288, False, False, None)]
# The W8A8 Mixer block's four products alone at Mixer-B/16's B = 8: the two
# token products per image (the weight shared, the codes an entry an image:
# TD × D over Np, N × D over TDp), the first channel product (B·N, CD, Dp)
# and the second in the chunked mode (B·N, D, 4 chunks of 768 codes); then
# the chunked mode at the ragged chunk of phase 2's (2, 33, 136, 50, 2056)
# block (4 chunks of ck 514 padded to 544 codes, each ending inside a
# 128-code K step; M and N ragged against the 192×96 tile), at one chunk,
# and with batched entries and 32-code chunks.
MIXER_S8 = [(8, 384, 768, 224, False, True, None), (8, 196, 768, 384, False, True, None),
            (1, 1568, 3072, 768, False, False, None), (1, 1568, 768, 3072, False, False, 768),
            (1, 66, 136, 2176, False, False, 544), (1, 97, 40, 96, False, False, 96),
            (3, 20, 100, 128, True, True, 32)]
# The ResMLP blocks' three products alone at ResMLP-S24's B = 8 (N = 196,
# D = 384, F = 1536): bf16 as GMLP_BF16's (entries, M, N, K, A's row length,
# b_mn): the token product per image (Wt shared, in rows of Np = 200 read as
# its first 196 columns; h an N-major entry an image), FF1 (B·N, F, D), FF2
# (B·N, D = two whole 192-wide tiles, F); int8 as CORE_S8's: the token
# product (qWt shared, qh an entry an image: N, D, Np), FF1 (B·N, F, Dp),
# FF2 (B·N, D, F: one chunk at F = 1536)
RES_BF16 = [(8, 196, 384, 196, 200, True), (1, 1568, 1536, 384, 384, False),
            (1, 1568, 384, 1536, 1536, False)]
RES_BF16_TIMED = [(256, 196, 384, 196, 200, True), (1, 256 * 196, 1536, 384, 384, False),
                  (1, 256 * 196, 384, 1536, 1536, False)]
# Kernel 1's two token products alone (the forward-with-h's and the split
# entry's too), as GMLP_BF16's: Wt1·xn_b (Wt1 shared in rows of
# round_up(N, 8), xn an N-major entry an image; K = N tokens) and Wt2·t_b
# (Wt2 shared in rows of TD, t an N-major entry an image; M = N tokens),
# at Mixer-B/16's B = 8, at N = 33 (Wt1 in rows of 40), and at b256
MIXER_TOKEN_BF16 = [(8, 384, 768, 196, 200, True), (8, 196, 768, 384, 384, True),
                    (4, 48, 136, 33, 40, True), (4, 33, 136, 48, 48, True)]
MIXER_TOKEN_TIMED = [(256, 384, 768, 196, 200, True), (256, 196, 768, 384, 384, True)]
RES_S8 = [(8, 196, 384, 224, False, True, None), (1, 1568, 1536, 384, False, False, None),
          (1, 1568, 384, 1536, False, False, None)]
RES_S8_TIMED = [(256, 196, 384, 224, False, True, None),
                (1, 256 * 196, 1536, 384, False, False, None),
                (1, 256 * 196, 384, 1536, False, False, None)]
# b256's products for phase 5 (and phase 2): gMLP-S's three (int8), the W8A8
# Mixer-B/16 block's four, gMLP-S's three bf16 ones and Mixer-B/16's four
# channel backward ones (bf16; slabs of 128 images, as on an H100)
CORE_S8_TIMED = [(1, 256 * 196, 3072, 256, False, False, None),
                 (256, 196, 1536, 224, False, True, None),
                 (1, 256 * 196, 256, 1536, False, False, None)]
MIXER_S8_TIMED = [(256, 384, 768, 224, False, True, None), (256, 196, 768, 384, False, True, None),
                  (1, 256 * 196, 3072, 768, False, False, None),
                  (1, 256 * 196, 768, 3072, False, False, 768)]
CORE_BF16_TIMED = [(256 * 196, 3072, 768, False, False, None),
                   (256 * 196, 3072, 768, False, True, None),
                   (3072, 768, 256 * 196, True, True, 128 * 196),
                   (768, 3072, 256 * 196, True, True, 128 * 196)]
S8_REPLACES = PALLAS + "gmlp_block_int8.py:61 (the products of fused_gmlp_block_int8)"
MIXER_S8_REPLACES = PALLAS + "mixer_block_int8.py:121 (the products of fused_mixer_block_int8)"
GMLP_BF16_REPLACES = PALLAS + "gmlp_block.py:57 (the products of fused_gmlp_block)"
RES_BF16_REPLACES = PALLAS + "resmlp_block.py:54 (the products of fused_resmlp_block)"
MIXER_TOKEN_REPLACES = PALLAS + "mixer_block.py:157 (the token half of fused_mixer_block)"
RES_S8_REPLACES = PALLAS + "resmlp_block_int8.py:69 (the products of fused_resmlp_block_int8)"
BWD_REPLACES = (PALLAS + "mixer_block_bwd.py:397 (the products of _chan_wgt_bwd; with :220 "
                "and :306, the products of _token_bwd and _chan_data_bwd)")
DUAL_REPLACES = (PALLAS + "mixer_block_bwd.py:220 (_token_bwd's recompute and Wt2ᵀ·dh products) "
                 "and :306 (_chan_data_bwd's cp and dc products)")
GROUP_REPLACES = PALLAS + "mixer_block_bwd.py:220 (_token_bwd's dWt1 and dWt2 sums over images)"
# The core's dual mode alone (gemm_bf16_dual), as (entries, M, N, K, the A
# operands' row length, a_mn, b_mn, A batched, B batched): Mixer-B/16's two
# pairs at B = 8, the channel data backward's (hn·Wc1ᵀ, g·Wc2 with Wc2ᵀ
# K-major; 192×96 tiles) and the token backward's (Wt1·xn_b, Wt2ᵀ·dh_b:
# the weights shared in rows of Np = 200, xn and dh N-major an entry an
# image; 192×64 tiles); ragged ones (M, N against the tile, K against the
# 64-wide step; an MN-major A); rows 72 bytes apart (K = 36), the WMMA
# route; and b256's two pairs.
DUAL = [(1, 1568, 3072, 768, 768, False, False, False, False),
        (8, 384, 768, 196, 200, False, True, False, True),
        (1, 97, 200, 136, 136, False, False, False, False),
        (3, 50, 136, 33, 40, False, True, False, True),
        (2, 200, 72, 40, 200, True, True, False, True)]
DUAL_WMMA = (1, 36, 40, 36, 36, False, False, False, False)
DUAL_TIMED = [(1, 256 * 196, 3072, 768, 768, False, False, False, False),
              (256, 384, 768, 196, 200, False, True, False, True)]
# The core's Group mode alone (gemm_bf16_group): the token backward's dWt2
# (M = N tokens, N = TD) and dWt1 (TD, N) over images of K = D, at B = 8,
# b128 and b131 in the kernel's groups (the token backward's
# images_per_group), as (images, M, N, K, per or None for the kernel's);
# a ragged one in groups of 2 (the last of 1); rows 72 bytes apart (K =
# 36), the WMMA route's gemm_sum; and b256's two for phase 5.
GROUP = [(B, M, N, 768, None) for B in (8, 128, 131) for M, N in ((196, 384), (384, 196))] + [
    (5, 33, 50, 136, 2)]
GROUP_WMMA = (5, 20, 24, 36, 2)
GROUP_TIMED = [(256, 196, 384, 768, None), (256, 384, 196, 768, None)]


def bf16_core_inputs(M, N, K, a_mn, b_mn, seed):
    """bf16 operands of gemm_bf16 on the card, O(1) products: a (M, K) or
    (K, M), b (N, K) or (K, N), b scaled by 1/sqrt(K)."""
    rn, _ = _draw(seed)
    a = rn(K, M) if a_mn else rn(M, K)
    b = rn(K, N, scale=K ** -0.5) if b_mn else rn(N, K, scale=K ** -0.5)
    return a, b


def gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed):
    """bf16 operands of one of the bf16 gMLP block's products: a (M, K), a
    view of rows lda long (the columns past K random: the kernel must not
    read them), shared; b (N, K), or with b_mn (nz, K, N), an entry an
    image; b scaled by 1/sqrt(K)."""
    rn, _ = _draw(seed)
    a = rn(M, lda)[:, :K]
    b = rn(nz, K, N, scale=K ** -0.5) if b_mn else rn(N, K, scale=K ** -0.5)
    return a, b


def s8_core_inputs(nz, M, N, K, a_batched, b_batched, chunk, seed):
    """int8 codes in [-127, 127] and f32 scales of gemm_s8 on the card: rs
    per row (per row and chunk of K with ``chunk``), cs per column, each
    batched where its operand is."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def codes(*shape):
        q = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int32)
        return q.to(torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=g, device="cuda") * 2e-3 + 1e-4

    pieces = () if chunk is None else (K // chunk,)
    a = codes(nz, M, K) if a_batched else codes(M, K)
    b = codes(nz, N, K) if b_batched else codes(N, K)
    rs = scales(nz, M, *pieces) if a_batched else scales(M, *pieces)
    cs = scales(nz, N) if b_batched else scales(N)
    return a, b, rs, cs


def dual_core_inputs(nz, M, N, K, lda, a_mn, b_mn, a_batched, b_batched, seed):
    """bf16 operands of gemm_bf16_dual on the card, O(1) products: a1, a2
    (M, K) or (K, M), shared views of rows lda long (the columns past them
    random: the kernel must not read them) or batched; b1, b2 (N, K) or
    (K, N), scaled by 1/sqrt(K), shared or batched."""
    rn, _ = _draw(seed)

    def a():
        rows, cols = (K, M) if a_mn else (M, K)
        return rn(nz, rows, cols) if a_batched else rn(rows, lda)[:, :cols]

    def b():
        shape = (K, N) if b_mn else (N, K)
        return rn(*((nz,) if b_batched else ()), *shape, scale=K ** -0.5)

    return a(), b(), a(), b()


def group_inputs(images, M, N, K, seed):
    """a (images, M, K) and b (images, N, K) bf16 on the card, b scaled by
    1/sqrt(K)."""
    rn, _ = _draw(seed)
    return rn(images, M, K), rn(images, N, K, scale=K ** -0.5)


def token_group(bwd, images, M, N, K):
    """Images per partial of the token backward's dWt1 and dWt2 at images
    of (tokens, D) = (min(M, N), K) and TD = max(M, N) on this card."""
    x = torch.empty((images, min(M, N), K), dtype=torch.bfloat16, device="cuda")
    return bwd.images_per_group("token_bwd", x, max(M, N))


def _core_case(mod, tag, call, twin, route_fn, want_moved, exact=False):
    """One core-mode case: launched twice (bit-equal, one launch each, the
    routes moved as wanted), held within TOL of max(1, max|ref|) of its
    twin, or with ``exact`` bit-equal to it. Returns max|Δ|."""
    before, routes0 = mod.LAUNCHES, route_fn()
    got = call()
    torch.cuda.synchronize()
    again = call()
    torch.cuda.synchronize()
    routes1 = route_fn()
    moved = {k: routes1[k] - routes0[k] for k in routes1}
    check(mod.LAUNCHES == before + 2, f"{tag}: LAUNCHES did not rise by 1 a call")
    check(moved == want_moved, f"{tag}: routes {moved}, want {want_moved}")
    check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
    want = twin()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(1.0, want.float().abs().max().item())
    limit = "bit-equal" if exact else f"limit {TOL}"
    print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (max|d| {err:.6g}; {limit}); "
          f"two calls bit-equal; routes {json.dumps(moved)}", flush=True)
    if exact:
        check(torch.equal(got, want), f"{tag} is not bit-equal to its twin: max|d| {err}")
    check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
    return err


def phase_modes(mod, bwd):
    """Phase 2 for the core's two modes of the Mixer backwards alone: the
    dual mode (gemm_bf16_dual) at DUAL and DUAL_TIMED on the auto route
    (counted as two products on the wgmma core a call), at the first two on
    the WMMA core and at DUAL_WMMA on the auto route (the WMMA route); the
    Group mode (gemm_bf16_group) at GROUP in the token backward's groups on
    the auto route, at the b131 dWt2 on the WMMA core (gemm_sum in the same
    groups) and at GROUP_WMMA on the auto route (the WMMA route). Each
    within TOL of its twin, two calls bit-equal; the Group mode's
    partials of several images and a short last one must occur. Returns
    each row's largest max|Δ|."""
    worst = {"gemm_bf16_dual_sm90": 0.0, "gemm_bf16_group_sm90": 0.0}

    def moved(route, products):
        return {"sm90": (route == "sm90") * 2 * products, "wmma": (route == "wmma") * 2 * products}

    cases = ([(c, "auto", "sm90") for c in DUAL + DUAL_TIMED]
             + [(c, "legacy", "wmma") for c in DUAL[:2]] + [(DUAL_WMMA, "auto", "wmma")])
    for case, core, route in cases:
        nz, M, N, K, lda, a_mn, b_mn, ab, bb = case
        a1, b1, a2, b2 = dual_core_inputs(*case, seed=nz + M + N + K)
        kw = dict(a_mn=a_mn, b_mn=b_mn)
        tag = (f"gemm_bf16_dual {nz} x (M, N, K) {(M, N, K)} A rows of {lda} a_mn={a_mn} "
               f"b_mn={b_mn} a_batched={ab} b_batched={bb} core={core}")
        worst["gemm_bf16_dual_sm90"] = max(worst["gemm_bf16_dual_sm90"], _core_case(
            mod, tag, lambda: torch.stack(mod.gemm_bf16_dual(a1, b1, a2, b2, core=core, **kw)),
            lambda: torch.stack(mod.gemm_bf16_dual_ref(a1, b1, a2, b2, **kw)), mod.routes,
            moved(route, 2)))
        del a1, b1, a2, b2
        torch.cuda.empty_cache()
    groups = []
    cases = ([(c, "auto", "sm90") for c in GROUP] + [(GROUP[4], "legacy", "wmma")]
             + [(GROUP_WMMA, "auto", "wmma")])
    for (images, M, N, K, per), core, route in cases:
        per = per or token_group(bwd, images, M, N, K)
        a, b = group_inputs(images, M, N, K, seed=images + M + N + K)
        n = -(-images // per)
        last = images - (n - 1) * per
        if route == "sm90":
            groups.append((per, n, last))
        tag = (f"gemm_bf16_group {images} images (M, N, K) {(M, N, K)} in {n} partials of {per} "
               f"(last {last}) core={core}")
        worst["gemm_bf16_group_sm90"] = max(worst["gemm_bf16_group_sm90"], _core_case(
            mod, tag, lambda: mod.gemm_bf16_group(a, b, per, core=core),
            lambda: mod.gemm_bf16_group_ref(a, b, per), mod.routes, moved(route, 1)))
        del a, b
    check(any(per > 1 for per, _, _ in groups) and any(last < per for per, _, last in groups),
          f"gemm_bf16_group: no case summed several images in a partial and left a short last "
          f"one: {groups}")
    return worst


def phase_core(mod):
    """Phase 2 for the core's modes alone: gemm_bf16 at CORE_BF16 on the
    auto route (each counted on the wgmma core; the first four also on the
    WMMA core) and at CORE_BF16_WMMA (counted on the WMMA route; core="sm90"
    must raise), each partial within TOL of gemm_bf16_ref's; gemm_bf16 at
    the bf16 gMLP and ResMLP blocks' products (GMLP_BF16, RES_BF16, and
    at b256) and kernel 1's two token products (MIXER_TOKEN_BF16, and at
    b256) on the auto route (those at B = 8 also on WMMA), within TOL;
    gemm_s8 at CORE_S8, MIXER_S8 (the chunked mode among them), RES_S8 and
    at b256 (CORE_S8_TIMED, MIXER_S8_TIMED, RES_S8_TIMED) on the s8 wgmma
    core (the first three of CORE_S8, the two Mixer chunked ones at B = 8
    and the ragged chunk, and RES_S8, also on mma.sync), bit-equal to
    gemm_s8_ref: the integer product is exact and the scales are applied,
    and the chunks added, in the twin's order. Returns each core row's
    largest max|Δ|."""
    worst = dict.fromkeys(("gemm_bwd_sm90", "gemm_bf16_gmlp_sm90", "gemm_s8_sm90",
                           "gemm_s8_mixer_sm90", "gemm_bf16_resmlp_sm90",
                           "gemm_s8_resmlp_sm90", "gemm_bf16_mixer_token_sm90"), 0.0)

    def bf16_routes(route):
        return {"sm90": (route == "sm90") * 2, "wmma": (route == "wmma") * 2}

    cases = ([(c, "auto", "sm90") for c in CORE_BF16] + [(c, "legacy", "wmma") for c in CORE_BF16[:4]]
             + [(CORE_BF16_WMMA, "auto", "wmma")])
    for (M, N, K, a_mn, b_mn, slab), core, route in cases:
        a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=M + N + K)
        kw = dict(a_mn=a_mn, b_mn=b_mn, slab=slab)
        tag = f"gemm_bf16 (M, N, K) {(M, N, K)} a_mn={a_mn} b_mn={b_mn} slab={slab} core={core}"
        worst["gemm_bwd_sm90"] = max(worst["gemm_bwd_sm90"], _core_case(
            mod, tag, lambda: mod.gemm_bf16(a, b, core=core, **kw),
            lambda: mod.gemm_bf16_ref(a, b, **kw), mod.routes, bf16_routes(route)))
        del a, b
    M, N, K, a_mn, b_mn, slab = CORE_BF16_WMMA
    a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=1)
    try:
        mod.gemm_bf16(a, b, a_mn=a_mn, b_mn=b_mn, slab=slab, core="sm90")
        refused = False
    except RuntimeError:
        refused = True
    check(refused, f"gemm_bf16 core=sm90 at {CORE_BF16_WMMA} (rows 72 bytes apart) did not raise")
    print(f"[2] gemm_bf16 core=sm90 at {CORE_BF16_WMMA}: refused (TMA needs 16-byte row strides)",
          flush=True)
    cases = ([(c, "auto", "sm90", "gMLP", "gemm_bf16_gmlp_sm90")
              for c in GMLP_BF16 + GMLP_BF16_TIMED]
             + [(c, "legacy", "wmma", "gMLP", "gemm_bf16_gmlp_sm90") for c in GMLP_BF16[:3]]
             + [(c, "auto", "sm90", "ResMLP", "gemm_bf16_resmlp_sm90")
                for c in RES_BF16 + RES_BF16_TIMED]
             + [(c, "legacy", "wmma", "ResMLP", "gemm_bf16_resmlp_sm90") for c in RES_BF16]
             + [(c, "auto", "sm90", "Mixer", "gemm_bf16_mixer_token_sm90")
                for c in MIXER_TOKEN_BF16 + MIXER_TOKEN_TIMED]
             + [(c, "legacy", "wmma", "Mixer", "gemm_bf16_mixer_token_sm90")
                for c in MIXER_TOKEN_BF16[:2]])
    for (nz, M, N, K, lda, b_mn), core, route, block, row in cases:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=nz + M + N + K)
        tag = (f"gemm_bf16 {nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn} "
               f"(the bf16 {block} block's) core={core}")
        worst[row] = max(worst[row], _core_case(
            mod, tag, lambda: mod.gemm_bf16(a, b, b_mn=b_mn, core=core),
            lambda: mod.gemm_bf16_ref(a, b, b_mn=b_mn), mod.routes, bf16_routes(route)))
        del a, b
    cases = ([(c, "auto", "sm90_s8", "gemm_s8_sm90") for c in CORE_S8 + CORE_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_sm90") for c in CORE_S8[:3]]
             + [(c, "auto", "sm90_s8", "gemm_s8_mixer_sm90") for c in MIXER_S8 + MIXER_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_mixer_sm90") for c in MIXER_S8[3:5]]
             + [(c, "auto", "sm90_s8", "gemm_s8_resmlp_sm90") for c in RES_S8 + RES_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_resmlp_sm90") for c in RES_S8])
    for (nz, M, N, K, ab, bb, chunk), core, route, row in cases:
        a, b, rs, cs = s8_core_inputs(nz, M, N, K, ab, bb, chunk, seed=nz + M + N + K)
        tag = (f"gemm_s8 {nz} x (M, N, K) {(M, N, K)} a_batched={ab} b_batched={bb} "
               f"chunk={chunk} core={core}")
        worst[row] = max(worst[row], _core_case(
            mod, tag, lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk, core=core),
            lambda: mod.gemm_s8_ref(a, b, rs, cs, chunk=chunk), mod.s8_routes,
            {"sm90_s8": (route == "sm90_s8") * 2, "mma_s8": (route == "mma_s8") * 2}, exact=True))
        del a, b, rs, cs
        torch.cuda.empty_cache()
    return worst


def phase_kernels(table):
    """Each kernel vs its twin at its shapes, every output; two calls agree
    bit for bit. The weight-gradient kernels must have summed several images
    into one partial, and a short last partial, at some shape; chan_wgt_bwd's
    twin sums in the kernel's slabs. Returns name → largest max|Δ|."""
    errs = {}
    for name, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        errs[name] = 0.0
        groups = []
        for shape in shapes:
            x, w = inputs(*shape, seed=sum(shape))
            before = launches(mod, fn)
            routes0 = mod.routes() if name in ROUTED else None
            got = outputs(getattr(mod, fn)(x, *w))
            torch.cuda.synchronize()
            check(launches(mod, fn) == before + 1, f"{name}: LAUNCHES did not rise by 1 at {shape}")
            again = outputs(getattr(mod, fn)(x, *w))
            torch.cuda.synchronize()
            note = ""
            if routes0 is not None:  # two calls
                routes1 = mod.routes()
                moved = {k: routes1[k] - routes0[k] for k in routes1}
                want_routes = {k: 2 * v for k, v in ROUTED[name](shape).items()}
                check(moved == want_routes,
                      f"{name}: products on {moved} at {shape}, want {want_routes}")
                note = f"; products of two calls {json.dumps(moved)}"
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: two calls on the same inputs differ at {shape}")
            kw = {}
            if fn in GROUPED:
                groups.append(grouping(mod, fn, x, w))
                note += (f"; weight gradients in {groups[-1][1]} partials of {groups[-1][0]} "
                         f"images (last {groups[-1][2]})")
                # each twin sums in the kernel's slabs or groups, in order
                kw = {"images_per_slab" if fn == "chan_wgt_bwd" else "images_per_group":
                      groups[-1][0]}
            want = outputs(getattr(mod, ref)(x, *w, **kw))
            check(len(got) == len(want), f"{name}: {len(got)} outputs, twin {len(want)}")
            rels = []
            for i, (a, b) in enumerate(zip(got, want)):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{name}: output {i} {tuple(a.shape)} {a.dtype}, twin {tuple(b.shape)} "
                      f"{b.dtype} at {shape}")
                check(bool(torch.isfinite(a).all()), f"{name}: non-finite output {i} at {shape}")
                err = (a.float() - b.float()).abs().max().item()
                rels.append(err / max(1.0, b.float().abs().max().item()))
                errs[name] = max(errs[name], err)
            print(f"[2] {name} vs twin {shape}: max|d|/max(1,max|ref|) per output "
                  f"{' '.join(f'{r:.6g}' for r in rels)} (limit {TOL}); two calls bit-equal"
                  f"{note}", flush=True)
            check(max(rels) <= TOL, f"{name} disagrees with its twin at {shape}: {rels}")
            del x, w, got, again, want
        if fn in GROUPED:
            check(any(per > 1 for per, _, _ in groups) and any(last < per for per, _, last in groups),
                  f"{name}: no shape summed several images in a partial and left a short last "
                  f"one: {groups}")
    return errs


def shift_input(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def phase_shift(mod):
    """The axial shift against its twin at SHIFT_SHAPES, both axes, both
    signs, bf16 and float32: bit-equal (it is a copy), two calls agree, and
    each call launches the kernel once. Then the autograd wrapper: forward
    at sign +1, and its backward on a non-contiguous gradient equals the
    twin at sign -1. Returns the largest max|Δ| (0 when it passes)."""
    worst = 0.0
    for shape, shift in SHIFT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = shift_input(shape, dtype, seed=sum(shape))
            for axis in (1, 2):
                for sign in (1, -1):
                    tag = f"axial_shift {shape} shift {shift} axis {axis} sign {sign} {dtype}"
                    before = mod.LAUNCHES
                    got = mod.shift(x, shift, axis, sign)
                    torch.cuda.synchronize()
                    check(mod.LAUNCHES == before + 1, f"{tag}: LAUNCHES did not rise by 1")
                    again = mod.shift(x, shift, axis, sign)
                    want = mod.axial_shift_ref(x, shift, axis, sign)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and got.dtype == want.dtype,
                          f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
                    check(torch.equal(got, again), f"{tag}: two calls differ")
                    worst = max(worst, (got.float() - want.float()).abs().max().item())
                    check(torch.equal(got, want), f"{tag}: differs from its twin")
        print(f"[2] axial_shift vs twin {shape} shift {shift}: axes H and W, signs +1 and -1, "
              f"bf16 and f32: bit-equal; two calls bit-equal", flush=True)
    x = shift_input((8, 56, 56, 96), torch.bfloat16, seed=3).requires_grad_()
    g = shift_input((8, 56, 56, 96), torch.bfloat16, seed=4).transpose(1, 2)
    for axis in (1, 2):
        y = mod.axial_shift(x, 5, axis)
        (dx,) = torch.autograd.grad(y, x, g)
        check(not g.is_contiguous() and torch.equal(y, mod.axial_shift_ref(x.detach(), 5, axis))
              and torch.equal(dx, mod.axial_shift_ref(g.contiguous(), 5, axis, -1)),
              f"axial_shift autograd wrapper, axis {axis}: forward or backward differs")
    print("[2] axial_shift autograd wrapper (8, 56, 56, 96) bf16, both axes: forward = twin, "
          "backward on a non-contiguous gradient = twin at sign -1, bit-equal", flush=True)
    return worst


def lab_call(mod, fn, x, w, kw, twin=False):
    """A kernel-lab wrapper (or its twin) on x (B, N, D); the token-major
    kernel gets x relaid, and its output relaid back."""
    f = getattr(mod, f"{fn}_ref" if twin else fn)
    if fn == "tokmajor_block":
        return mod.from_tokmajor(f(mod.to_tokmajor(x, kw["bt"]), *w, **kw))
    return f(x, *w, **kw)


def lab_variants(fn):
    """{variant: keyword arguments} of every variant of the lab's table that
    runs the lab kernel ``fn``."""
    from jittor_mlp_tpu_torch.tools import kernel_lab as lab

    return {v: kw for v, (f, kw) in lab.VARIANTS.items() if f == fn}


def phase_lab(mod, names=None):
    """The kernel lab's kernels (or those in ``names``) against their twins
    at LAB_SHAPES, every bt and mode the lab runs: every output within TOL of
    max(1, max|ref|), two calls bit-equal, one launch a call, each call's
    products on each core as LAB_ROUTED says; each kernel's token products
    take both cores at some shape and bt. Returns name → largest max|Δ|."""
    errs = {}
    for fn in LAB_KERNELS:
        if names is not None and fn not in names:
            continue
        errs[fn] = 0.0
        token_cores = set()  # whether the token products' rows suit TMA, per call
        for shape in LAB_SHAPES:
            x, w = block_inputs(*shape, seed=sum(shape))
            for vname, kw in lab_variants(fn).items():
                tag = f"{fn} ({vname}) {shape}"
                before = mod.LAUNCHES[fn]
                routes0 = mod.routes()
                got = lab_call(mod, fn, x, w, kw)
                torch.cuda.synchronize()
                check(mod.LAUNCHES[fn] == before + 1, f"{tag}: LAUNCHES did not rise by 1")
                again = lab_call(mod, fn, x, w, kw)
                torch.cuda.synchronize()
                routes1 = mod.routes()
                moved = {k: routes1[k] - routes0[k] for k in routes1}
                want_routes = {k: 2 * v for k, v in LAB_ROUTED[fn](shape, kw["bt"]).items()}
                check(moved == want_routes,
                      f"{tag}: products of two calls {moved}, want {want_routes}")
                token_cores.add(LAB_WIDTH[fn](shape, kw["bt"]) % 8 == 0)
                check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
                want = lab_call(mod, fn, x, w, kw, twin=True)
                check(got.shape == want.shape == x.shape and got.dtype == want.dtype,
                      f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(1.0, want.float().abs().max().item())
                errs[fn] = max(errs[fn], err)
                print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (limit {TOL}); two "
                      f"calls bit-equal; products of two calls {json.dumps(moved)}", flush=True)
                check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
                del got, again, want
            del x, w
            torch.cuda.empty_cache()
        check(token_cores == {True, False},
              f"{fn}: its token products did not take both cores over LAB_SHAPES")
    return errs


def images(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, 3, 224, 224), np.float32)).to("cuda")


def rel_dev(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def compare_logits(tag, got, ref, lim_rel, lim_top1, phase="3"):
    """max|dlogit|/max|logit| ≤ lim_rel and top-1 agreement ≥ lim_top1
    (None: printed, not held)."""
    rel = rel_dev(got, ref)
    top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[{phase}] {tag}: max|dlogit|/max|logit|={rel:.6g} top1 agreement={top1:.4f} "
          f"(64 images; limits {lim_rel}, {lim_top1})", flush=True)
    check(rel <= lim_rel and (lim_top1 is None or top1 >= lim_top1),
          f"{tag}: rel {rel}, top-1 {top1}")


def forward_counted(model, x, mod, want):
    """model.forward(x) in float32 logits; mod's kernel launched `want` times."""
    before = mod.LAUNCHES
    out = model.forward(x).float()
    torch.cuda.synchronize()
    check(mod.LAUNCHES == before + want,
          f"{mod.LAUNCHES - before} {mod.__name__} launches in one forward, want {want}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    return out


def check_routes(tag, before, after, products, route="sm90"):
    """Between two readings of a library's route counts, ``products`` products
    ran on ``route`` (by default the bf16 wgmma core) and none on any other
    core: at Mixer-B/16's and gMLP-S's shapes every operand is one TMA can
    load (D = 768, CD = 3072 rows are 16-byte multiples; int8 codes are
    padded to 32). Returns the products on ``route``."""
    moved = {k: after[k] - before[k] for k in after}
    want = {k: products if k == route else 0 for k in after}
    print(f"{tag}: products {json.dumps(moved)} (want {json.dumps(want)})", flush=True)
    check(moved == want, f"{tag}: products {moved}, want {want}")
    return moved[route]


def phase_logits(jt, mods):
    """Mixer-B/16, ResMLP-S24 and gMLP-S logits, kernel paths against plain
    paths. Returns the bf16 kernel-path models (on the card)."""
    from jittor_mlp_tpu_torch import config

    mb, mbq = mods["mixer_block"], mods["mixer_block_int8"]
    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False).to_bf16().eval()
    f32 = jt.MLPMixerForImageClassification(**MIXER_B16).eval()
    x = images(64, 0)
    with torch.inference_mode():
        routes0 = mb.routes()
        lk = forward_counted(kernel, x.bfloat16(), mb, DEPTH)
        routes1 = mb.routes()
        q0 = mbq.routes()
        with config.int8_mode():
            lq = forward_counted(kernel, x.bfloat16(), mbq, DEPTH)
        check_routes("[3] Mixer-B/16 bf16 kernel-path forward", routes0, routes1,
                     BLOCK_PRODUCTS["mixer_block"][1] * DEPTH)
        check(mb.routes() == routes1, "the int8 Mixer forward ran kernel 1's products")
        check_routes("[3] Mixer-B/16 int8 kernel-path forward", q0, mbq.routes(),
                     BLOCK_PRODUCTS["mixer_block_int8"][1] * DEPTH, route="sm90_s8")
        lp = plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            lf = f32.forward(x)
    check(lk.shape == (64, 1000), f"kernel-path logits {tuple(lk.shape)}")
    compare_logits("Mixer-B/16 kernel path vs plain bf16", lk, lp, 5e-2, 0.9)
    compare_logits("Mixer-B/16 kernel path vs f32 plain (TF32 off)", lk, lf, 5e-2, 0.9)
    compare_logits("Mixer-B/16 int8 kernel path vs bf16 kernel path", lq, lk, 0.1, 0.9)
    compare_logits("Mixer-B/16 int8 kernel path vs f32 plain (TF32 off)", lq, lf, 0.1, 0.9)
    del plain, f32

    rb, rbq = mods["resmlp_block"], mods["resmlp_block_int8"]
    sd = resmlp_state_dict(jt)
    res = jt.ResMLPForImageClassification(**RESMLP_S24).load_torch_state_dict(sd)
    res_plain = jt.ResMLPForImageClassification(**RESMLP_S24, use_pallas=False)
    res_plain = res_plain.load_torch_state_dict(sd).to_bf16().eval()
    res_f32 = jt.ResMLPForImageClassification(**RESMLP_S24).load_torch_state_dict(sd).eval()
    res = res.to_bf16().eval()
    with torch.inference_mode():
        r0 = rb.routes()
        rk = forward_counted(res, x.bfloat16(), rb, RES_DEPTH)
        check_routes("[3] ResMLP-S24 bf16 kernel-path forward", r0, rb.routes(),
                     BLOCK_PRODUCTS["resmlp_block"][1] * RES_DEPTH)
        rq0 = rbq.routes()
        with config.int8_mode():
            rq = forward_counted(res, x.bfloat16(), rbq, RES_DEPTH)
        check_routes("[3] ResMLP-S24 int8 kernel-path forward", rq0, rbq.routes(),
                     BLOCK_PRODUCTS["resmlp_block_int8"][1] * RES_DEPTH, route="sm90_s8")
        rp = res_plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            rf = res_f32.forward(x)
    compare_logits("ResMLP-S24 kernel path vs plain bf16", rk, rp, 5e-2, 0.9)
    compare_logits("ResMLP-S24 kernel path vs f32 plain (TF32 off)", rk, rf, 5e-2, 0.9)
    compare_logits("ResMLP-S24 int8 kernel path vs f32 plain (TF32 off)", rq, rf, 0.1, 0.9)
    del res_plain, res_f32

    gb, gbq = mods["gmlp_block"], mods["gmlp_block_int8"]
    gmlp = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    g_plain = jt.gMLPForImageClassification(**GMLP_S, use_pallas=False).to_bf16().eval()
    g_f32 = jt.gMLPForImageClassification(**GMLP_S).eval()
    # every channel_proj2 zeroed: each block is then the identity
    g_ident = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    with torch.no_grad():
        for blk in g_ident.model:
            blk.channel_proj2.weight.zero_()
            blk.channel_proj2.bias.zero_()
    with torch.inference_mode():
        g0 = gb.routes()
        gk = forward_counted(gmlp, x.bfloat16(), gb, GMLP_DEPTH)
        check_routes("[3] gMLP-S bf16 kernel-path forward", g0, gb.routes(),
                     BLOCK_PRODUCTS["gmlp_block"][1] * GMLP_DEPTH)
        s8_0 = gbq.routes()
        with config.int8_mode():
            gq = forward_counted(gmlp, x.bfloat16(), gbq, GMLP_DEPTH)
        check_routes("[3] gMLP-S int8 kernel-path forward", s8_0, gbq.routes(),
                     BLOCK_PRODUCTS["gmlp_block_int8"][1] * GMLP_DEPTH, route="sm90_s8")
        gz = forward_counted(g_ident, x.bfloat16(), gb, GMLP_DEPTH)
        gp = g_plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            gf = g_f32.forward(x)
    compare_logits("gMLP-S kernel path vs plain bf16", gk, gp, 5e-2, 0.9)
    compare_logits("gMLP-S kernel path vs f32 plain (TF32 off)", gk, gf, 5e-2, 0.9)
    compare_logits("gMLP-S int8 kernel path vs f32 plain (TF32 off)", gq, gf, 0.1, 0.9)
    moved, dev = rel_dev(gk, gz), rel_dev(gk, gf)
    print(f"[3] gMLP-S blocks move the logits: max|d|/max|logit| vs channel_proj2 zeroed "
          f"{moved:.6g}, kernel path vs f32 {dev:.6g} (need >= 10x)", flush=True)
    check(moved >= 10 * dev, f"gMLP-S blocks hardly move the logits: {moved} vs {dev}")
    del g_plain, g_f32, g_ident
    return kernel, res, gmlp, as_mlp_logits(jt, mods, x)


def as_mlp_logits(jt, mods, x):
    """AS-MLP-T logits on the images x: the bf16 kernel path against the
    plain bf16 path and float32 (TF32 off), int8 against float32, and the
    shift must matter. Returns the bf16 kernel-path model."""
    from jittor_mlp_tpu_torch import config

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T).to_bf16().eval()
    plain = jt.AS_MLP(**AS_MLP_T, use_pallas=False).to_bf16().eval()
    f32 = jt.AS_MLP(**AS_MLP_T, use_pallas=False).eval()  # the reference: no kernel
    ident = jt.AS_MLP(**AS_MLP_T, shift_size=1).to_bf16().eval()  # one group, s = 0
    with torch.inference_mode():
        ak = forward_counted(model, x.bfloat16(), sk, SHIFTS)
        with config.int8_mode():
            aq = forward_counted(model, x.bfloat16(), sk, SHIFTS)
        az = forward_counted(ident, x.bfloat16(), sk, SHIFTS)
        before = sk.LAUNCHES
        ap = plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            af = f32.forward(x)
        check(sk.LAUNCHES == before, "a plain path launched the shift kernel")
    check(ak.shape == (64, 1000), f"AS-MLP-T logits {tuple(ak.shape)}")
    compare_logits("AS-MLP-T kernel path vs plain bf16", ak, ap, 5e-2, 0.9)
    compare_logits("AS-MLP-T kernel path vs f32 plain (TF32 off)", ak, af, 5e-2, 0.9)
    compare_logits("AS-MLP-T int8 kernel path vs f32 plain (TF32 off)", aq, af, 0.1, 0.9)
    moved, dev = rel_dev(ak, az), rel_dev(ak, af)
    print(f"[3] AS-MLP-T shift moves the logits: max|d|/max|logit| vs shift_size 1 (identity "
          f"shift) {moved:.6g}, kernel path vs f32 {dev:.6g} (need >= 10x); {SHIFTS} shift "
          f"launches a forward", flush=True)
    check(moved >= 10 * dev, f"AS-MLP-T: the shift hardly moves the logits: {moved} vs {dev}")
    return model


def resmlp_state_dict(jt):
    """ResMLP-S24's seed-0 weights with γ = 0.1 and perturbed affines
    (α = 1 + 0.1·randn, β = 0.1·randn, from numpy seed 5): at the factory's
    γ = 1e-5 the blocks would hardly move the logits, and a wrong block
    would go unseen."""
    sd = jt.ResMLPForImageClassification(**RESMLP_S24, device="cpu").export_torch_state_dict()
    rng = np.random.default_rng(5)
    for k, v in sd.items():
        if k.endswith(("gamma_1", "gamma_2")):
            sd[k] = torch.full_like(v, 0.1)
        elif k.endswith("alpha"):
            sd[k] = torch.from_numpy(1 + 0.1 * rng.standard_normal(v.shape, np.float32))
        elif k.endswith("beta"):
            sd[k] = torch.from_numpy(0.1 * rng.standard_normal(v.shape, np.float32))
    return sd


def reset_counts(mods):
    for mod in mods.values():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
        else:
            mod.LAUNCHES = 0


def serve(jt, preds, imgs, threads=8, max_delay_ms=5.0):
    """Serve imgs through one MicroBatcher per Predictor, all at the same
    time: each of `threads` clients sends its share of the images to every
    batcher in turn. Checks each answer against predict() of the image
    alone. Returns the batchers' stats."""
    n = len(imgs)
    results = [[None] * n for _ in preds]
    errors = []
    batchers = [jt.MicroBatcher(p, max_delay_ms=max_delay_ms) for p in preds]

    def client(k):
        try:
            for i in range(k, n, threads):
                for j, b in enumerate(batchers):
                    results[j][i] = b.submit(imgs[i])
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
        check(not t.is_alive(), "a MicroBatcher client did not finish")
    stats = [b.stats() for b in batchers]
    for b in batchers:
        b.close()
    check(not errors, f"MicroBatcher request failed: {errors[:1]}")
    for j, p in enumerate(preds):
        check(all(r is not None for r in results[j]), "a request got no answer")
        for i in range(n):
            labels, probs = p.predict(imgs[i:i + 1])
            check(np.array_equal(results[j][i][0], labels[0]),
                  f"{p.dtype} request {i}: batched labels {results[j][i][0]} != alone {labels[0]}")
            check(np.abs(results[j][i][1] - probs[0]).max() <= 1e-3,
                  f"{p.dtype} request {i}: batched probs differ from predict alone")
    return stats


def check_launches(tag, mod, depth, pred):
    forwards = pred.latency_stats()["count"]
    print(f"{tag}: {mod.LAUNCHES} {mod.__name__.rsplit('.', 1)[1]} launches "
          f"({forwards} forwards x {depth} blocks)", flush=True)
    check(mod.LAUNCHES == depth * forwards,
          f"{tag}: {mod.LAUNCHES} launches for {forwards} forwards, want {depth} each")
    return mod.LAUNCHES


def phase_serving(jt, mods, mixer, res, gmlp, as_mlp):
    """(a) the bf16 Mixer serving run; (b), (c), (e), (g) int8 and bf16
    Predictors of one model served at the same time; (d), (f), (h)
    weights="int8". Each path runs with every launch count set to 0 just
    before it and read just after. Returns name → launches on that
    kernel's path."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    launches = {}

    # (a) Mixer-B/16 bf16, as the first slice serves it
    reset_counts(mods)  # the main path's run starts here
    routes0 = mods["mixer_block"].routes()  # a library's count is read, not reset
    pred = jt.Predictor(mixer, batch_size=32).warmup()
    stats = serve(jt, [pred], imgs)
    labels, probs = pred.predict(big)
    check(labels.shape == probs.shape == (2, 5) and np.isfinite(probs).all()
          and (probs >= 0).all() and (probs.sum(-1) <= 1 + 1e-5).all(),
          "resize-path requests gave malformed results")
    print("[4a] Mixer-B/16 bf16: 64 requests via MicroBatcher (8 threads) + 64 predict + "
          "2 resized (256x256); all answered, batched == alone", flush=True)
    print(f"[4a] MicroBatcher.stats: {json.dumps(stats[0])}", flush=True)
    print(f"[4a] Predictor.latency_stats: {json.dumps(pred.latency_stats())}", flush=True)
    launches["fused_mixer_block"] = check_launches("[4a] Mixer bf16", mods["mixer_block"],
                                                   DEPTH, pred)
    # a launch's two channel products and two token products, each pair a row
    moved = check_routes("[4a] Mixer bf16", routes0, mods["mixer_block"].routes(),
                         BLOCK_PRODUCTS["mixer_block"][1] * launches["fused_mixer_block"])
    launches["gemm_tn_sm90"] = launches["gemm_bf16_mixer_token_sm90"] = moved // 2

    # (b), (c): an int8 and a bf16 Predictor on one model, at the same time
    for tag, model, bf_mod, q_mod, depth, bf_name, q_name in (
            ("[4b] Mixer-B/16", mixer, "mixer_block", "mixer_block_int8", DEPTH,
             "fused_mixer_block", "fused_mixer_block_int8"),
            ("[4c] ResMLP-S24", res, "resmlp_block", "resmlp_block_int8", RES_DEPTH,
             "fused_resmlp_block", "fused_resmlp_block_int8"),
            ("[4e] gMLP-S", gmlp, "gmlp_block", "gmlp_block_int8", GMLP_DEPTH,
             "fused_gmlp_block", "fused_gmlp_block_int8")):
        reset_counts(mods)
        routes0 = {lib: mods[lib].routes() for lib in BLOCK_PRODUCTS}
        p8 = jt.Predictor(model, batch_size=32, compute="int8").warmup()
        p16 = jt.Predictor(model, batch_size=32).warmup()
        check(p8.dtype == "int8" and p16.dtype == "bf16", f"{tag}: dtypes {p8.dtype}, {p16.dtype}")
        stats = serve(jt, [p8, p16], imgs)
        print(f"{tag} int8 + bf16 Predictors served at once: 64 requests each via "
              f"MicroBatcher (8 threads) + 64 predict each; batched == alone", flush=True)
        for p, s in zip((p8, p16), stats):
            print(f"{tag} {p.dtype} MicroBatcher.stats: {json.dumps(s)}; latency_stats: "
                  f"{json.dumps(p.latency_stats())}", flush=True)
        launches[q_name] = check_launches(f"{tag} int8", mods[q_mod], depth, p8)
        n16 = check_launches(f"{tag} bf16", mods[bf_mod], depth, p16)
        # every block library's GEMM routes: its products on the wgmma cores
        # where this pair ran its kernel, none elsewhere
        for lib, (route, per) in BLOCK_PRODUCTS.items():
            n = launches[q_name] if lib == q_mod else n16 if lib == bf_mod else 0
            moved = check_routes(f"{tag} {lib}", routes0[lib], mods[lib].routes(), per * n,
                                 route=route)
            if n and lib in PRODUCT_ROWS:
                launches[PRODUCT_ROWS[lib]] = moved
        if bf_name not in launches:
            launches[bf_name] = n16

    # (d), (f) weight-only int8: the dequantized weights serve close to bf16
    sd = resmlp_state_dict(jt)
    for tag, build_model, bf16_model in (
            ("[4d] ResMLP-S24", lambda: jt.ResMLPForImageClassification(
                **RESMLP_S24).load_torch_state_dict(sd), res),
            ("[4f] gMLP-S", lambda: jt.gMLPForImageClassification(**GMLP_S), gmlp)):
        pw = jt.Predictor(build_model(), batch_size=32, weights="int8")
        p16 = jt.Predictor(bf16_model, batch_size=32)
        lw, pw_probs = pw.predict(imgs[:32])
        l16, p16_probs = p16.predict(imgs[:32])
        top1 = float((lw[:, 0] == l16[:, 0]).mean())
        dprob = float(np.abs(pw_probs[:, 0] - p16_probs[:, 0]).max())
        print(f"{tag} weights=int8 vs bf16 Predictor, 32 images: top-1 agreement "
              f"{top1:.4f}, max |d top-1 prob| {dprob:.6g}", flush=True)
        check(pw.dtype == "bf16" and top1 >= 0.9 and dprob <= 5e-2,
              f"{tag} weights=int8 Predictor: top-1 {top1}, prob diff {dprob}")
        del pw
    launches["axial_shift"] = serve_as_mlp(jt, mods, as_mlp, imgs)
    return launches


def serve_as_mlp(jt, mods, model, imgs):
    """(g) AS-MLP-T int8 and bf16 Predictors on one model, served at the
    same time: the shift launches 24 times a forward of either; (h) its
    weights="int8" Predictor agrees with the bf16 one. Returns the shift's
    launches on (g)."""
    sk = mods["axial_shift"]
    reset_counts(mods)  # the AS-MLP serving path's run starts here
    p8 = jt.Predictor(model, batch_size=32, compute="int8").warmup()
    p16 = jt.Predictor(model, batch_size=32).warmup()
    check(p8.dtype == "int8" and p16.dtype == "bf16", f"[4g] dtypes {p8.dtype}, {p16.dtype}")
    stats = serve(jt, [p8, p16], imgs)
    print("[4g] AS-MLP-T int8 + bf16 Predictors served at once: 64 requests each via "
          "MicroBatcher (8 threads) + 64 predict each; batched == alone", flush=True)
    for p, st in zip((p8, p16), stats):
        print(f"[4g] AS-MLP-T {p.dtype} MicroBatcher.stats: {json.dumps(st)}; latency_stats: "
              f"{json.dumps(p.latency_stats())}", flush=True)
    forwards = p8.latency_stats()["count"] + p16.latency_stats()["count"]
    n = sk.LAUNCHES
    print(f"[4g] AS-MLP-T: {n} axial_shift launches ({forwards} forwards x {SHIFTS})", flush=True)
    check(n == SHIFTS * forwards, f"[4g] {n} shift launches for {forwards} forwards")
    pw = jt.Predictor(jt.AS_MLP(**AS_MLP_T), batch_size=32, weights="int8")
    lw, pw_probs = pw.predict(imgs[:32])
    l16, p16_probs = p16.predict(imgs[:32])
    top1 = float((lw[:, 0] == l16[:, 0]).mean())
    dprob = float(np.abs(pw_probs[:, 0] - p16_probs[:, 0]).max())
    print(f"[4h] AS-MLP-T weights=int8 vs bf16 Predictor, 32 images: top-1 agreement "
          f"{top1:.4f}, max |d top-1 prob| {dprob:.6g}", flush=True)
    check(pw.dtype == "bf16" and top1 >= 0.9 and dprob <= 5e-2,
          f"[4h] AS-MLP-T weights=int8 Predictor: top-1 {top1}, prob diff {dprob}")
    return n


def block_bound(name, x, w, outs):
    """(bound_ms, bound_by) of one kernel call from its inputs and outputs:
    each read once or written once at the HBM rate, against the call's
    products at the dense tensor-core peak of its type."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, *w, *outs))
    B, N, D = x.shape if x.dim() == 3 else (x.shape[0] * x.shape[2], x.shape[1], x.shape[3])
    bnd = 2 * B * N * D
    if name.startswith("fused_mixer_block") or name == "fwd_with_h" or name in LAB_KERNELS:
        TD, CD = w[2].shape[0], w[8].shape[0]
        ops = bnd * (2 * TD + 2 * CD)
    elif name == "token_bwd":  # w = (dh, ln1w, ln1b, wt1, bt1, wt2); with the recompute
        ops = bnd * 5 * w[3].shape[0]
    elif name in ("chan_data_bwd", "chan_wgt_bwd"):  # w = (g, ln2w, ln2b, bc1, wc1, wc2)
        ops = bnd * (3 if name == "chan_data_bwd" else 4) * w[4].shape[0]
    elif name.startswith("fused_resmlp_block"):
        F = w[8].shape[0]
        ops = 2 * B * N * (N * D + 2 * D * F)
    elif name.startswith("fused_gmlp_block"):
        F, Nw = w[2].shape[0] // 2, w[6].shape[1]  # W1 (2F, D), Wsp (N, N)
        ops = 2 * B * N * (D * 2 * F + Nw * F + F * D)
    else:
        raise ValueError(f"block_bound: no operation count for kernel {name!r}")
    t_ops = ops / PEAK["int8" if name.endswith("int8") else "bf16"]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _mixer_int8_floor(B, N, D, TD, CD):
    """The W8A8 Mixer block's data flow (csrc/mixer_block_int8.cu's Work):
    each pass reads what it consumes and writes what it makes once; the
    weights once."""
    M, Np, TDp, Dp = B * N, -(-N // 32) * 32, -(-TD // 32) * 32, -(-D // 32) * 32
    ck = CD // 4 if CD % 4 == 0 and CD >= 2048 else CD
    ckp, nch = -(-ck // 32) * 32, CD // ck
    nbytes = (3 * M * D * 2            # x: LN1's statistics, its quantize pass, the residual
              + 2 * 2 * M * 8          # two row_stats passes, written and read
              + 2 * (B * D * Np + B * D * 4)  # qxn, sxn written and read
              + 2 * B * TD * D * 4     # t
              + 2 * (B * D * TDp + B * D * 4)  # qt, st
              + 4 * M * D * 2          # h written, read by its statistics, LN2 and the residual
              + 2 * (M * Dp + M * 4)   # qhn, shn
              + 2 * M * CD * 4         # c
              + 2 * (M * nch * ckp + M * nch * 4)  # qc, sc
              + M * D * 2              # out
              + TD * Np + N * TDp + CD * Dp + D * nch * ckp  # int8 weights
              + 4 * (TD + N + CD + D) + 2 * (4 * D + TD + N + CD + D))  # scales, LN, biases
    return "the data flow's bytes (f32 t and c each way, x three reads, h four passes, codes)", nbytes


def _gmlp_bf16_floor(B, N, D, F):
    """The bf16 gMLP block's data flow (csrc/gmlp_block.cu's Work): each
    pass reads what it consumes and writes what it makes once; the weights
    once."""
    M, Np = B * N, -(-N // 8) * 8
    nbytes = 2 * (2 * M * D            # x: LN1 and the residual
                  + 2 * M * D          # xn written and read
                  + M * 2 * F          # y written
                  + M * F + M * F      # its v half read by LN2, its u half by the gate
                  + 2 * M * F          # vn written and read
                  + 2 * M * F          # g written and read
                  + M * D              # out
                  + 2 * N * Np + N * N  # Wsp copied into rows of Np, then read
                  + 2 * F * D + D * F + 3 * D + 2 * F + 2 * F + N)  # weights, LN, biases
    return "the data flow's bytes (y written, its halves read, vn and g each way, xn, x, out)", \
        nbytes


def _resmlp_bf16_floor(B, N, D, F):
    """The bf16 ResMLP block's data flow (csrc/resmlp_block.cu's Work): each
    pass reads what it consumes and writes what it makes once; the weights
    once."""
    M, Np = B * N, -(-N // 8) * 8
    nbytes = (M * D * 2                # x read by the affine
              + 3 * M * D * 2          # h written, read by the token product and its epilogue
              + 2 * M * D * 4          # h2 (f32) written, read by FF2's residual
              + 2 * M * D * 2          # h2b written, read by FF1
              + 2 * M * F * 2          # c written and read
              + M * D * 2              # out
              + 2 * (2 * N * Np + N * N)  # Wt copied into rows of Np, then read
              + 2 * (2 * F * D + N + F + 7 * D))  # W1, W2, biases, affines, gammas
    return "the data flow's bytes (h three passes, h2 f32 and h2b each way, c each way, x, out)", \
        nbytes


def _resmlp_int8_floor(B, N, D, F):
    """The W8A8 ResMLP block's data flow (csrc/resmlp_block_int8.cu's Work):
    each pass reads what it consumes and writes what it makes once; the
    weights once."""
    M, Np, Dp = B * N, -(-N // 32) * 32, -(-D // 32) * 32
    ck = F // 4 if F % 4 == 0 and F >= 2048 else F
    ckp, nch = -(-ck // 32) * 32, F // ck
    nbytes = (2 * M * D * 2            # x: the token quantize pass and the token epilogue
              + 2 * (B * D * Np + B * D * 4)  # qh, sh written and read
              + 3 * M * D * 4          # h2 (f32) written, read by its quantize pass and FF2's
              + 2 * (M * Dp + M * 4)   # qhb, shb
              + 2 * M * F * 4          # c (f32) written and read
              + 2 * (M * nch * ckp + M * nch * 4)  # qc, sc
              + M * D * 2              # out
              + N * Np + F * Dp + D * nch * ckp  # int8 weights
              + 4 * (N + F + D) + 2 * (N + F + 7 * D))  # scales, biases, affines, gammas
    return "the data flow's bytes (f32 h2 three passes and c each way, x twice, codes, out)", \
        nbytes


def _token_bwd_floors(B, N, D, TD, CD):
    """The token backward's data flow (csrc/mixer_block_bwd.cu), each pass
    reading what it consumes and writing what it makes once, the weights
    once: the parent design's (f32 tp written by the recompute, read and
    rewritten by the dtp product, read by dbt1's row sums) and this one's
    (tp in registers, dbt1's partials of eight columns written and read).
    E: bytes of a (B, N, D) bf16 tensor; F: of a (B, TD, D) one."""
    E, F = 2 * B * N * D, 2 * B * TD * D
    shared = (3 * E                    # x: LN1, the LN backward's rows and columns
              + 3 * E                  # xn written, read by two products
              + 3 * E                  # dh read by two products and the LN backward
              + 2 * F                  # t written and read
              + 3 * F                  # dtp written, read by dWt1 and dxn
              + 6 * E                  # dxn (f32) written and read twice
              + E                      # dx
              + 2 * 2 * TD * N + 4 * (2 * TD * N + TD + 2 * D))  # weights, gradients
    parent = shared + 2 * F * 4        # f32 tp: written, read and rewritten, read
    return [("the parent design's data flow (f32 tp four passes)", parent),
            ("this design's data flow (tp in registers, dbt1 partials)", shared + F // 2)]


def _chan_data_floors(B, N, D, TD, CD):
    """The channel data backward's data flow, as _token_bwd_floors counts
    it: the parent design's (f32 cp written by its recompute product and
    read by the dc product, bf16 dcp written and read) and this one's (cp
    and dc in registers, dcp written and read). E: bytes of a (B, N, D)
    bf16 tensor; G: of a (B·N, CD) one."""
    E, G = 2 * B * N * D, 2 * B * N * CD
    shared = (3 * E                    # h: LN2, the LN backward's rows and columns
              + 2 * E                  # hn written and read
              + 2 * E                  # g read by a product and the LN backward
              + 2 * G                  # dcp written and read
              + 6 * E                  # dhn (f32) written and read twice
              + E                      # dh
              + 2 * 3 * CD * D + 8 * D)  # Wc1, Wc2 and its copy, LN gradients
    return [("the parent design's data flow (f32 cp written and read)", shared + 4 * G),
            ("this design's data flow (cp and dc in registers)", shared)]


# the data flow's bytes of a block kernel at b256, where they bound it
# beyond its operations (rows 6 and 7: before and after their redesign)
FLOORS = {
    "token_bwd": _token_bwd_floors,
    "chan_data_bwd": _chan_data_floors,
    # the f32 intermediates this data flow moves: y (B·N, 2F) written, its v
    # half read twice and its u half once, g (B·N, F) written and read
    "fused_gmlp_block_int8": lambda B, N, D, F: ("the f32 intermediates' bytes",
                                                 7 * B * N * F * 4),
    "fused_mixer_block_int8": _mixer_int8_floor,
    "fused_gmlp_block": _gmlp_bf16_floor,
    "fused_resmlp_block": _resmlp_bf16_floor,
    "fused_resmlp_block_int8": _resmlp_int8_floor,
}


FORWARD_IMG_S = {}  # phase 5: (model, path) → b256 forward img/s, which phase 11 reads


def phase_timing(jt, table, name):
    from jittor_mlp_tpu_torch import config

    timings = {}
    for kname, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        shape = (256, *shapes[0][1:])
        x, w = inputs(*shape, seed=7)
        outs = outputs(getattr(mod, fn)(x, *w))
        ms = cuda_ms(lambda: getattr(mod, fn)(x, *w), 10)
        plain_ms = cuda_ms(lambda: getattr(mod, ref)(x, *w), 5)
        bound_ms, bound_by = block_bound(kname, x, w, outs)
        print(f"[5] {kname} b256 {shape}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})  [{name}]", flush=True)
        floors = FLOORS[kname](*shape) if kname in FLOORS else []
        for what, floor in floors if isinstance(floors, list) else [floors]:
            print(f"[5] {kname} b256: {what} {floor / 1e9:.4f} GB, "
                  f"{floor / HBM_BYTES_S * 1e3:.4f} ms at the HBM rate (the data flow's floor)  "
                  f"[{name}]", flush=True)
        timings[kname] = (ms, plain_ms, bound_ms, bound_by)
        del x, w, outs
        torch.cuda.empty_cache()
    # rows 1 and 5 run one forward body (mixer_forward.cuh): in turns on one input
    mb, bwd = table["fused_mixer_block"][0], table["fwd_with_h"][0]
    x, w = block_inputs(256, *table["fused_mixer_block"][4][0][1:], seed=7)
    ms, runs = _timed_turns({"fused_mixer_block": lambda: mb.fused_mixer_block(x, *w),
                             "fwd_with_h": lambda: bwd.fwd_with_h(x, *w)}, 10)
    print(f"[5] fused_mixer_block and fwd_with_h b256 in turns on one input: "
          f"{ms['fused_mixer_block']:.4f} ms and {ms['fwd_with_h']:.4f} ms (runs "
          f"{json.dumps(runs)})  [{name}]", flush=True)
    del x, w

    xb = torch.randn(256, 3, 224, 224, device="cuda").bfloat16()

    def forwards(tag, variants):
        times = {k: [] for k in variants}
        order = list(variants) + list(variants)[::-1]
        with torch.inference_mode():
            for which in order:
                model, int8 = variants[which]
                with config.int8_mode() if int8 else contextlib.nullcontext():
                    times[which].append(cuda_ms(lambda: model.forward(xb), 5))
        for which, runs in times.items():
            ms = sum(runs) / len(runs)
            FORWARD_IMG_S[(tag, which)] = 256e3 / ms
            print(f"[5] {tag} forward b256, {which}: {ms:.4f} ms, {256e3 / ms:.1f} img/s "
                  f"(runs {runs})  [{name}]", flush=True)

    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False).to_bf16().eval()
    forwards("Mixer-B/16", {"bf16 plain path": (plain, False),
                            "bf16 kernel path": (kernel, False),
                            "int8 kernel path": (kernel, True)})
    del kernel, plain
    torch.cuda.empty_cache()
    res = jt.ResMLPForImageClassification(**RESMLP_S24).to_bf16().eval()
    forwards("ResMLP-S24", {"bf16 kernel path": (res, False),
                            "int8 kernel path": (res, True)})
    del res
    torch.cuda.empty_cache()
    gmlp = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    g_plain = jt.gMLPForImageClassification(**GMLP_S, use_pallas=False).to_bf16().eval()
    forwards("gMLP-S", {"bf16 plain path": (g_plain, False),
                        "bf16 kernel path": (gmlp, False),
                        "int8 kernel path": (gmlp, True)})
    del gmlp, g_plain
    torch.cuda.empty_cache()
    as_mlp = jt.AS_MLP(**AS_MLP_T).to_bf16().eval()
    a_plain = jt.AS_MLP(**AS_MLP_T, use_pallas=False).to_bf16().eval()
    forwards("AS-MLP-T", {"bf16 plain path": (a_plain, False),
                          "bf16 kernel path": (as_mlp, False),
                          "int8 kernel path": (as_mlp, True)})
    return timings


def shift_timing(mod, name):
    """The shift at AS-MLP-T's stage-1 shape at b256 in bf16, each axis,
    kernel and twin, against its bound: a copy moves each element in and
    out once. Returns (ms, twin ms, bound ms, "bytes"), the ms the mean of
    the two axes, as the model launches both equally."""
    x = shift_input((256, 56, 56, 96), torch.bfloat16, seed=7)
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
    ms, plain_ms = [], []
    for axis in (1, 2):
        ms.append(cuda_ms(lambda: mod.shift(x, 5, axis), 20))
        plain_ms.append(cuda_ms(lambda: mod.axial_shift_ref(x, 5, axis), 5))
        print(f"[5] axial_shift b256 {tuple(x.shape)} axis {axis}: kernel {ms[-1]:.4f} ms, twin "
              f"{plain_ms[-1]:.4f} ms, bound {bound_ms:.4f} ms (bytes)  [{name}]", flush=True)
    print("[5] axial_shift: no single PyTorch call computes the zero-fill grouped shift "
          "(torch.roll wraps around): library_ms null", flush=True)
    return sum(ms) / 2, sum(plain_ms) / 2, bound_ms, "bytes"


def gemm_timing(mod, name):
    """Phase 5 for the GEMM core at b256's two channel products (GEMM_TIMED,
    the GELU and the residual epilogue): gemm_tn on the wgmma core and on the
    WMMA core and cuBLAS's bf16 torch.matmul (the product alone, without the
    epilogue: the yardstick, which the port never calls), in turns, then the
    twin; ms, TFLOP/s and share of the dense bf16 peak. Returns (wgmma ms,
    twin ms, bound ms, bound_by, cuBLAS ms), each summed over the two
    products: one block's channel half."""
    total = dict.fromkeys(("sm90", "wmma", "cublas", "twin", "bound"), 0.0)
    total_by = set()
    for (M, N, K), residual in zip(GEMM_TIMED, (False, True)):
        a, b, bias, kw = gemm_inputs(M, N, K, residual, seed=7)
        out = mod.gemm_tn(a, b, bias, **kw)
        flop = 2 * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, bias, out, *kw.values())
                     if torch.is_tensor(t))
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        bound, bound_by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        fns = {"sm90": lambda: mod.gemm_tn(a, b, bias, core="sm90", **kw),
               "wmma": lambda: mod.gemm_tn(a, b, bias, core="legacy", **kw),
               "cublas": lambda: torch.matmul(a, b.t())}
        runs = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(cuda_ms(fns[k], 20))
        epi = "residual" if residual else "gelu_tanh"
        for k, r in runs.items():
            ms = sum(r) / len(r)
            total[k] += ms
            what = "torch.matmul (cuBLAS, no epilogue)" if k == "cublas" else f"{k} core"
            rate = flop / ms / 1e9  # TFLOP/s
            print(f"[5] gemm_tn b256 {(M, N, K)} {epi}, {what}: {ms:.4f} ms, {rate:.1f} TFLOP/s, "
                  f"{100 * rate * 1e12 / PEAK['bf16']:.1f}% of the bf16 peak (runs {r})  [{name}]",
                  flush=True)
        twin = cuda_ms(lambda: mod.gemm_tn_ref(a, b, bias, **kw), 3)
        total["twin"] += twin
        total["bound"] += bound
        print(f"[5] gemm_tn b256 {(M, N, K)} {epi}: twin {twin:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by})  [{name}]", flush=True)
        total_by.add(bound_by)
        del a, b, bias, kw, out
        torch.cuda.empty_cache()
    print(f"[5] gemm_tn b256, one block's two channel products: wgmma core {total['sm90']:.4f} ms, "
          f"WMMA core {total['wmma']:.4f} ms, cuBLAS {total['cublas']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    by = total_by.pop() if len(total_by) == 1 else "operations"  # both are, at these shapes
    return (total["sm90"], total["twin"], total["bound"], by), total["cublas"]


def _timed_turns(fns, iters):
    """{name: mean ms} of each fn, in turns (each name, then in reverse)."""
    runs = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        runs[k].append(cuda_ms(fns[k], iters))
    return {k: sum(r) / len(r) for k, r in runs.items()}, runs


def _s8_timing(mod, name, cases, what):
    """Phase 5 for a block's int8 products at b256 (cases as CORE_S8's) on
    the s8 wgmma core, on mma.sync and as torch._int_mm on the same codes
    (the product alone, no scales and no chunks: the yardstick, which the
    port never calls; a token product, the weight shared and the codes an
    entry an image, as one (entries·N, K) × (K, M) call, the weight's rows
    zero-padded to a multiple of 8, as _int_mm needs), in turns; then each
    twin. Returns ((ms, twin ms, bound ms, bound_by), library ms), each
    summed over the products."""
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for nz, M, N, K, ab, bb, chunk in cases:
        a, b, rs, cs = s8_core_inputs(nz, M, N, K, ab, bb, chunk, seed=7)
        out = mod.gemm_s8(a, b, rs, cs, chunk=chunk)
        ops = 2 * nz * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, rs, cs, out))
        if bb and not ab:  # a token product: (entries·N, K) codes times the weight padded
            aa = b.reshape(nz * N, K)
            bpad = torch.zeros((-(-M // 8) * 8, K), dtype=torch.int8, device="cuda")
            bpad[:M] = a

            def lib():
                return torch._int_mm(aa, bpad.t())
        else:
            def lib():
                return torch._int_mm(a, b.t())
        ms, runs = _timed_turns({"sm90": lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk),
                                 "old": lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk,
                                                            core="legacy"),
                                 "lib": lib}, 20)
        twin = cuda_ms(lambda: mod.gemm_s8_ref(a, b, rs, cs, chunk=chunk), 3)
        t_ops, t_bytes = ops / PEAK["int8"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_s8 b256 {nz} x (M, N, K) {(M, N, K)} chunk={chunk}: s8 wgmma core "
              f"{ms['sm90']:.4f} ms ({ops / ms['sm90'] / 1e9:.1f} TOP/s), mma.sync core "
              f"{ms['old']:.4f} ms ({ops / ms['old'] / 1e9:.1f}), torch._int_mm (no scales) "
              f"{ms['lib']:.4f} ms ({ops / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (operations {t_ops * 1e3:.4f}, bytes "
              f"{t_bytes * 1e3:.4f}) (runs {json.dumps(runs)})  [{name}]", flush=True)
        del a, b, rs, cs, out
        torch.cuda.empty_cache()
    print(f"[5] gemm_s8 b256, {what}: s8 wgmma core {total['sm90']:.4f} ms, mma.sync core "
          f"{total['old']:.4f} ms, torch._int_mm {total['lib']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    return ((total["sm90"], total["twin"], total["bound"],
             "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes"), total["lib"])


def _bf16_timing(mod, name, cases, what):
    """Phase 5 for bf16 products at b256 (cases as (entries, M, N, K, a,
    b, keywords) with their operands) on the wgmma core, the WMMA core and
    torch.matmul on the same operands (the product alone, without the
    epilogue: the yardstick), in turns; then each twin. Returns ((ms, twin
    ms, bound ms, bound_by), library ms), each summed over the products."""
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for tag, a, b, kw in cases:
        out = mod.gemm_bf16(a, b, **kw)
        nz, M, N = out.shape
        K = a.shape[-2] if kw.get("a_mn") else a.shape[-1]
        flop = 2 * (nz if kw.get("slab") is None else 1) * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, out))
        at = a.transpose(-1, -2) if kw.get("a_mn") else a
        bt = b if kw.get("b_mn") else b.transpose(-1, -2)
        ms, runs = _timed_turns({"sm90": lambda: mod.gemm_bf16(a, b, **kw),
                                 "old": lambda: mod.gemm_bf16(a, b, core="legacy", **kw),
                                 "lib": lambda: torch.matmul(at, bt)}, 20)
        twin = cuda_ms(lambda: mod.gemm_bf16_ref(a, b, **kw), 3)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16 b256 {tag}: wgmma core {ms['sm90']:.4f} ms "
              f"({flop / ms['sm90'] / 1e9:.1f} TFLOP/s, "
              f"{100 * flop / ms['sm90'] / 1e9 * 1e12 / PEAK['bf16']:.1f}% of the bf16 peak), "
              f"WMMA core {ms['old']:.4f} ms ({flop / ms['old'] / 1e9:.1f}), torch.matmul "
              f"{ms['lib']:.4f} ms ({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (runs {json.dumps(runs)})  [{name}]",
              flush=True)
        del out, at, bt
        torch.cuda.empty_cache()
    print(f"[5] gemm_bf16 b256, {what}: wgmma core {total['sm90']:.4f} ms, WMMA core "
          f"{total['old']:.4f} ms, torch.matmul {total['lib']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    return ((total["sm90"], total["twin"], total["bound"],
             "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes"), total["lib"])


def mode_timing(mod, bwd, name):
    """Phase 5 for the core's dual and Group modes at b256: DUAL_TIMED (the
    channel data and token backwards' pairs) on the wgmma core, the WMMA
    core (two products, v1 through f32) and torch.matmul twice (the pair
    alone, no epilogue: the yardstick, which the port never calls);
    GROUP_TIMED (dWt2, dWt1 in the token backward's groups) on the wgmma
    core, the WMMA core's gemm_sum and torch.einsum over the images (one
    sum, no partials); in turns, then each twin; then the library's time of
    all the products of rows 6 and 7 (the pairs, the sums, dxn and dhn).
    Returns {row: ((ms, twin ms, bound ms, bound_by), library ms)}, each
    summed over the products."""
    rows, dual_lib = {}, []
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for case in DUAL_TIMED:
        nz, M, N, K, lda, a_mn, b_mn, ab, bb = case
        a1, b1, a2, b2 = dual_core_inputs(*case, seed=7)
        kw = dict(a_mn=a_mn, b_mn=b_mn)
        out = mod.gemm_bf16_dual(a1, b1, a2, b2, **kw)
        flop = 2 * 2 * nz * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a1, b1, a2, b2, *out))
        at1, at2 = (t.transpose(-1, -2) if a_mn else t for t in (a1, a2))
        bt1, bt2 = (t if b_mn else t.transpose(-1, -2) for t in (b1, b2))
        ms, runs = _timed_turns({
            "sm90": lambda: mod.gemm_bf16_dual(a1, b1, a2, b2, **kw),
            "old": lambda: mod.gemm_bf16_dual(a1, b1, a2, b2, core="legacy", **kw),
            "lib": lambda: (torch.matmul(at1, bt1), torch.matmul(at2, bt2))}, 10)
        dual_lib.append(runs["lib"])
        twin = cuda_ms(lambda: mod.gemm_bf16_dual_ref(a1, b1, a2, b2, **kw), 2)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16_dual b256 {nz} x (M, N, K) {(M, N, K)} b_mn={b_mn}: wgmma core "
              f"{ms['sm90']:.4f} ms ({flop / ms['sm90'] / 1e9:.1f} TFLOP/s), WMMA core "
              f"{ms['old']:.4f} ms ({flop / ms['old'] / 1e9:.1f}), torch.matmul x 2 "
              f"{ms['lib']:.4f} ms ({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (operations {t_ops * 1e3:.4f}, bytes "
              f"{t_bytes * 1e3:.4f}) (runs {json.dumps(runs)})  [{name}]", flush=True)
        del a1, b1, a2, b2, out, at1, at2, bt1, bt2
        torch.cuda.empty_cache()
    rows["gemm_bf16_dual_sm90"] = ((total["sm90"], total["twin"], total["bound"],
                                    "operations" if total["ops_ms"] >= total["bytes_ms"]
                                    else "bytes"), total["lib"])
    total = dict.fromkeys(total, 0.0)
    for images, M, N, K, _ in GROUP_TIMED:
        per = token_group(bwd, images, M, N, K)
        a, b = group_inputs(images, M, N, K, seed=7)
        out = mod.gemm_bf16_group(a, b, per)
        flop = 2 * images * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, out))
        ms, runs = _timed_turns({
            "sm90": lambda: mod.gemm_bf16_group(a, b, per),
            "old": lambda: mod.gemm_bf16_group(a, b, per, core="legacy"),
            "lib": lambda: torch.einsum("bmk,bnk->mn", a, b)}, 20)
        twin = cuda_ms(lambda: mod.gemm_bf16_group_ref(a, b, per), 2)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16_group b256 {images} images (M, N, K) {(M, N, K)} in "
              f"{out.shape[0]} partials of {per}: wgmma core {ms['sm90']:.4f} ms "
              f"({flop / ms['sm90'] / 1e9:.1f} TFLOP/s), WMMA core {ms['old']:.4f} ms "
              f"({flop / ms['old'] / 1e9:.1f}), torch.einsum {ms['lib']:.4f} ms "
              f"({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (runs {json.dumps(runs)})  [{name}]",
              flush=True)
        del a, b, out
        torch.cuda.empty_cache()
    group_lib = total["lib"]
    rows["gemm_bf16_group_sm90"] = ((total["sm90"], total["twin"], total["bound"],
                                     "operations" if total["ops_ms"] >= total["bytes_ms"]
                                     else "bytes"), total["lib"])
    # the products of rows 6 and 7 beside these, in the library alone: dxn =
    # Wt1ᵀ·dtp an image and dhn = dcp·Wc1 (torch.matmul, f32 out not asked)
    rn, _ = _draw(9)
    wt1, dtp = rn(384, 196), rn(256, 384, 768)
    dcp, wc1 = rn(256 * 196, 3072), rn(3072, 768)
    other, _ = _timed_turns({"dxn": lambda: torch.matmul(wt1.t(), dtp),
                             "dhn": lambda: torch.matmul(dcp, wc1)}, 20)
    dual = [sum(r) / len(r) for r in dual_lib]
    token = dual[1] + group_lib + other["dxn"]
    chan = dual[0] + other["dhn"]
    print(f"[5] the products of rows 6 and 7 at b256 in the library alone (torch.matmul, "
          f"torch.einsum; no epilogue): token_bwd {token:.4f} ms (the dual pair "
          f"{dual[1]:.4f}, dWt2 + dWt1 {group_lib:.4f}, dxn {other['dxn']:.4f}); chan_data_bwd "
          f"{chan:.4f} ms (the dual pair {dual[0]:.4f}, dhn {other['dhn']:.4f})  [{name}]",
          flush=True)
    del wt1, dtp, dcp, wc1
    torch.cuda.empty_cache()
    return rows


def core_timing(mod, name):
    """Phase 5 for the core's modes at b256, by block: gMLP-S's three int8
    products (CORE_S8_TIMED) and the W8A8 Mixer-B/16 block's four
    (MIXER_S8_TIMED, the second chunked) on the s8 wgmma core, on mma.sync
    and as torch._int_mm; gMLP-S's three bf16 products (GMLP_BF16_TIMED),
    ResMLP-S24's three, Mixer-B/16's two token products (MIXER_TOKEN_TIMED,
    beside their data flow's floor in kernel 1) and its four channel
    backward products (CORE_BF16_TIMED) on the wgmma core, the WMMA core and
    torch.matmul; in turns, then each twin. Returns {row: ((ms, twin ms,
    bound ms, bound_by), library ms)}."""
    rows = {"gemm_s8_sm90": _s8_timing(mod, name, CORE_S8_TIMED, "gMLP-S's three products")}
    # The token product's 196 tokens take two 192-row tiles, the second
    # nearly all zero fill: the same product on the first 192 tokens alone
    # shows what that second tile costs, the most that a layout without it
    # (the transposed product with an N tile over the tokens) could save.
    cut = {}
    for M in (196, 192):
        a, b, rs, cs = s8_core_inputs(256, M, 1536, 224, False, True, None, seed=8)
        cut[M] = cuda_ms(lambda: mod.gemm_s8(a, b, rs, cs), 20)
        del a, b, rs, cs
    print(f"[5] gemm_s8 b256 token product, 256 x (M, 1536, 224): M = 196 tokens (two row "
          f"tiles) {cut[196]:.4f} ms, M = 192 (one) {cut[192]:.4f} ms: the ragged tile costs "
          f"{cut[196] - cut[192]:.4f} ms  [{name}]", flush=True)
    rows["gemm_s8_mixer_sm90"] = _s8_timing(mod, name, MIXER_S8_TIMED,
                                            "the W8A8 Mixer-B/16 block's four products")
    gmlp = []
    for nz, M, N, K, lda, b_mn in GMLP_BF16_TIMED:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=7)
        gmlp.append((f"{nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn}", a, b,
                     {"b_mn": b_mn}))
    rows["gemm_bf16_gmlp_sm90"] = _bf16_timing(mod, name, gmlp,
                                               "gMLP-S's three bf16 products")
    del gmlp
    rows["gemm_s8_resmlp_sm90"] = _s8_timing(mod, name, RES_S8_TIMED,
                                             "ResMLP-S24's three int8 products")
    res = []
    for nz, M, N, K, lda, b_mn in RES_BF16_TIMED:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=7)
        res.append((f"{nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn}", a, b,
                    {"b_mn": b_mn}))
    rows["gemm_bf16_resmlp_sm90"] = _bf16_timing(mod, name, res,
                                                 "ResMLP-S24's three bf16 products")
    del res
    tok = []
    for nz, M, N, K, lda, b_mn in MIXER_TOKEN_TIMED:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=7)
        tok.append((f"{nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn}", a, b,
                    {"b_mn": b_mn}))
    rows["gemm_bf16_mixer_token_sm90"] = _bf16_timing(mod, name, tok,
                                                      "Mixer-B/16's two token products")
    del tok
    B, TD, D, N = MIXER_TOKEN_TIMED[0][:4]  # Wt1·xn_b: (M, N, K) = (TD, D, N)
    flow = 2 * (3 * B * N * D + 2 * B * TD * D)  # xn, x read; h written; t written and read
    ops = 4 * B * N * D * TD
    print(f"[5] gemm_bf16 b256, Mixer-B/16's two token products in kernel 1 (bf16 t, the GELU "
          f"and residual epilogues): operations {ops / 1e9:.2f} GFLOP, "
          f"{ops / PEAK['bf16'] * 1e3:.4f} ms at the bf16 peak; data flow (xn and x read, t "
          f"written and read, h written) {flow / 1e9:.4f} GB, {flow / HBM_BYTES_S * 1e3:.4f} ms "
          f"at the HBM rate  [{name}]", flush=True)
    bwd = []
    for M, N, K, a_mn, b_mn, slab in CORE_BF16_TIMED:
        a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=7)
        bwd.append((f"(M, N, K) {(M, N, K)} a_mn={a_mn} b_mn={b_mn} slab={slab}", a, b,
                    dict(a_mn=a_mn, b_mn=b_mn, slab=slab)))
    rows["gemm_bwd_sm90"] = _bf16_timing(mod, name, bwd,
                                         "Mixer-B/16's four channel backward products")
    return rows


def lab_timing(mod, name):
    """Phase 5 for the kernel lab's kernels at b256, the block's full shape,
    bf16: each kernel and its twin at its first variant (the ablate kernel
    at every mode; its row takes LAB_TIMED), against the bound. Returns
    name → (ms, twin ms, bound ms, bound_by)."""
    timings = {}
    x, w = block_inputs(256, 196, 768, 384, 3072, seed=7)
    for fn in LAB_KERNELS:
        variants = lab_variants(fn)
        for vname, kw in variants.items():
            if fn != "ablate_block" and vname != next(iter(variants)):
                continue
            xin = mod.to_tokmajor(x, kw["bt"]) if fn == "tokmajor_block" else x
            kern, twin = getattr(mod, fn), getattr(mod, f"{fn}_ref")
            out = kern(xin, *w, **kw)
            ms = cuda_ms(lambda: kern(xin, *w, **kw), 10)
            plain_ms = cuda_ms(lambda: twin(xin, *w, **kw), 5)
            bound_ms, bound_by = block_bound(fn, xin, w, (out,))
            print(f"[5] {fn} ({vname}) b256 {tuple(xin.shape)}: kernel {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{name}]", flush=True)
            if fn != "ablate_block" or vname == LAB_TIMED:
                timings[fn] = (ms, plain_ms, bound_ms, bound_by)
            del out, xin
            torch.cuda.empty_cache()
    return timings


def phase_lab_stack(mods, name):
    """Phase 7: the port's kernel lab through its own functions, its check
    at b8 against kernel 1, then every variant of its table over the
    12-block stack at b256. Every count is set to 0 just before the stack
    runs and read just after: each lab kernel launches 12 times a pass of
    each of its variants, warm-up included. Returns the lab kernels'
    launches."""
    from jittor_mlp_tpu_torch.tools import kernel_lab as lab

    kl, mb = mods["kernel_lab"], mods["mixer_block"]
    weights = lab.make_weights(0, "cuda")
    print("[7] kernel lab check at b8 against kernel 1:", flush=True)
    lab.check(weights, lab.make_input(1, 8, "cuda"))
    names = list(lab.variants())
    print(f"[7] kernel lab stack: {len(names)} variants, b256, {lab.DEPTH} blocks, 1 warm-up + "
          f"{LAB_ITERS} timed passes each  [{name}]", flush=True)
    reset_counts(mods)  # the lab's run starts here
    routes0 = {"lab": kl.routes(), "kernel 1": mb.routes()}
    stats = lab.bench(names, weights, 256, LAB_ITERS, name)
    torch.cuda.synchronize()
    counts = dict(kl.LAUNCHES)
    counts["fused_mixer_block"] = mb.LAUNCHES
    want = dict.fromkeys(counts, 0)
    for v, st in stats.items():  # plain launches no kernel; a SAME_AS variant none of its own
        fn = lab.VARIANTS[v][0]
        if fn is not None and "same_as" not in st:
            want[fn] += lab.DEPTH * st["passes"]
    print(f"[7] launches in the lab's run: {json.dumps(counts)} (want {json.dumps(want)})",
          flush=True)
    check(counts == want, f"kernel lab launches {counts}, want {want}")
    check_routes("[7] the lab's kernels", routes0["lab"], kl.routes(),
                 4 * sum(counts[fn] for fn in LAB_KERNELS))
    check_routes("[7] kernel 1 in the lab", routes0["kernel 1"], mb.routes(),
                 BLOCK_PRODUCTS["mixer_block"][1] * counts["fused_mixer_block"])
    ref = stats["prod2"]["img_s"]
    print("[7] variant, img/s, stack TFLOP/s, ratio to prod2:", flush=True)
    for v, st in stats.items():
        same = f" (= {st['same_as']})" if "same_as" in st else ""
        print(f"[7]   {v:12s} {st['img_s']:10.1f} {st['tflops']:8.2f} {st['img_s'] / ref:7.4f}"
              f"{same}  [{name}]", flush=True)
    return {fn: counts[fn] for fn in LAB_KERNELS}


def mean_gate(tokens):
    """A state-dict edit for the split-attention families: each
    ``split_attention.mlp1`` weight divided by the tokens its gate sums
    over (``tokens(key)``), so that the gate reads their mean. At the
    seed's draw the gate's logits grow with the sum over 256 or 1,024
    tokens and its softmax over the three branches is one-hot: bf16 or
    int8 rounding flips it (S2-MLPv2: bf16 0.33 of max|logit| from f32,
    70% top-1, on an H100), and a wrong branch with no weight would go
    unseen."""
    def edit(sd):
        for k in sd:
            if k.endswith("split_attention.mlp1.weight"):
                sd[k] = sd[k] / tokens(k)
    return edit


def layer_scale(value):
    """A state-dict edit for MS-MLP and GFNet-H-B: every block's ``gamma``
    layer scale set to ``value``. The factories' 1e-6 makes each block add
    next to nothing, so neither the bf16 band nor the blocks-move check
    would see a wrong block."""
    def edit(sd):
        for k in sd:
            if k.endswith(".gamma"):
                sd[k] = torch.full_like(sd[k], value)
    return edit


# Phase 8: the families ported without a kernel of their own, at the full
# widths of compare.py's CONFIGS: (title, factory (a name in the package,
# dotted where it is reached through models, as compare.py reaches
# ActivexTiny), arguments, the modules whose weights zeroed make every block
# the identity: each residual branch's last layer, an edit of the seed-0
# state dict or None)
FAMILIES = {
    "vip": ("ViP (patch 14, d_model 256, depth 30, segments 16)", "ViP",
            dict(image_size=224, patch_size=14, d_model=256, depth=30, segments=16,
                 weighted=True),
            lambda m: [layer for blk in m.blocks.model for layer in (blk[0].fn[1], blk[1].fn[3])],
            mean_gate(lambda k: 16 * 16)),
    "s2_mlp_v1": ("S2-MLP-wide (patch 16, d_model 768, depth 12)", "S2MLPv1_wide", {},
                  lambda m: [blk[k].fn[3] for st in m.stages for blk in st[1].model
                             for k in (0, 1)], None),
    "s2_mlp_v2": ("S2-MLPv2 (patches [7, 2], d_model [192, 384], depths [4, 14])", "S2MLPv2",
                  dict(image_size=224, patch_size=[7, 2], d_model=[192, 384], depth=[4, 14],
                       expansion_factor=[3, 3]),
                  lambda m: [layer for st in m.stages for blk in st[1].model
                             for layer in (blk[0].fn.mlp2, blk[1].fn[3])],
                  mean_gate(lambda k: 32 * 32 if k.startswith("stages.0.") else 16 * 16)),
    "raft_mlp": ("RaftMLP (dims 64 and 128, patches 4 and 2, raft 2, depths 2)", "RaftMLP",
                 dict(layers=[{"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
                              {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2}]),
                 lambda m: [blk[k].fn[3] for level in m.levels for blk in level.fn[2:]
                            for k in (1, 3, 5)], None),
    "swin_mlp": ("Swin-MLP-T (embed 96, depths [2, 2, 6, 2], window 7)", "SwinMLP",
                 dict(drop_path_rate=0.0),
                 lambda m: [layer for st in m.layers for blk in st.blocks
                            for layer in (blk.spatial_mlp, blk.mlp.fc2)], None),
    "dyna_mlp": ("DynaMixer-T", "DynaMixer", dict(model_name="T"),
                 lambda m: [layer for st in m.stages for blk in st[1].layers
                            for layer in (blk[0].fn.proj_o, blk[1].fn.net[3])], None),
    "ms_mlp": ("MS-MLP-T (embed 96, depths [2, 2, 6, 2], shift 5)", "MS_MLP",
               dict(drop_path_rate=0.0),
               lambda m: [blk.pwconv2 for layer in m.layers for blk in layer.blocks],
               layer_scale(0.5)),
    "hire_mlp": ("Hire-MLP-Tiny (d_model [64, 128, 320, 512], depths [4, 6, 24, 3])",
                 "HireMLP", {},
                 lambda m: [layer for st in m.layers for blk in st.model
                            for layer in (blk[0].fn[0].proj_c, blk[0].fn[0].proj_h.net[2],
                                          blk[0].fn[0].proj_w.net[2], blk[1].fn[3])], None),
    "cycle_mlp": ("CycleMLP-B2 (layers [2, 3, 10, 3], dims [64, 128, 320, 512])",
                  "CycleMLP_B2", {},
                  lambda m: [layer for slot in m.network if isinstance(slot, torch.nn.ModuleList)
                             for blk in slot for layer in (blk.attn.proj, blk.mlp.fc2)], None),
    "active_mlp": ("ActiveMLP-xT (depths [2, 2, 4, 2], share [2, 4, 4, 8], intv 2)",
                   "models.active_mlp.ActivexTiny", {},
                   lambda m: [layer for st in m.blocks for blk in st
                              for layer in (blk.atm.proj, blk.mlp.fc2)], None),
    # ConvMixer's blocks have no outer residual: zeroed pointwise convs make
    # each block's output a constant map
    "conv_mixer": ("ConvMixer-768/32 (kernel 7, patch 7)", "ConvMixer",
                   dict(dim=768, depth=32, kernel_size=7, patch_size=7),
                   lambda m: [blk[1] for blk in m.blocks], None),
    "sparse_mlp": ("SparseMLP (d_model 96, depths [2, 10, 24, 2])", "SparseMLP", {},
                   lambda m: [layer for st in m.layers for blk in st.model
                              for layer in (blk[0].fn[0], blk[1].fn[0].fuse, blk[3].fn[3])], None),
    "repmlpnet": ("RepMLPNet-B224 (channels 96-768, blocks [2, 2, 12, 2])",
                  "create_RepMLPNet_B224", {},
                  lambda m: [layer for st in m.stages for u in st
                             for layer in (u.repmlp_block.fc3, u.repmlp_block.fc3_bn,
                                           u.repmlp_block.repconv1.bn, u.repmlp_block.repconv3.bn,
                                           u.ffn_block.ffn_fc2.bn)], None),
    "wave_mlp": ("WaveMLP-T (layers [2, 2, 4, 2])", "WaveMLP", dict(model_name="T"),
                 lambda m: [layer for slot in m.network if isinstance(slot, torch.nn.ModuleList)
                            for blk in slot for layer in (blk.attn.proj, blk.mlp.fc2)], None),
    "morph_mlp": ("MorphMLP-T (layers [3, 4, 7, 3], dims [84, 168, 336, 588])", "MorphMLP",
                  dict(model_name="T"),
                  lambda m: [layer for slot in m.network if isinstance(slot, torch.nn.ModuleList)
                             for blk in slot for layer in (blk.attn.fc_h, blk.attn.fc_w,
                                                           blk.attn.fc_c, blk.mlp.fc2)], None),
    "conv_mlp": ("ConvMLP-M (depths [3, 6, 3], d_model [128, 256, 512])", "convmlp_m", {},
                 lambda m: [blk[7] for blk in m.conv_stages.conv_blocks]
                 + [layer for st in m.stages for blk in st.blocks
                    for layer in (blk.channel_mlp1.fc2, blk.channel_mlp2.fc2)], None),
    # one residual wraps each block's filter and MLP: fc2 zeroed is the identity
    "gfnet": ("GFNet (embed 768, depth 12, patch 16)", "GFNet", {},
              lambda m: [blk.mlp.fc2 for blk in m.blocks], None),
    "gfnet_pyramid": ("GFNet-H-B (embed [96, 192, 384, 768], depths [3, 3, 27, 3])",
                      "GFNetPyramid", dict(embed_dim=[96, 192, 384, 768], depth=[3, 3, 27, 3],
                                           init_values=1e-6),
                      lambda m: [blk.mlp.fc2 for st in m.blocks for blk in st],
                      layer_scale(0.5)),
    "sequencer": ("Sequencer2D-S (depths [4, 3, 8, 3], dims [192, 384, 384, 384])",
                  "Sequencer2D", dict(model_name="S"),
                  lambda m: [layer for st in m.stages for blk in st[1].model
                             for layer in (blk[0].fn[0].fc, blk[1].fn[3])], None),
}
# the families with BatchNorm: recalibrated on the card before their bands
BN_FAMILIES = ("conv_mixer", "sparse_mlp", "repmlpnet", "wave_mlp", "morph_mlp", "conv_mlp")
# Recalibrated, the random draws of these two amplify rounding through their
# depth: on the CPU (port and JAX package alike, the same state dict, 16
# images) bf16 read 0.177 (JAX 0.235) of max|logit| for ConvMixer-768/32 and
# 0.0610 (JAX 0.0602) for RepMLPNet-B224; a 1e-3 input perturbation moves
# ConvMixer's f32 logits by 0.017 at width 256. Left free-running, their
# bands would measure the draw, not the port: each block's bf16 and int8
# outputs are held against the f32 block on the same input instead (and
# the logits that follow), the free-running numbers printed
TEACHER_FORCED = ("conv_mixer", "repmlpnet")
RECAL_BATCHES = 4  # seeded batches of 32 images for recalibrate_bn
# f32 logits on the card (TF32 off) against the CPU on the same weights:
# two libraries' summation orders through up to 30 blocks
CARD_VS_CPU = 1e-3  # of max|logit|
FAMILY_ITERS = 5  # timed b256 forwards, after two warm-up ones


def batched_equals_alone(tag, p, imgs):
    """p.predict on 16 images at once against each image alone: the same
    labels, top-k probabilities within 1e-3."""
    labels, probs = p.predict(imgs)
    for i in range(len(imgs)):
        li, pi = p.predict(imgs[i:i + 1])
        check(np.array_equal(li[0], labels[i]), f"{tag} image {i}: batched labels differ")
        check(np.abs(pi[0] - probs[i]).max() <= 1e-3, f"{tag} image {i}: batched probs differ")
    return labels


def family_phase(jt, key, name, x64, imgs):
    """One family at full width: f32 on the card against the CPU at b2; bf16
    and int8 against card f32 on 64 images; the blocks move the logits;
    Predictor (bf16 and weights="int8") batched == alone; b256 img/s and
    peak memory in bf16 and int8. Returns {"bf16": img/s, "int8": img/s}."""
    from jittor_mlp_tpu_torch import config

    title, factory_name, kw, branch_ends, edit = FAMILIES[key]
    factory = jt
    for part in factory_name.split("."):
        factory = getattr(factory, part)
    tag = f"[8] {title}"
    if key in BN_FAMILIES:
        from jittor_mlp_tpu_torch.core.train_utils import recalibrate_bn

        t0 = time.perf_counter()
        sd = recalibrate_bn(factory(**kw), (images(32, 40 + i) for i in range(RECAL_BATCHES))
                            ).export_torch_state_dict()
        print(f"{tag}: running statistics recalibrated on the card in f32 "
              f"({RECAL_BATCHES} x 32 images): {time.perf_counter() - t0:.2f} s", flush=True)
        bn_int8_zeros(tag, key, sd)
    else:
        sd = factory(**kw, device="cpu").export_torch_state_dict()  # seed 0
    if edit is not None:
        edit(sd)

    def build(**where):
        return factory(**kw, **where).load_torch_state_dict(sd)

    f32 = build().eval()  # the factory builds on the card
    check(f32.device.type == "cuda" and f32.name == key, f"{tag}: {f32.device}, {f32.name}")
    cpu = build(device="cpu").eval()
    with torch.inference_mode(), config.parity_mode():
        lc = f32.forward(x64[:2])
        lcpu = cpu.forward(x64[:2].cpu())
    dev = rel_dev(lc.cpu(), lcpu)
    print(f"{tag}: {f32.param_count():,} parameters; f32 card (TF32 off) vs CPU at b2: "
          f"max|dlogit|/max|logit|={dev:.6g} (limit {CARD_VS_CPU})", flush=True)
    check(lc.shape == (2, 1000) and dev <= CARD_VS_CPU, f"{tag}: card vs CPU {dev}")
    del cpu
    if key == "repmlpnet":
        fold_check(tag, f32, build, x64)
    model = build().to_bf16().eval()
    with torch.inference_mode():
        with config.parity_mode():
            lf = f32.forward(x64).float()
        lb = model.forward(x64.bfloat16()).float()
        with config.int8_mode():
            lq = model.forward(x64.bfloat16()).float()
    check(bool(torch.isfinite(lb).all() and torch.isfinite(lq).all()), f"{tag}: non-finite")
    how = ""
    if key in TEACHER_FORCED:
        print(f"{tag}: free-running (not held; the recalibrated random map amplifies "
              f"rounding): bf16 max|dlogit|/max|logit|={rel_dev(lb, lf):.6g} top1 agreement="
              f"{(lb.argmax(-1) == lf.argmax(-1)).float().mean().item():.4f}, int8 "
              f"{rel_dev(lq, lf):.6g}", flush=True)
        lb, worst_b = teacher_forced(f32, model, x64, contextlib.nullcontext)
        lq, worst_q = teacher_forced(f32, model, x64, config.int8_mode)
        print(f"{tag}: each block on the f32 model's input to it: worst block "
              f"max|d|/max|out| bf16 {worst_b:.6g}, int8 {worst_q:.6g} (limits 0.05, 0.1)",
              flush=True)
        check(worst_b <= 5e-2 and worst_q <= 0.1, f"{tag}: block bands {worst_b}, {worst_q}")
        how = ", blocks on the f32 inputs"
    compare_logits(f"{title} bf16 vs f32 (TF32 off{how})", lb, lf, 5e-2, 0.9, phase="8")
    # int8: the 0.1 band only. Random-init logits over 1,000 classes have near
    # ties: RaftMLP's int8 top-1 agreement read 0.8906 at 0.027 of max|logit|
    # on an H100, its classifier's 100,352-wide rows quantized per row
    compare_logits(f"{title} int8 vs f32 (TF32 off{how})", lq, lf, 0.1, None, phase="8")
    del f32

    # bf16 asked for: the committed tuned.SERVE serves ConvMixer and S2-MLPv2 in f32
    p16 = jt.Predictor(model, batch_size=32, bf16=True)
    l16 = batched_equals_alone(f"{tag} bf16 Predictor", p16, imgs)
    pw = jt.Predictor(build(), batch_size=32, weights="int8", bf16=True)
    lw = batched_equals_alone(f"{tag} weights=int8 Predictor", pw, imgs)
    check(p16.dtype == pw.dtype == "bf16", f"{tag}: Predictor dtypes {p16.dtype}, {pw.dtype}")
    print(f"{tag}: bf16 and weights=int8 Predictors, 16 images batched == alone; top-1 "
          f"agreement of the two {float((lw[:, 0] == l16[:, 0]).mean()):.4f}", flush=True)
    del pw

    x = images(256, 3).bfloat16()
    rates = {}
    for mode in ("bf16", "int8"):
        ctx = config.int8_mode if mode == "int8" else contextlib.nullcontext
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def fwd():
            with torch.inference_mode(), ctx():
                model.forward(x)

        ms = cuda_ms(fwd, FAMILY_ITERS)
        rates[mode] = 256e3 / ms
        print(f"{tag} {mode} b256 forward: {ms:.4f} ms, {rates[mode]:.1f} img/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{name}]", flush=True)

    with torch.no_grad():  # every residual branch's last layer zeroed: identity blocks
        for layer in branch_ends(model):
            layer.weight.zero_()
            if layer.bias is not None:
                layer.bias.zero_()
    with torch.inference_mode():
        lz = model.forward(x64.bfloat16()).float()
    moved, bdev = rel_dev(lb, lz), rel_dev(lb, lf)
    print(f"{tag}: blocks move the logits: max|d|/max|logit| vs identity blocks {moved:.6g}, "
          f"bf16 vs f32 {bdev:.6g} (need >= 10x)", flush=True)
    check(moved >= 10 * bdev, f"{tag}: the blocks hardly move the logits: {moved} vs {bdev}")
    return rates


def teacher_forced(f32, model, x, mode):
    """(logits, worst block deviation) of ``model`` (bf16, under the context
    ``mode``) on x with every block run on the f32 model's input to that
    block, cast to bf16: max|d|/max|out| of each block's output against
    the f32 block's. The models' block loops go through nnf.run_blocks,
    which this swaps for the run."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.core import nnf

    real, seen, devs = nnf.run_blocks, [], []

    def record(blocks, h, fn, remat=False):
        for blk in blocks:
            y = fn(blk, h)
            seen.append((h, y))
            h = y
        return h

    def forced(blocks, h, fn, remat=False):
        for blk in blocks:
            h_in, want = seen[len(devs)]
            h = fn(blk, h_in.to(h.dtype))
            devs.append(rel_dev(h.float(), want))
        return h

    try:
        nnf.run_blocks = record
        with torch.inference_mode(), config.parity_mode():
            f32.forward(x)
        nnf.run_blocks = forced
        with torch.inference_mode(), mode():
            logits = model.forward(x.bfloat16()).float()
    finally:
        nnf.run_blocks = real
    check(len(devs) == len(seen) > 0, f"teacher forcing ran {len(devs)} of {len(seen)} blocks")
    return logits, max(devs)


def bn_int8_zeros(tag, key, sd):
    """Print how many running variances weights="int8" rounds to 0: the
    port quantizes a stacked BatchNorm leaf as JAX's quantize_tree does,
    one scale per layer, so a variance below its layer's absmax/254 reads
    0 and its channel is divided by sqrt(eps) alone."""
    from jittor_mlp_tpu_torch.quant import quantize_state_dict

    q = quantize_state_dict(key, sd)
    var = [k for k in q if k.endswith("running_var")]
    quantized = [k for k in var if isinstance(q[k], dict)]
    zeros = sum(int((q[k]["q"] == 0).sum()) for k in quantized)
    print(f"{tag}: weights=int8 quantizes {len(quantized)} of {len(var)} running_var "
          f"tensors; {zeros} of their "
          f"{sum(q[k]['q'].numel() for k in quantized)} variances round to 0", flush=True)


def fold_check(tag, f32, build, x64):
    """RepMLPNet-B224: locality_injection() in place on a copy on the card,
    f32 logits within 1e-3 of max|logit| of the unfolded model."""
    from jittor_mlp_tpu_torch import config

    folded = build().eval()
    t0 = time.perf_counter()
    folded.locality_injection()
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    with torch.inference_mode(), config.parity_mode():
        lu = f32.forward(x64[:8])
        lf = folded.forward(x64[:8])
    dev = rel_dev(lf, lu)
    print(f"{tag}: locality_injection() in {fold_s:.2f} s (stage 0's fc3 "
          f"{tuple(folded.stages[0][0].repmlp_block.fc3.weight.shape)}); folded vs unfolded "
          f"f32 at b8: max|dlogit|/max|logit|={dev:.6g} (limit {CARD_VS_CPU})", flush=True)
    check(folded.deploy and dev <= CARD_VS_CPU, f"{tag}: folded vs unfolded {dev}")


def special_ops(name):
    """Sequencer's BiLSTM and GFNet's filter on the card, each against its
    plain version: ``bilstm`` (cuDNN) against ``bilstm_plain`` (the step
    loop) at Sequencer2D-S's stage-1 shape, in float32 and in bf16 (the
    serving dtype; cuDNN's RNN must run it, with the weights compacted:
    no warning); ``global_filter`` (cuFFT, float32) against a float64 CPU
    ``torch.fft`` at 56 × 56 × 96. Returns {check: max|d|/max|ref|}."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.models.gfnet import global_filter
    from jittor_mlp_tpu_torch.ops.lstm import LSTM, bilstm, bilstm_plain

    devs = {}
    torch.manual_seed(0)
    lstm = LSTM(192, 48).cuda()
    x = torch.randn(8192, 32, 192, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    with torch.inference_mode(), config.parity_mode():
        got = bilstm(lstm, x)
        ref = bilstm_plain(dict(lstm.state_dict()), x)
        cudnn_ms, plain_ms = cuda_ms(lambda: bilstm(lstm, x), 5), cuda_ms(
            lambda: bilstm_plain(dict(lstm.state_dict()), x), 3)
    devs["bilstm_f32"] = rel_dev(got, ref)
    print(f"[8] bilstm (8192 x 32 steps, C 192, H 48) f32 cuDNN vs the step loop (TF32 off): "
          f"max|d|/max|ref|={devs['bilstm_f32']:.6g} (limit 1e-4); cuDNN {cudnn_ms:.4f} ms, "
          f"step loop {plain_ms:.4f} ms  [{name}]", flush=True)
    check(got.shape == (8192, 32, 96) and devs["bilstm_f32"] <= 1e-4,
          f"bilstm f32: {devs['bilstm_f32']}")
    lstm_b = copy.deepcopy(lstm).bfloat16()
    xb = x.bfloat16()
    with torch.inference_mode(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            got = bilstm(lstm_b, xb)
            torch.cuda.synchronize()
        bf16_ms = cuda_ms(lambda: bilstm(lstm_b, xb), 5)
    rnn = sorted({e.key for e in prof.key_averages() if "RNN" in e.key})
    compacted = [str(w.message)[:80] for w in caught if "contiguous chunk" in str(w.message)]
    with torch.inference_mode(), config.parity_mode():
        params = {k: v.float() for k, v in lstm_b.state_dict().items()}
        ref = bilstm_plain(params, xb.float())
        loop_b = bilstm_plain(dict(lstm_b.state_dict()), xb).float()
    devs["bilstm_bf16"] = rel_dev(got.float(), ref)
    print(f"[8] bilstm bf16 cuDNN vs the f32 step loop on the same bf16 values: "
          f"max|d|/max|ref|={devs['bilstm_bf16']:.6g} (limit 5e-2; the bf16 step loop, h and "
          f"c in bf16: {rel_dev(loop_b, ref):.6g}); {bf16_ms:.4f} ms; cuDNN RNN kernels "
          f"{[k[:60] for k in rnn]}; weight-compaction warnings {compacted}  [{name}]",
          flush=True)
    check(got.dtype == torch.bfloat16 and devs["bilstm_bf16"] <= 5e-2,
          f"bilstm bf16: {got.dtype}, {devs['bilstm_bf16']}")
    check(bool(rnn), "the bf16 LSTM ran no cuDNN RNN kernel")
    check(not compacted, f"cuDNN compacted the bf16 LSTM weights at the call: {compacted}")
    del lstm, lstm_b, x, xb, got, ref, loop_b

    g = np.random.default_rng(2)
    x = torch.from_numpy(g.standard_normal((8, 56 * 56, 96), np.float32))
    w = torch.from_numpy(g.standard_normal((56, 29, 96, 2), np.float32))
    want = torch.fft.irfft2(
        torch.fft.rfft2(x.double().reshape(8, 56, 56, 96), dim=(1, 2), norm="ortho")
        * torch.view_as_complex(w.double()), s=(56, 56), dim=(1, 2), norm="ortho"
    ).reshape(8, 56 * 56, 96)
    xc, wc = x.cuda(), w.cuda()
    with torch.inference_mode():
        got = global_filter(xc, wc, 56, 56)
        x256 = xc.repeat(32, 1, 1)
        fft_ms = cuda_ms(lambda: global_filter(x256, wc, 56, 56), 5)
        fft_bf16_ms = cuda_ms(lambda: global_filter(x256.bfloat16(), wc.bfloat16(), 56, 56), 5)
    devs["global_filter"] = rel_dev(got.double().cpu(), want)
    print(f"[8] global_filter f32 (cuFFT) vs float64 CPU torch.fft at 8 x 56 x 56 x 96: "
          f"max|d|/max|ref|={devs['global_filter']:.6g} (limit 1e-5); at b256: "
          f"{fft_ms:.4f} ms f32, {fft_bf16_ms:.4f} ms from bf16 (cast up and back)  [{name}]",
          flush=True)
    check(devs["global_filter"] <= 1e-5, f"global_filter: {devs['global_filter']}")
    return devs


def phase_families(jt, mods, name):
    """Phase 8: ViP, S2-MLP v1 and v2, RaftMLP, Swin-MLP-T, DynaMixer-T,
    MS-MLP-T, Hire-MLP-Tiny, CycleMLP-B2, ActiveMLP-xT, the BatchNorm
    families ConvMixer-768/32, SparseMLP, RepMLPNet-B224, WaveMLP-T,
    MorphMLP-T and ConvMLP-M, and GFNet, GFNet-H-B and Sequencer2D-S at
    full width, on the serving path a user calls (factory, bf16 or int8
    forward, Predictor), after ``special_ops``. They run no kernel of the
    port: every count is set to 0 just before and must read 0 after."""
    x64 = images(64, 0)
    imgs = np.random.default_rng(8).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    reset_counts(mods)  # the families' run starts here
    special_ops(name)
    rates = {}
    for key in FAMILIES:
        rates[key] = family_phase(jt, key, name, x64, imgs)
        torch.cuda.empty_cache()
    launched = {m: (sum(mod.LAUNCHES.values()) if isinstance(mod.LAUNCHES, dict)
                    else mod.LAUNCHES) for m, mod in mods.items()}
    print(f"[8] port kernel launches in the families' run: {json.dumps(launched)} (want 0)",
          flush=True)
    check(not any(launched.values()), f"the families' run launched port kernels: {launched}")
    print(f"[8] b256 img/s: {json.dumps(rates)}  [{name}]", flush=True)


DCN_ROIS = 128


def dcn_rois(n, seed):
    """n RoIs [batch index, x1, y1, x2, y2] on two 800 × 800 images (the
    maps are 1/16 of that), 16 to 400 pixels a side."""
    g = np.random.default_rng(seed)
    xy = g.uniform(0, 700, (n, 2))
    wh = g.uniform(16, 400, (n, 2))
    return torch.from_numpy(np.concatenate(
        [g.integers(0, 2, (n, 1)), xy, np.minimum(xy + wh, 799)], 1).astype(np.float32))


def _dcn_case(tag, module, args, name):
    """One DCN op: card f32 (TF32 off) against the CPU within 1e-4 of
    max|ref|, bf16 against card f32 within 5e-2; ms of each on the card."""
    from jittor_mlp_tpu_torch import config

    check(next(module.parameters()).is_cuda, f"{tag}: not built on the card")
    cpu = copy.deepcopy(module).cpu()
    with torch.inference_mode(), config.parity_mode():
        t0 = time.perf_counter()
        ref = cpu(*(a.cpu() for a in args))
        cpu_s = time.perf_counter() - t0
        got = module(*args)
        f32_ms = cuda_ms(lambda: module(*args), 5)
    dev = rel_dev(got.cpu(), ref)
    bf = copy.deepcopy(module).bfloat16()
    bargs = [a.bfloat16() if a.dtype == torch.float32 and i == 0 else a
             for i, a in enumerate(args)]  # the map in bf16, the RoIs in float32
    with torch.inference_mode():
        gb = bf(*bargs)
        bf16_ms = cuda_ms(lambda: bf(*bargs), 5)
    bdev = rel_dev(gb.float(), got)
    print(f"[9] {tag}: out {tuple(got.shape)}; f32 card (TF32 off) vs CPU "
          f"max|d|/max|ref|={dev:.6g} (limit 1e-4; CPU {cpu_s:.2f} s); bf16 vs card f32 "
          f"{bdev:.6g} (limit 5e-2); {f32_ms:.4f} ms f32 (TF32 off), {bf16_ms:.4f} ms bf16  "
          f"[{name}]", flush=True)
    check(bool(torch.isfinite(got).all() and torch.isfinite(gb).all()), f"{tag}: non-finite")
    check(dev <= 1e-4 and bdev <= 5e-2, f"{tag}: f32 {dev}, bf16 {bdev}")


def phase_dcn(mods, name):
    """Phase 9: the DCN ops at a detection head's sizes (no model of the
    zoo calls them); no port kernel launches."""
    from jittor_mlp_tpu_torch.ops import dcn

    reset_counts(mods)
    g = np.random.default_rng(9)
    m = dcn.DCN(256, 256, 3, stride=1, padding=1)  # on the card; seed-0 weight
    com = m.conv_offset_mask
    with torch.no_grad():  # offsets ±6 px from the bias, so taps leave the map
        com.weight.copy_(torch.from_numpy(g.standard_normal(com.weight.shape) * 0.01))
        com.bias.copy_(torch.from_numpy(np.concatenate(
            [g.standard_normal(18) * 6.0, g.standard_normal(9)])))
        m.bias.copy_(torch.from_numpy(g.standard_normal(256)))
    x = torch.from_numpy(g.standard_normal((16, 256, 64, 64), np.float32)).cuda()
    _dcn_case("DCN(256, 256, 3, stride 1, padding 1) on (16, 256, 64, 64)", m, [x], name)
    with torch.inference_mode():
        om = com(x)
        rows = torch.arange(64, device="cuda").reshape(1, 1, 64, 1)
        taps = torch.arange(9, device="cuda").reshape(1, 9, 1, 1) // 3 - 1
        pos = rows + taps + om[:, 0:18:2]  # the rows sampled, per tap
        off_map = ((pos < 0) | (pos > 63)).float().mean().item()
    print(f"[9] DCN: {off_map:.4f} of the sampled rows lie off the map", flush=True)
    check(off_map > 0.01, f"DCN offsets hardly leave the map: {off_map}")
    del x, m, om, pos

    m = dcn.DCNPooling(spatial_scale=1 / 16, pooled_size=7, output_dim=256, no_trans=False,
                       sample_per_part=4, trans_std=0.1)
    last = m.offset_mask_fc[4]
    with torch.no_grad():  # the last Linear is zeros at first: trans 0, mask 0.5
        last.weight.copy_(torch.from_numpy(g.standard_normal(last.weight.shape) * 0.05))
        last.bias.copy_(torch.from_numpy(g.standard_normal(last.bias.shape)))
    fmap = torch.from_numpy(g.standard_normal((2, 256, 50, 50), np.float32)).cuda()
    rois = dcn_rois(DCN_ROIS, 10).cuda()
    _dcn_case(f"DCNPooling(1/16, pooled 7, output 256, trans_std 0.1) over {DCN_ROIS} RoIs "
              f"on (2, 256, 50, 50)", m, [fmap, rois], name)
    launched = {m: (sum(mod.LAUNCHES.values()) if isinstance(mod.LAUNCHES, dict)
                    else mod.LAUNCHES) for m, mod in mods.items()}
    check(not any(launched.values()), f"the DCN run launched port kernels: {launched}")


def grads_of(model, batch, dtype):
    """(loss, {name: gradient}) of the train step's loss on batch, the
    parameters and images cast to dtype (None: float32)."""
    from jittor_mlp_tpu_torch.parallel import loss_fn

    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, dtype)
    loss.backward()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"non-finite loss {loss.item()}")
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}


def rel_l2(got, want):
    """Global relative L2 error of tensors (sequences or dicts by key)."""
    keys = want.keys() if isinstance(want, dict) else range(len(want))
    num = sum(((got[k].float() - want[k].float()) ** 2).sum().item() for k in keys)
    return (num / sum((want[k].float() ** 2).sum().item() for k in keys)) ** 0.5


def train_batch(n, seed):
    labels = np.random.default_rng(seed).integers(0, 1000, n)
    return {"image": images(n, seed), "label": torch.from_numpy(labels).to("cuda")}


BLOCK_ARGS = ("x", "ln1w", "ln1b", "wt1", "bt1", "wt2", "bt2", "ln2w", "ln2b", "wc1", "bc1",
              "wc2", "bc2")


def train_block(mods):
    """(a) All 13 gradients of one full-shape Mixer block at B = 8: the
    kernel route against autograd of the kernel twin and against the
    recompute route, per tensor."""
    mb, bwd = mods["mixer_block"], mods["mixer_block_bwd"]
    x, w = block_inputs(8, 196, 768, 384, 3072, seed=11)
    g = _draw(12)[0](*x.shape)

    def grads(block):
        leaves = [t.detach().requires_grad_() for t in (x, *w)]
        return torch.autograd.grad(block(*leaves), leaves, g)

    kern = grads(bwd.fused_mixer_block_train)
    for tag, other in (("autograd of the kernel twin", grads(mb.mixer_block_ref)),
                       ("recompute route", grads(mb.fused_mixer_block_trainable))):
        errs = {}
        for name, a, b in zip(BLOCK_ARGS, kern, other):
            check(a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16,
                  f"block gradient {name}: {tuple(a.shape)} {a.dtype} vs {b.dtype}")
            errs[name] = rel_l2([a], [b])
        worst = max(errs, key=errs.get)
        print(f"[6a] Mixer block {tuple(x.shape)} gradients, kernel route vs {tag}: relative L2 "
              f"per tensor {' '.join(f'{k}={v:.4g}' for k, v in errs.items())}; worst {worst} "
              f"(limit {GRAD_BLOCK})", flush=True)
        check(errs[worst] <= GRAD_BLOCK, f"kernel-route block gradient {worst} vs {tag}: "
              f"{errs[worst]}")


def grad_bands(jt, batch_size=32):
    """(b) Mixer-B/16 gradients of every parameter on the kernel route, the
    recompute route and the plain bf16 path, against float32 (TF32 off)
    and against each other, as global relative L2 errors."""
    from jittor_mlp_tpu_torch import config

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    batch = train_batch(batch_size, 3)
    with config.parity_mode():
        _, ref = grads_of(model, batch, None)
    paths = {}
    for path, use_pallas, pallas_bwd in (("kernel route", True, True),
                                         ("recompute route", True, False),
                                         ("plain bf16 path", False, False)):
        model.use_pallas, config.pallas_bwd = use_pallas, pallas_bwd
        _, paths[path] = grads_of(model, batch, torch.bfloat16)
    model.use_pallas, config.pallas_bwd = True, False
    errs = {}
    for path, grads in paths.items():
        errs[f"{path} vs f32"] = (rel_l2(grads, ref), GRAD_VS_F32)
    names = list(paths)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            lim = GRAD_PLAIN if "plain" in a + b else GRAD_ROUTES
            errs[f"{a} vs {b}"] = (rel_l2(paths[a], paths[b]), lim)
    for tag, (err, lim) in errs.items():
        print(f"[6b] Mixer-B/16 b{batch_size} gradients, {tag}: global relative L2 {err:.6g} "
              f"(limit {lim})", flush=True)
    for tag, (err, lim) in errs.items():
        check(err <= lim, f"Mixer-B/16 gradients {tag}: {err} > {lim}")
    return errs


def loss_descends(jt, mods, steps=10, batch_size=128):
    """(c) AdamW steps on one batch on each route, remat off and on; (d)
    the launches per step. Returns the kernel route's launches (remat off):
    the training path's run of the four training kernels."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(batch_size, 5)
    mb, bwd = mods["mixer_block"], mods["mixer_block_bwd"]
    runs, counted = {}, {}
    for route in ("kernel", "recompute"):
        for remat in (False, True):
            model.load_state_dict(init)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
            step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
            config.pallas_bwd = route == "kernel"
            fwd_mod = bwd if route == "kernel" else mb  # the library of the block forward
            reset_counts(mods)  # the training path's run starts here
            routes0, modes0 = fwd_mod.routes(), bwd.mode_launches()
            with config.remat_mode() if remat else contextlib.nullcontext():
                losses = [step(batch).item() for _ in range(steps)]
            torch.cuda.synchronize()
            counts = {k: v for k, v in bwd.LAUNCHES.items()}
            counts["fused_mixer_block"] = mb.LAUNCHES
            config.pallas_bwd = False
            fwd = DEPTH * steps * (2 if remat else 1)
            bwd_n = DEPTH * steps if route == "kernel" else 0
            want = {"fwd_with_h": fwd if route == "kernel" else 0, "token_bwd": bwd_n,
                    "chan_data_bwd": bwd_n, "chan_wgt_bwd": bwd_n,
                    "fused_mixer_block": 0 if route == "kernel" else fwd}
            tag = f"{route} route, remat {'on' if remat else 'off'}"
            print(f"[6c] Mixer-B/16 b{batch_size} {steps} AdamW steps, {tag}: losses "
                  f"{' '.join(f'{v:.6f}' for v in losses)}", flush=True)
            print(f"[6d] launches, {tag}: {json.dumps(counts)} (want {json.dumps(want)})",
                  flush=True)
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"{tag}: the loss did not descend: {losses}")
            check(counts == want, f"{tag}: launches {counts}, want {want}")
            # the kernel route's library also runs the channel backwards' products
            products = sum(BWD_PRODUCTS.get(k, 0) * counts[k] for k in TRAIN_KERNELS) \
                if route == "kernel" else BLOCK_PRODUCTS["mixer_block"][1] * fwd
            moved = check_routes(f"[6d] {tag}, block forwards and channel backwards", routes0,
                                 fwd_mod.routes(), products)
            runs[(route, remat)] = losses
            modes = {k: v - modes0[k] for k, v in bwd.mode_launches().items()}
            want_modes = {k: sum(BWD_MODES[n].get(k, 0) * counts[n] for n in BWD_MODES)
                          for k in ("dual", "group")}
            got_modes = {k: modes[k] for k in want_modes}
            print(f"[6d] the wgmma core's dual and Group launches, {tag}: "
                  f"{json.dumps(got_modes)} (want {json.dumps(want_modes)})", flush=True)
            check(got_modes == want_modes,
                  f"{tag}: dual and Group launches {got_modes}, want {want_modes}")
            if route == "kernel" and not remat:
                counted = {k: counts[k] for k in TRAIN_KERNELS}
                counted["gemm_bwd_sm90"] = moved - BWD_PRODUCTS["fwd_with_h"] * counts["fwd_with_h"]
                counted["gemm_bf16_dual_sm90"] = modes["dual"]
                counted["gemm_bf16_group_sm90"] = modes["group"]
        check(runs[(route, True)] == runs[(route, False)],
              f"{route} route: remat changed the losses")
        print(f"[6c] {route} route: remat on gives the same losses, bit for bit", flush=True)
    return counted


def other_families(jt, mods, batch_size=32):
    """(e) One ResMLP-S24 and one gMLP-S bf16 train step; their gradients on
    the kernel path against the plain bf16 path."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    batch = train_batch(batch_size, 6)
    for tag, build, lib, depth in (
            ("ResMLP-S24", lambda: jt.ResMLPForImageClassification(**RESMLP_S24)
             .load_torch_state_dict(resmlp_state_dict(jt)), "resmlp_block", RES_DEPTH),
            ("gMLP-S", lambda: jt.gMLPForImageClassification(**GMLP_S), "gmlp_block",
             GMLP_DEPTH)):
        mod = mods[lib]
        model = build()
        model.use_pallas = False
        _, plain = grads_of(model, batch, torch.bfloat16)
        model.use_pallas = True
        before, routes0 = mod.LAUNCHES, mod.routes()
        _, kern = grads_of(model, batch, torch.bfloat16)
        check(mod.LAUNCHES == before + depth,
              f"{tag}: {mod.LAUNCHES - before} forward-kernel launches in a step, want {depth}")
        # the block forward's three products, all on wgmma
        check_routes(f"[6e] {tag} step", routes0, mod.routes(), BLOCK_PRODUCTS[lib][1] * depth)
        err = rel_l2(kern, plain)
        step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3,
                                                        weight_decay=1e-4, eps=1e-8),
                               compute_dtype=torch.bfloat16)
        loss = step(batch).item()
        print(f"[6e] {tag} b{batch_size} bf16 train step: loss {loss:.6f}; gradients of the "
              f"kernel path vs the plain bf16 path: global relative L2 {err:.6g} "
              f"(limit {GRAD_BLOCK}); {depth} forward-kernel launches a step", flush=True)
        check(np.isfinite(loss) and err <= GRAD_BLOCK, f"{tag}: loss {loss}, gradient error {err}")
        del model


TRAIN_IMG_S = {}  # phase 6f: Mixer-B/16 b128 make_train_step img/s per path, which 12a reads


def train_throughput(jt, name, batch_size=128):
    """(f) Train img/s at b128 on each path, in turns, by CUDA events."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, 7)
    paths = {"kernel route": (True, True), "recompute route": (True, False),
             "plain bf16 path": (False, False)}
    times = {k: [] for k in paths}
    peak = {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas, config.pallas_bwd = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas, config.pallas_bwd = True, False
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        TRAIN_IMG_S[path] = batch_size * 1e3 / ms
        print(f"[6f] Mixer-B/16 bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def block_throughput(jt, name, tag, model, seed, batch_size=128):
    """(f) A block family's bf16 train img/s at b128, kernel path (the block
    kernel forward, autograd of the plain block backward) and plain path in
    turns, by CUDA events, with peak memory."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, seed)
    paths = {"kernel path": True, "plain bf16 path": False}
    times, peak = {k: [] for k in paths}, {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas = True
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        print(f"[6f] {tag} bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def as_mlp_grads(jt, mods, batch_size=32):
    """(g) AS-MLP-T gradients of every parameter at b32 (no drop-path): the
    kernel path (the shift kernel forward and backward) against the plain
    bf16 path, and each against the plain float32 path (TF32 off), as
    global relative L2 errors; the kernel path launches the shift 48 times
    a step."""
    from jittor_mlp_tpu_torch import config

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T, use_pallas=False)
    batch = train_batch(batch_size, 8)
    with config.parity_mode():
        _, ref = grads_of(model, batch, None)
    _, plain = grads_of(model, batch, torch.bfloat16)
    model.use_pallas = True
    before = sk.LAUNCHES
    _, kern = grads_of(model, batch, torch.bfloat16)
    n = sk.LAUNCHES - before
    errs = {"kernel path vs plain bf16 path": (rel_l2(kern, plain), GRAD_BLOCK),
            "kernel path vs f32": (rel_l2(kern, ref), AS_GRAD_VS_F32),
            "plain bf16 path vs f32": (rel_l2(plain, ref), AS_GRAD_VS_F32)}
    for tag, (err, lim) in errs.items():
        print(f"[6g] AS-MLP-T b{batch_size} gradients, {tag}: global relative L2 {err:.6g} "
              f"(limit {lim})", flush=True)
    print(f"[6g] AS-MLP-T: {n} shift launches in a step (want {2 * SHIFTS})", flush=True)
    check(n == 2 * SHIFTS, f"AS-MLP-T: {n} shift launches in a step, want {2 * SHIFTS}")
    for tag, (err, lim) in errs.items():
        check(err <= lim, f"AS-MLP-T gradients {tag}: {err} > {lim}")
    return errs


def as_mlp_train(jt, mods, steps=10, batch_size=128):
    """(h) AdamW steps on one batch with drop-path (rate 0.1) drawn from a
    seeded generator, remat off and on: the loss descends, remat gives the
    same losses, and the shift launches 48 times a step (72 under remat)."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(batch_size, 9)
    runs = {}
    for remat in (False, True):
        model.load_state_dict(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
        step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts(mods)  # the AS-MLP training path's run starts here
        with config.remat_mode() if remat else contextlib.nullcontext():
            losses = [step(batch, gen).item() for _ in range(steps)]
        torch.cuda.synchronize()
        n, want = sk.LAUNCHES, SHIFTS * steps * (3 if remat else 2)
        tag = f"remat {'on' if remat else 'off'}"
        print(f"[6h] AS-MLP-T b{batch_size} {steps} AdamW steps, drop_path_rate 0.1, {tag}: "
              f"losses {' '.join(f'{v:.6f}' for v in losses)}; {n} shift launches (want {want})",
              flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"AS-MLP-T {tag}: the loss did not descend: {losses}")
        check(n == want, f"AS-MLP-T {tag}: {n} shift launches, want {want}")
        runs[remat] = losses
    check(runs[True] == runs[False], "AS-MLP-T: remat changed the losses")
    print("[6h] AS-MLP-T: remat on gives the same losses, bit for bit", flush=True)


def as_mlp_throughput(jt, name, batch_size=128):
    """(i) AS-MLP-T train img/s at b128, kernel path and plain path in
    turns, drop-path on, by CUDA events, with peak memory."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.AS_MLP(**AS_MLP_T)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, 10)
    gen = torch.Generator(device="cuda").manual_seed(1)
    paths = {"kernel path": True, "plain bf16 path": False}
    times, peak = {k: [] for k in paths}, {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch, gen), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas = True
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        print(f"[6i] AS-MLP-T bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def phase_train(jt, mods, name):
    """Phase 6; returns the training kernels' launches on the training path."""
    train_block(mods)
    grad_bands(jt)
    counted = loss_descends(jt, mods)
    torch.cuda.empty_cache()
    other_families(jt, mods)
    torch.cuda.empty_cache()
    train_throughput(jt, name)
    torch.cuda.empty_cache()
    block_throughput(jt, name, "gMLP-S", jt.gMLPForImageClassification(**GMLP_S), 11)
    torch.cuda.empty_cache()
    block_throughput(jt, name, "ResMLP-S24", jt.ResMLPForImageClassification(**RESMLP_S24), 12)
    torch.cuda.empty_cache()
    as_mlp_grads(jt, mods)
    torch.cuda.empty_cache()
    as_mlp_train(jt, mods)
    torch.cuda.empty_cache()
    as_mlp_throughput(jt, name)
    return counted


# Phase 10: one train step of each of phase 8's models at the same widths.
# The drop-path families train at their factories' default rates, and at
# 0.1 where that default is 0 (TRAIN_RATE), so that drop-path runs on the card
DROP_PATH_FAMILIES = ("raft_mlp", "swin_mlp", "dyna_mlp", "ms_mlp", "cycle_mlp", "active_mlp",
                      "morph_mlp", "conv_mlp", "gfnet", "gfnet_pyramid")
TRAIN_RATE = {"raft_mlp": 0.1, "cycle_mlp": 0.1, "active_mlp": 0.1, "gfnet": 0.1,
              "gfnet_pyramid": 0.1}
TRAIN_LOSS = 1e-4  # f32 card (TF32 off) vs CPU, relative
TRAIN_GRAD = 1e-3  # f32 card vs CPU, global relative L2 of the gradients
TRAIN_BF16 = 5e-2  # bf16 gradients vs card f32, global relative L2
# printed, not held: TEACHER_FORCED's draws amplify rounding (phase 8), and
# ConvMLP-M's bf16 conv-BatchNorm stem at b2 is as far from f32 in the JAX
# package itself: on the CPU, the same weights and batch, JAX's bf16
# gradients read 0.0765 from its f32 ones, the port's 0.0768 (its f32
# gradients within 4.2e-4 of JAX's)
BF16_GRADS_FREE = TEACHER_FORCED + ("conv_mlp",)
TRAIN_BATCH = 128
TRAIN_ITERS = 3  # timed b128 steps, after one warm-up step


def lstm_copies(caught):
    return [str(w.message)[:80] for w in caught if "contiguous chunk" in str(w.message)]


def train_zoo_case(jt, key, name):
    """(a) f32 gradients on the card against the CPU at b2; (b) one bf16
    make_train_step step with AdamW and a cuda generator; (c) b128 bf16
    train img/s and peak memory (under remat, or at b64, where a b128 step
    does not fit). Returns (img/s, how, cuDNN weight-compaction warnings
    seen)."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    title, factory_name, kw, _ends, edit = FAMILIES[key]
    factory = jt
    for part in factory_name.split("."):
        factory = getattr(factory, part)
    kw = {k: v for k, v in kw.items() if k != "drop_path_rate"}  # the factory's default
    kw.update({"drop_path_rate": TRAIN_RATE[key]} if key in TRAIN_RATE else {})
    tag = f"[10] {title}"
    sd = factory(**kw, device="cpu").export_torch_state_dict()  # seed 0
    if edit is not None:
        edit(sd)

    def build(**where):
        return factory(**kw, **where).load_torch_state_dict(sd)

    # (a) f32: card against CPU, the same weights and batch, drop-path off
    b2 = train_batch(2, 100)
    card_m = build()
    with config.parity_mode():
        lc, gc = grads_of(card_m, b2, None)
        t0 = time.perf_counter()
        lcpu, gcpu = grads_of(build(device="cpu"), {k: v.cpu() for k, v in b2.items()}, None)
        cpu_s = time.perf_counter() - t0
    loss_dev = abs(lc - lcpu) / abs(lcpu)
    grad_dev = rel_l2({k: v.cpu() for k, v in gc.items()}, gcpu)
    check(gc.keys() == gcpu.keys(), f"{tag}: gradients of {sorted(set(gc) ^ set(gcpu))[:3]}")
    # the bf16 gradients of the same batch (cast at the loss boundary)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, gb = grads_of(card_m, b2, torch.bfloat16)
    bf16_dev = rel_l2(gb, gc)
    held = key not in BF16_GRADS_FREE
    print(f"{tag}: f32 b2 card (TF32 off) vs CPU: loss {lc:.6f} rel dev {loss_dev:.3g} "
          f"(limit {TRAIN_LOSS}), gradients rel L2 {grad_dev:.3g} (limit {TRAIN_GRAD}; CPU "
          f"{cpu_s:.2f} s); bf16 gradients vs card f32 rel L2 {bf16_dev:.4g} "
          f"({'limit ' + str(TRAIN_BF16) if held else 'printed only'})", flush=True)
    check(loss_dev <= TRAIN_LOSS and grad_dev <= TRAIN_GRAD,
          f"{tag}: f32 card vs CPU loss {loss_dev}, gradients {grad_dev}")
    check(not held or bf16_dev <= TRAIN_BF16,
          f"{tag}: bf16 gradients {bf16_dev}")
    del card_m, gc, gcpu, gb

    # (b) one bf16 step with AdamW and a generator on the card
    model = build()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b8 = train_batch(8, 101)
    with warnings.catch_warnings(record=True) as caught_step:
        warnings.simplefilter("always")
        loss = float(step(b8, gen))
    params = dict(model.named_parameters())
    trained = {k for k, p in params.items() if p.grad is not None}
    moved = {k for k in trained if not torch.equal(params[k].detach(), before[k])}
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    stats_moved = sum(not torch.equal(model.state_dict()[k], before[k]) for k in stats)
    dp = ""
    if key in DROP_PATH_FAMILIES:
        rates = [m.drop_path_rate for m in model.modules() if hasattr(m, "drop_path_rate")]
        with torch.no_grad():
            x = b8["image"].bfloat16()
            model.to_bf16()
            plain = model.train().forward(x)
            dropped = model.forward(x, torch.Generator(device="cuda").manual_seed(1))
            evaled = model.eval().forward(x)
        dp_dev, eval_dev = rel_dev(dropped.float(), plain.float()), rel_dev(dropped.float(),
                                                                             evaled.float())
        dp = (f"; drop-path rates {min(rates):.3g}..{max(rates):.3g} over {len(rates)} sites: "
              f"train forward with a generator vs without {dp_dev:.4g}, vs eval {eval_dev:.4g}")
        check(model.stochastic and dp_dev > 0 and eval_dev > 0,
              f"{tag}: drop-path does not move the train forward ({dp_dev}, {eval_dev})")
    print(f"{tag}: bf16 step (AdamW, cuda generator): loss {loss:.4f}; {len(moved)} of "
          f"{len(trained)} trained parameters moved ({len(params) - len(trained)} without a "
          f"gradient); {stats_moved} of {len(stats)} running statistics moved{dp}", flush=True)
    check(np.isfinite(loss) and moved == trained and stats_moved == len(stats),
          f"{tag}: step loss {loss}, moved {len(moved)}/{len(trained)}, stats "
          f"{stats_moved}/{len(stats)}")
    del model, opt, step, before

    # (c) b128 bf16 train img/s and peak memory (1 warm-up, 3 timed steps)
    for attempt in ("b128", "b128 remat", "b64 remat"):
        model = build()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.05)
        step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
        batch = 64 if attempt.startswith("b64") else TRAIN_BATCH
        data = train_batch(batch, 102)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with (config.remat_mode() if "remat" in attempt else contextlib.nullcontext()), \
                    warnings.catch_warnings(record=True) as caught_tp:
                warnings.simplefilter("always")
                ms = cuda_ms(lambda: step(data, gen), TRAIN_ITERS, warmup=1)
            how = attempt
            break
        except torch.cuda.OutOfMemoryError:
            print(f"{tag}: {attempt} train step does not fit in "
                  f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB",
                  flush=True)
            del model, opt, step, data
            torch.cuda.empty_cache()
    else:
        fail(f"{tag}: no train step fits on the card")
    rate = batch * 1e3 / ms
    copies = lstm_copies(caught) + lstm_copies(caught_step) + lstm_copies(caught_tp)
    lstm = f"; cuDNN weight-compaction warnings {len(copies)}" if key == "sequencer" else ""
    print(f"{tag} bf16 train step {how}: {ms:.4f} ms, {rate:.1f} img/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB{lstm}  [{name}]", flush=True)
    del model, opt, step, data
    return rate, how, len(copies)


def lstm_copy_cost(name):
    """Sequencer2D-S's stage-1 BiLSTM (8192 x 32 x 192, H 48) forward and
    backward in bf16 as the train step calls it, on bf16 cast copies of
    float32 weights (outside cuDNN's buffer), against the same LSTM with
    its bf16 weights in cuDNN's buffer: what the copies cost a call.
    Returns ms each."""
    from jittor_mlp_tpu_torch.ops.lstm import LSTM, bilstm
    from jittor_mlp_tpu_torch.parallel.train import cast_floating

    torch.manual_seed(0)
    lstm = LSTM(192, 48).cuda()
    flat = copy.deepcopy(lstm).bfloat16()
    x = torch.randn(8192, 32, 192, device="cuda", dtype=torch.bfloat16, requires_grad=True)

    def cast_call():
        tensors = cast_floating(dict(lstm.named_parameters()), torch.bfloat16)
        torch.func.functional_call(lstm, tensors, (x,))[0].sum().backward()

    def flat_call():
        bilstm(flat, x).sum().backward()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cast_ms = cuda_ms(cast_call, 5)
    flat_ms = cuda_ms(flat_call, 5)
    print(f"[10] bilstm bf16 forward+backward at 8192 x 32 x 192: on cast copies "
          f"{cast_ms:.4f} ms ({len(lstm_copies(caught))} compaction warnings), on cuDNN's "
          f"buffer {flat_ms:.4f} ms: the copy costs {cast_ms - flat_ms:.4f} ms a call  "
          f"[{name}]", flush=True)
    return cast_ms, flat_ms


def phase_train_zoo(jt, mods, name):
    """Phase 10: each of phase 8's models trains on the card through
    make_train_step (drop-path, BatchNorm running statistics); no port
    kernel launches in it."""
    reset_counts(mods)
    t0 = time.perf_counter()
    rates, copies = {}, 0
    for key in FAMILIES:
        rate, how, n_copies = train_zoo_case(jt, key, name)
        rates[key] = round(rate, 1) if how == "b128" else f"{rate:.1f} ({how})"
        copies += n_copies
        torch.cuda.empty_cache()
    if "sequencer" in FAMILIES:
        lstm_copy_cost(name)
    print(f"[10] cuDNN weight-compaction warnings in the train run: {copies}", flush=True)
    launched = {m: (sum(mod.LAUNCHES.values()) if isinstance(mod.LAUNCHES, dict)
                    else mod.LAUNCHES) for m, mod in mods.items()}
    print(f"[10] port kernel launches in the train run: {json.dumps(launched)} (want 0)",
          flush=True)
    check(not any(launched.values()), f"the train run launched port kernels: {launched}")
    print(f"[10] bf16 train img/s: {json.dumps(rates)}; phase 10 in "
          f"{time.perf_counter() - t0:.1f} s  [{name}]", flush=True)


# Phase 11: the serving and evaluation layer around the Mixer-B/16 kernel
# path: data pipeline, evaluate, the HTTP server, deploy (torch.export),
# checkpoints and timing.
N_FOLDER = 600  # images in phase 11's folder: 10 classes of 60
FOLDER_HW = (256, 320)  # their height and width
EVAL_BATCH = 256
SERVE_CLIENTS, SERVE_EACH = 8, 16  # client threads, PNGs each
THROUGHPUT_BAND = 0.10  # utils.timing.throughput vs phase 5's img/s, relative


def png_bytes(img):
    """PNG file bytes (8-bit RGB, filter 0 on every row, zlib level 1) of an
    (H, W, 3) uint8 array: the phase's images are written without PIL."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_folder(root, seed=0, n=N_FOLDER, hw=FOLDER_HW):
    """n seeded PNGs of hw in 10 class subfolders under root; returns the
    source arrays in the dataset's (sorted) order."""
    import os

    src = np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    per = n // 10
    for i, img in enumerate(src):
        d = os.path.join(root, f"class{i // per}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{i % per:03d}.png"), "wb") as f:
            f.write(png_bytes(img))
    return src


def serving_data(root, name):
    """(a): the native libraries, the folder, and decoding at the shorter
    side (256) reproducing the sources' center crops exactly. Returns the
    sources, and whether PIL is there (the decoder's fallback)."""
    import importlib.util

    from jittor_mlp_tpu_torch.data import ImageFolderDataset
    from jittor_mlp_tpu_torch.data.loader import decode_available, native_available

    check(native_available(), "the fastloader library did not build (g++)")
    native_decode = decode_available()
    has_pil = importlib.util.find_spec("PIL") is not None
    print(f"[11a] native_available() True, decode_available() {native_decode} "
          f"(libjpeg/libpng headers), PIL {'present' if has_pil else 'absent'}", flush=True)
    t0 = time.perf_counter()
    src = write_folder(root)
    print(f"[11a] wrote {N_FOLDER} PNGs of {FOLDER_HW[0]}x{FOLDER_HW[1]} in 10 classes: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not (native_decode or has_pil):
        print("[11a] neither the native decoder nor PIL: the folder path cannot run here; "
              "(b) evaluates an ArrayDataset of the same arrays", flush=True)
        return src, False
    ds = ImageFolderDataset(root, decode_size=FOLDER_HW[0])
    check(len(ds) == N_FOLDER and ds.classes == [f"class{c}" for c in range(10)],
          f"ImageFolderDataset found {len(ds)} images, classes {ds.classes}")
    left = (FOLDER_HW[1] - FOLDER_HW[0]) // 2
    t0 = time.perf_counter()
    for s in range(0, N_FOLDER, 100):
        batch, labels = ds.get_batch(list(range(s, s + 100)))
        check(np.array_equal(batch, src[s:s + 100, :, left:left + FOLDER_HW[0]]),
              f"decoding at {FOLDER_HW[0]} is not the center crop (images {s}..{s + 99})")
        check(np.array_equal(labels, np.arange(s, s + 100) // (N_FOLDER // 10)), "labels")
    path = "native decoder" if native_decode else "PIL fallback (no native decoder)"
    print(f"[11a] decode at {FOLDER_HW[0]} through the {path}: all {N_FOLDER} equal the "
          f"sources' center crops bit for bit ({time.perf_counter() - t0:.2f} s)", flush=True)
    return src, True


def serving_eval(jt, mods, mixer, root, src, folder_ok, name):
    """(b): evaluate over the folder at 224 in bf16, against a direct
    forward of the same decoded batches."""
    from jittor_mlp_tpu_torch.data import (ArrayDataset, BatchIterator, ImageFolderDataset,
                                           make_preprocess)
    from jittor_mlp_tpu_torch.data.loader import resize_batch
    from jittor_mlp_tpu_torch.examples.eval import evaluate

    labels_all = np.arange(N_FOLDER) // (N_FOLDER // 10)
    if folder_ok:
        ds = ImageFolderDataset(root, decode_size=224)
    else:  # the same arrays, resized on the host
        ds = ArrayDataset(resize_batch(src[:, :, 32:288], 224), labels_all)

    def batches():
        return BatchIterator(ds, EVAL_BATCH, shuffle=False, drop_last=False)

    mb = mods["mixer_block"]
    top5s = []
    reset_counts(mods)  # the eval path's run starts here
    top1, top5, n, img_s = evaluate(mixer, batches(), EVAL_BATCH, torch.bfloat16,
                                    top5_out=top5s)
    launched = mb.LAUNCHES
    want_launches = DEPTH * -(-N_FOLDER // EVAL_BATCH)
    print(f"[11b] evaluate, {'ImageFolderDataset' if folder_ok else 'ArrayDataset'} -> "
          f"BatchIterator({EVAL_BATCH}) -> bf16 Mixer-B/16: n {n}, top-1 {top1:.4f}, "
          f"top-5 {top5:.4f}, {img_s:.1f} img/s end to end (decode included); "
          f"{launched} fused_mixer_block launches (want {want_launches})  [{name}]", flush=True)
    check(n == N_FOLDER, f"evaluate counted {n} images, want {N_FOLDER}")
    check(launched == want_launches, f"{launched} launches in evaluate, want {want_launches}")
    pre = make_preprocess(224, dtype=torch.bfloat16)
    hit1 = hit5 = 0
    with torch.inference_mode():
        for k, b in enumerate(batches()):
            valid = len(b["label"])
            imgs = np.concatenate([b["image"], np.zeros((EVAL_BATCH - valid, 224, 224, 3),
                                                        np.uint8)])
            logits = mixer.forward(pre(torch.from_numpy(imgs).cuda())).float()[:valid]
            got = torch.from_numpy(top5s[k]).cuda()
            check(torch.equal(torch.topk(logits, 5, dim=-1).indices, got),
                  f"batch {k}: evaluate's top-5 differ from the direct forward's")
            check(bool((logits.gather(1, got[:, :1])[:, 0] == logits.max(-1).values).all()),
                  f"batch {k}: evaluate's top-1 is not the direct forward's argmax")
            lab = torch.from_numpy(b["label"].astype(np.int64)).cuda()
            hit1 += int((got[:, 0] == lab).sum())
            hit5 += int((got == lab[:, None]).any(-1).sum())
    check(hit1 == round(top1 * n) and hit5 == round(top5 * n),
          f"hits recomputed {hit1}, {hit5}; evaluate's {top1 * n}, {top5 * n}")
    print(f"[11b] each image's top-1 is the direct forward's argmax on the same decoded "
          f"batch; hit@1 {hit1}, hit@5 {hit5} recomputed = evaluate's", flush=True)
    return img_s


def serving_http(jt, mods, mixer, root, name):
    """(c): examples/serve.make_server at --batch 32 (bf16, MicroBatcher) on
    127.0.0.1 port 0; 8 clients POST 16 PNGs each."""
    import http.client
    import os

    from jittor_mlp_tpu_torch.examples import serve as serve_ex

    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs)
    bodies = []
    for path in files[:SERVE_CLIENTS * SERVE_EACH]:
        with open(path, "rb") as f:
            bodies.append(f.read())
    args = serve_ex.parse_args(["--batch", "32", "--port", "0", "--max-delay-ms", "5"])
    reset_counts(mods)
    server, pred, batcher = serve_ex.make_server(args, model=mixer)
    check(pred.dtype == "bf16" and batcher is not None, f"server dtype {pred.dtype}")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/classify", body=body)
            r = conn.getresponse()
            return r.status, r.reason, r.read()
        finally:
            conn.close()

    n = len(bodies)
    answers, lat, errors = [None] * n, [None] * n, []

    def client(k):
        try:
            for i in range(k, n, SERVE_CLIENTS):
                t0 = time.perf_counter()
                answers[i] = post(bodies[i])
                lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    mb = mods["mixer_block"]
    try:
        workers = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=300)
            check(not t.is_alive(), "an HTTP client did not finish")
        check(not errors, f"HTTP request failed: {errors[:1]}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        r = conn.getresponse()
        stats = json.loads(r.read())
        conn.close()
        status, reason, _ = post(b"this is not an image")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close()
    served, forwards = mb.LAUNCHES, pred.latency_stats()["count"]  # warm-up included
    check(served == DEPTH * forwards,
          f"{served} launches for the server's {forwards} forwards, want {DEPTH} each")
    for i, (st, _reason, blob) in enumerate(answers):
        check(st == 200, f"request {i}: status {st}")
        got = json.loads(blob)["top_k"]
        labels, probs = pred.predict(serve_ex.decode(bodies[i], 224))
        check([e["label"] for e in got] == labels[0].tolist(),
              f"request {i}: labels {[e['label'] for e in got]} != predict's {labels[0]}")
        check(max(abs(e["prob"] - p) for e, p in zip(got, probs[0])) <= 1e-3,
              f"request {i}: probabilities differ from predict's")
    check(r.status == 200 and stats.get("batcher", {}).get("requests") == n
          and stats["batcher"]["batches"] >= 1 and "p50_ms" in stats,
          f"/stats: {stats}")
    check(status == 400 and reason == "bad request",
          f"malformed body: status {status} {reason!r}, want 400 'bad request'")
    ms = np.sort(np.asarray(lat)) * 1e3
    print(f"[11c] HTTP /classify, {SERVE_CLIENTS} clients x {SERVE_EACH} PNGs: every top-5 = "
          f"Predictor.predict on the decoded image; request p50 {np.percentile(ms, 50):.3f} ms, "
          f"p99 {np.percentile(ms, 99):.3f} ms, max {ms[-1]:.3f} ms (client side)  [{name}]",
          flush=True)
    print(f"[11c] /stats: {json.dumps(stats)}", flush=True)
    print(f"[11c] a malformed body: {status} {reason!r} (one line); the server's "
          f"{forwards} forwards (warm-up included) launched fused_mixer_block {served} times; "
          f"shut down", flush=True)


def serving_deploy(jt, mods, mixer, tmp, name):
    """(d): save_exported / load_exported at b32 in bf16 and with int8=True."""
    import os

    from jittor_mlp_tpu_torch import config, deploy

    x = images(32, seed=11).bfloat16()
    for int8, mod, op in ((False, mods["mixer_block"], "fused_mixer_block"),
                          (True, mods["mixer_block_int8"], "fused_mixer_block_int8")):
        tag = "int8" if int8 else "bf16"
        mode = config.int8_mode if int8 else contextlib.nullcontext
        t0 = time.perf_counter()
        path = deploy.save_exported(mixer, os.path.join(tmp, f"mixer_b16_{tag}.pt2"),
                                    batch_size=32, dtype=torch.bfloat16, int8=int8)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd = deploy.load_exported(path)
        t_load = time.perf_counter() - t0
        nodes = [str(nd.target) for nd in fwd.program.graph.nodes if nd.op == "call_function"
                 and str(nd.target).startswith("jittor_mlp_tpu_torch.")]
        check(nodes == [f"jittor_mlp_tpu_torch.{op}.default"] * DEPTH,
              f"{tag} program's op nodes: {nodes}")
        with torch.inference_mode(), mode():
            eager = mixer.forward(x)
        before = mod.LAUNCHES
        got = fwd(x)
        torch.cuda.synchronize()
        check(mod.LAUNCHES == before + DEPTH,
              f"{tag} program launched {op} {mod.LAUNCHES - before} times, want {DEPTH}")
        check(torch.equal(got, eager), f"{tag} program's logits differ from the eager forward")
        runs = {"eager": [], "exported": []}
        for which in ("eager", "exported", "exported", "eager"):  # in turns
            with torch.inference_mode(), mode():
                call = (lambda: mixer.forward(x)) if which == "eager" else (lambda: fwd(x))
                runs[which].append(cuda_ms(call, 20))
        eager_ms, prog_ms = (sum(runs[k]) / 2 for k in ("eager", "exported"))
        try:
            fwd(x[:31])
            raised = None
        except Exception as e:
            raised = type(e).__name__
        check(raised is not None, f"{tag} program took a b31 input")
        print(f"[11d] deploy {tag} b32: {DEPTH} {op} nodes, {DEPTH} launches a call, logits "
              f"bit-equal to the eager forward; exported {prog_ms:.4f} ms vs eager "
              f"{eager_ms:.4f} ms (runs {json.dumps(runs)}); export {t_export:.2f} s, load "
              f"{t_load:.2f} s, file "
              f"{os.path.getsize(path) / 2**20:.1f} MiB; b31 raised {raised}  [{name}]",
              flush=True)
        del fwd
        os.remove(path)


def serving_checkpoints(jt, mods, mixer, imgs16, tmp, name):
    """(e): params round trip, int8 checkpoint, train state."""
    import os

    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step
    from jittor_mlp_tpu_torch.quant import (load_quantized, quantize_state_dict,
                                            quantized_nbytes, save_quantized)
    from jittor_mlp_tpu_torch.utils.serialization import (load_params, restore_train_state,
                                                          save_params, save_train_state)

    x = images(32, seed=12).bfloat16()
    path = save_params(mixer, os.path.join(tmp, "mixer.npz"))
    fresh = jt.MLPMixerForImageClassification(**MIXER_B16, seed=1).to_bf16().eval()
    load_params(fresh, path)
    with torch.inference_mode():
        check(torch.equal(fresh.forward(x), mixer.forward(x)),
              "load_params: logits differ from the saved model's")
    print(f"[11e] save_params -> fresh model -> load_params: logits bit-equal "
          f"({os.path.getsize(path) / 2**20:.1f} MiB file)", flush=True)
    del fresh
    os.remove(path)

    f32 = jt.MLPMixerForImageClassification(**MIXER_B16).eval()  # seed 0's weights in f32
    nbytes = quantized_nbytes(quantize_state_dict(f32.name, f32.state_dict()))
    f32_bytes = sum(v.numel() * 4 for v in f32.state_dict().values())
    qpath = save_quantized(f32, os.path.join(tmp, "mixer.int8.npz"))
    del f32
    qmodel = load_quantized(jt.MLPMixerForImageClassification(**MIXER_B16, seed=2), qpath,
                            dtype=torch.bfloat16)
    pq = jt.Predictor(qmodel, batch_size=16)
    p16 = jt.Predictor(mixer, batch_size=16)
    lq, _ = pq.predict(imgs16)
    l16, _ = p16.predict(imgs16)
    agree = int((lq[:, 0] == l16[:, 0]).sum())
    print(f"[11e] int8 checkpoint: quantized_nbytes {nbytes / 2**20:.2f} MiB = "
          f"{nbytes / f32_bytes:.4f} of the f32 bytes; file {os.path.getsize(qpath) / 2**20:.1f}"
          f" MiB; load_quantized(bf16) Predictor agrees with the bf16 Predictor on {agree} of "
          f"16 images (top-1)", flush=True)
    check(agree >= 15, f"int8 checkpoint agrees on {agree} of 16 images, want >= 15")
    del pq, qmodel
    os.remove(qpath)

    old = config.pallas_bwd
    config.pallas_bwd = True  # the Mixer's kernel route
    try:
        batches = [train_batch(32, seed=s) for s in (21, 22)]

        def fresh_state(seed):
            model = jt.MLPMixerForImageClassification(**MIXER_B16, seed=seed)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            return model, opt, make_train_step(model, opt, compute_dtype=torch.bfloat16)

        model, opt, step = fresh_state(0)
        bwd0 = launches(mods["mixer_block_bwd"], "token_bwd")
        step(batches[0])
        spath = save_train_state(os.path.join(tmp, "state.pt"), model, opt, 1)
        want = step(batches[1])
        bwd = launches(mods["mixer_block_bwd"], "token_bwd") - bwd0
        del model, opt, step
        model, opt, step = fresh_state(3)
        check(restore_train_state(spath, model, opt) == 1, "restored step")
        got = step(batches[1])
        check(torch.equal(got, want), f"resumed loss {got.item()} != uninterrupted {want.item()}")
        check(bwd == 2 * DEPTH, f"{bwd} token_bwd launches in two kernel-route steps")
        print(f"[11e] train state after one b32 kernel-route step ({bwd} token_bwd launches "
              f"over two steps): restored into fresh objects, the next loss "
              f"{got.item():.6f} bit-equal to the uninterrupted run's "
              f"({os.path.getsize(spath) / 2**20:.1f} MiB file)", flush=True)
        del model, opt, step
        os.remove(spath)
    finally:
        config.pallas_bwd = old


def op_dispatch_cost(mb, mixer, name):
    """The Mixer-B/16 bf16 forward with each block through its
    ``torch.library`` op and with the wrapper calling the ctypes launch
    directly (the op's CUDA implementation, no dispatcher), in turns."""
    op = mb.OP
    variants = {"torch.library op": op, "direct ctypes launch": mb._launch}
    try:
        for batch, iters in ((256, 10), (32, 30)):
            x = images(batch, seed=13).bfloat16()
            times = {k: [] for k in variants}
            with torch.inference_mode():
                for which in (list(variants) + list(variants)[::-1]) * 2:
                    mb.OP = variants[which]
                    times[which].append(cuda_ms(lambda: mixer.forward(x), iters))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            print(f"[11f] Mixer-B/16 bf16 forward b{batch}: through the op "
                  f"{ms['torch.library op']:.4f} ms, direct launch "
                  f"{ms['direct ctypes launch']:.4f} ms (runs {json.dumps(times)})  [{name}]",
                  flush=True)
    finally:
        mb.OP = op


def phase_serving_layer(jt, mods, name):
    """Phase 11: the serving and evaluation layer on Mixer-B/16 @224, seed-0
    weights as phase 5 builds them, bf16."""
    import tempfile

    from jittor_mlp_tpu_torch.utils.timing import throughput

    t_phase = time.perf_counter()
    mixer = jt.MLPMixerForImageClassification(**MIXER_B16).to_bf16().eval()
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/folder"
        src, folder_ok = serving_data(root, name)
        serving_eval(jt, mods, mixer, root, src, folder_ok, name)
        if folder_ok:
            serving_http(jt, mods, mixer, root, name)
        else:
            print("[11c] no decoder for the HTTP bodies (neither native nor PIL): not run",
                  flush=True)
        serving_deploy(jt, mods, mixer, tmp, name)
        from jittor_mlp_tpu_torch.data.loader import resize_batch

        imgs16 = resize_batch(src[:16, :, 32:288], 224)
        serving_checkpoints(jt, mods, mixer, imgs16, tmp, name)
    img_s = throughput(lambda x: mixer.forward(x), (256, 3, 224, 224), dtype=torch.bfloat16)
    p5 = FORWARD_IMG_S[("Mixer-B/16", "bf16 kernel path")]
    print(f"[11f] utils.timing.throughput bf16 b256: {img_s:.1f} img/s; phase 5's "
          f"{p5:.1f} img/s; ratio {img_s / p5:.4f} (band ±{THROUGHPUT_BAND})  [{name}]",
          flush=True)
    check(abs(img_s / p5 - 1) <= THROUGHPUT_BAND,
          f"throughput {img_s} img/s is not within {THROUGHPUT_BAND} of phase 5's {p5}")
    op_dispatch_cost(mods["mixer_block"], mixer, name)
    del mixer
    torch.cuda.empty_cache()
    print(f"[11] phase 11 in {time.perf_counter() - t_phase:.1f} s", flush=True)



# Phase 12: the training recipes (train_recipes) on both Mixer-B/16 routes,
# a BatchNorm family under the recipe, probes, FLOPs, and the train
# example's folder data, metrics and checkpoints.
RECIPE_BATCH = 128
RECIPE_STEPS = 3  # timed recipe steps a path, after one warm-up step
RECIPE_LR = dict(base_lr=1e-3, total_steps=40, warmup_steps=2)  # a warmup-cosine AdamW
# 12a: the device EMA against its recurrence recomputed on the CPU in float32,
# elementwise, in float32 ulps of the CPU value (a fused multiply-add on one
# side and not the other differs by one ulp a step)
EMA_ULPS = 4
PROBE_BAND = 1e-3  # 12c: card f32 probes vs CPU f32, of each tag's max|ref|
EXAMPLE_IMAGES, EXAMPLE_HW = 40, (72, 80)  # 12e: the example's folder


def recipe_path_launches(mods, path):
    """12a: the launches a recipe step runs on ``path``: 12 of each of the
    route's kernels (the forward kernel on the recompute route, the four
    training kernels on the kernel route), none on the plain path."""
    kernel, recompute = path == "kernel route", path == "recompute route"
    want = {k: DEPTH if kernel else 0 for k in TRAIN_KERNELS}
    want["fused_mixer_block"] = DEPTH if recompute else 0
    got = {k: mods["mixer_block_bwd"].LAUNCHES[k] for k in TRAIN_KERNELS}
    got["fused_mixer_block"] = mods["mixer_block"].LAUNCHES
    return got, want


def ema_ulps(ema, host):
    """Largest |ema − host| over the tensors, in float32 ulps of |host|."""
    eps = torch.finfo(torch.float32).eps
    return max(((ema[k].cpu() - v).abs() / (v.abs() * eps).clamp_min(1e-30)).max().item()
               for k, v in host.items())


def recipe_turns(model, opt, recipe, schedule, batch, gen, step, state):
    """12a: ms a step, in turns (each variant twice, RECIPE_STEPS timed
    steps after one warm-up), of make_train_step, the recipe step, and the
    recipe step with its EMA off and with its mix and EMA off, on the same
    model and optimizer; the recipe steps carry one state. Returns
    {variant: [ms, ms], "state": the state after}."""
    from dataclasses import replace

    from jittor_mlp_tpu_torch import train_recipes as tr
    from jittor_mlp_tpu_torch.parallel import make_train_step

    holder = [state]

    def recipe_run(r):
        fn = step if r is recipe else tr.make_recipe_train_step(
            model, opt, 1000, r, compute_dtype=torch.bfloat16, lr_schedule=schedule)

        def run():
            holder[0], _ = fn(holder[0], batch, gen)

        return run

    plain = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    variants = {"make_train_step": lambda: plain(batch, gen),
                "recipe": recipe_run(recipe),
                "recipe, EMA off": recipe_run(replace(recipe, ema_decay=0.0)),
                "recipe, mix and EMA off": recipe_run(replace(recipe, mixup_alpha=0.0,
                                                              cutmix_alpha=0.0, ema_decay=0.0))}
    times = {k: [] for k in variants}
    for k in list(variants) + list(variants)[::-1]:
        times[k].append(cuda_ms(variants[k], RECIPE_STEPS, warmup=1))
    times["state"] = holder[0]
    return times


def recipe_routes(jt, mods, name):
    """12a: the recipe step on Mixer-B/16 @224, b128 bf16 (mixup 0.8, cutmix
    1.0, smoothing 0.1, EMA 0.9999, warmup-cosine AdamW), on the kernel
    route, the recompute route and the plain bf16 path from the same
    weights and generator seed: gradients, launches, f32 state, the EMA's
    recurrence, each update's lr, ms in turns with make_train_step
    (``recipe_turns``); then the mix's and the EMA's ms alone.
    Returns the first kernel-route and recompute-route steps' launches."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch import train_recipes as tr

    recipe = tr.Recipe(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, ema_decay=0.9999)
    schedule = tr.make_lr_schedule(**RECIPE_LR)
    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(RECIPE_BATCH, 13)
    paths = {"kernel route": (True, True), "recompute route": (True, False),
             "plain bf16 path": (False, False)}
    grads, counted, step_ms = {}, {}, {}
    for path, (use_pallas, pallas_bwd) in paths.items():
        model.load_state_dict(init)
        model.use_pallas, config.pallas_bwd = use_pallas, pallas_bwd
        opt = torch.optim.AdamW(model.parameters(), lr=RECIPE_LR["base_lr"], weight_decay=0.05)
        state = tr.init_recipe_state(model, opt, recipe=recipe)
        step = tr.make_recipe_train_step(model, opt, 1000, recipe, compute_dtype=torch.bfloat16,
                                         lr_schedule=schedule)
        gen = torch.Generator(device="cuda").manual_seed(0)
        host = {k: v.cpu() for k, v in state.ema.items()}
        lrs, worst = [], 0.0
        for k in range(2):  # checked steps: update 0 at lr 0, update 1 at half the peak
            if k == 0:
                reset_counts(mods)  # the recipe step's run starts here
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            if k == 0:
                got, want = recipe_path_launches(mods, path)
                check(got == want, f"[12a] {path}: launches {got}, want {want}")
                counted[path] = got
                grads[path] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                loss0 = metrics["loss"].item()
            lrs.append(opt.param_groups[0]["lr"])
            params = {n: p.detach().cpu() for n, p in model.named_parameters()}
            tr.ema_update(host, params, recipe.ema_decay)
            worst = max(worst, ema_ulps(state.ema, host))
        f32 = (all(p.dtype == torch.float32 for p in model.parameters())
               and all(v.dtype == torch.float32 for v in state.ema.values())
               and all(t.dtype == torch.float32 for s_ in opt.state.values()
                       for t in s_.values() if t.is_floating_point())
               and all(p.grad.dtype == torch.float32 for p in model.parameters()))
        lag = max((state.ema[n] - p).abs().max().item() for n, p in model.named_parameters())
        step_ms[path] = recipe_turns(model, opt, recipe, schedule, batch, gen, step, state)
        state = step_ms[path].pop("state")
        lrs.append(opt.param_groups[0]["lr"])
        want_lrs = [schedule(0), schedule(1), schedule(state.step - 1)]
        print(f"[12a] {path}: launches of the first step {json.dumps(counted[path])}; loss "
              f"{loss0:.6f}, {state.step} steps; masters, EMA, Adam state and gradients f32: "
              f"{f32}; EMA vs its recurrence on the CPU (f32) {worst:.3g} ulps (limit "
              f"{EMA_ULPS}), max|EMA - params| {lag:.3g}; lr of updates 0, 1, "
              f"{state.step - 1}: {lrs} (schedule {want_lrs})", flush=True)
        check(f32, f"[12a] {path}: the masters, EMA or optimizer state left float32")
        check(worst <= EMA_ULPS, f"[12a] {path}: the EMA is {worst} ulps off its recurrence")
        check(lrs == want_lrs, f"[12a] {path}: lrs {lrs}, schedule {want_lrs}")
        check(np.isfinite(loss0), f"[12a] {path}: loss {loss0}")
    model.use_pallas, config.pallas_bwd = True, False
    errs = {"kernel route vs recompute route":
            (rel_l2(grads["kernel route"], grads["recompute route"]), GRAD_ROUTES)}
    for path in ("kernel route", "recompute route"):
        errs[f"{path} vs plain bf16 path"] = (rel_l2(grads[path], grads["plain bf16 path"]),
                                              GRAD_PLAIN)
    for tag, (err, lim) in errs.items():
        print(f"[12a] recipe step gradients, {tag}: global relative L2 {err:.6g} (limit {lim})",
              flush=True)
        check(err <= lim, f"[12a] recipe gradients {tag}: {err} > {lim}")
    for path, times in step_ms.items():
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        base, recipe_ms = TRAIN_IMG_S[path], ms["recipe"]
        img_s = RECIPE_BATCH * 1e3 / recipe_ms
        print(f"[12a] Mixer-B/16 b{RECIPE_BATCH} bf16 recipe step, {path}: {recipe_ms:.4f} ms, "
              f"{img_s:.1f} img/s; phase 6f make_train_step {base:.1f} img/s (ratio "
              f"{img_s / base:.4f})  [{name}]", flush=True)
        print(f"[12a] {path}, in turns, ms a step: " + "; ".join(
            f"{k} {v:.4f} ({v / ms['make_train_step']:.4f} of make_train_step)"
            for k, v in ms.items()) + f" (runs {json.dumps(times)})", flush=True)
    step_ms = {p: sum(t["recipe"]) / len(t["recipe"]) for p, t in step_ms.items()}
    # the recipe's own work on the card: smoothing and the mix, and the EMA
    shape = (RECIPE_BATCH, 224, 224)
    draws = {"mixup": tr.draws_from(False, np.float32(0.7), np.float32(0.7), 112, 112, shape,
                                    0.8, 1.0),
             "cutmix": tr.draws_from(True, np.float32(0.7), np.float32(0.7), 112, 112, shape,
                                     0.8, 1.0)}
    parts = {f"smooth + {k}": cuda_ms(lambda d=d: tr.mix(
        batch["image"], tr.smooth_labels(batch["label"], 1000, 0.1), d), 10)
        for k, d in draws.items()}
    params = dict(model.named_parameters())
    parts["ema_update"] = cuda_ms(lambda: tr.ema_update(state.ema, params, 0.9999), 10)
    t0 = time.perf_counter()
    for k in range(100):
        tr.mix_draws(tr.mix_generator(gen, k), *shape)
    host_ms = (time.perf_counter() - t0) * 10
    for part, ms in parts.items():
        shares = ", ".join(f"{ms / t:.4f} of the {p} step" for p, t in step_ms.items())
        print(f"[12a] {part}: {ms:.4f} ms ({shares})  [{name}]", flush=True)
    print(f"[12a] mix draws on the host (seeding, five uniforms, betaincinv): {host_ms:.4f} ms",
          flush=True)
    del model, state, grads
    return {"fused_mixer_block": counted["recompute route"]["fused_mixer_block"],
            **{k: counted["kernel route"][k] for k in TRAIN_KERNELS}}


def recipe_bn(jt, batch_size=64):
    """12b: ConvMLP-M at b64 bf16 under the recipe: one step moves every
    running statistic with the default bn_momentum, none with None."""
    from jittor_mlp_tpu_torch import train_recipes as tr

    recipe = tr.Recipe(ema_decay=0.9999)
    batch = train_batch(batch_size, 14)
    init = None
    for momentum in (0.1, None):
        model = jt.convmlp_m()
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
        step = tr.make_recipe_train_step(model, opt, 1000, recipe, compute_dtype=torch.bfloat16,
                                         bn_momentum=momentum)
        _, metrics = step(tr.init_recipe_state(model, opt, recipe=recipe), batch,
                          torch.Generator(device="cuda").manual_seed(0))
        stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
        moved = sum(not torch.equal(model.state_dict()[k], init[k]) for k in stats)
        loss = metrics["loss"].item()
        print(f"[12b] ConvMLP-M b{batch_size} bf16 recipe step, bn_momentum {momentum}: loss "
              f"{loss:.6f}; running statistics moved {moved} of {len(stats)}", flush=True)
        check(np.isfinite(loss) and stats, f"[12b] loss {loss}, {len(stats)} statistics")
        check(moved == (len(stats) if momentum else 0),
              f"[12b] bn_momentum {momentum}: {moved} of {len(stats)} statistics moved")
        del model, opt, step


def recipe_probes(jt, mods, batch_size=8):
    """12c: ``utils.probes.capture`` on AS-MLP-T at b8: the card's f32 (TF32
    off) and bf16 values at each tag against the CPU's f32."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.utils.probes import capture

    x = images(batch_size, 15)
    cpu = jt.AS_MLP(**AS_MLP_T, device="cpu")
    with config.parity_mode():
        t0 = time.perf_counter()
        _, ref = capture(cpu, x.cpu())
        cpu_s = time.perf_counter() - t0
    model = jt.AS_MLP(**AS_MLP_T)
    sk = mods["axial_shift"]
    before = sk.LAUNCHES
    with config.parity_mode():
        _, f32 = capture(model, x)
    _, bf16 = capture(model.to_bf16(), x.bfloat16())
    torch.cuda.synchronize()
    tags = [t for t, _ in ref]
    check([t for t, _ in f32] == [t for t, _ in bf16] == tags
          == ["patch_embed", "stage0", "stage1", "stage2", "stage3"], f"[12c] tags {tags}")
    check(sk.LAUNCHES - before == 2 * SHIFTS, f"[12c] {sk.LAUNCHES - before} shift launches")
    for (tag, r), (_, a), (_, b) in zip(ref, f32, bf16):
        check(a.is_cuda and b.is_cuda and b.dtype == torch.bfloat16,
              f"[12c] {tag}: {a.device} {b.dtype}")
        dev_f32 = rel_dev(a.float().cpu(), r)
        dev_bf16 = rel_dev(b.float().cpu(), r)
        print(f"[12c] AS-MLP-T b{batch_size} probe {tag} {tuple(r.shape)}: card f32 vs CPU "
              f"{dev_f32:.3g} (limit {PROBE_BAND}), card bf16 vs CPU f32 {dev_bf16:.4g} of "
              f"max|ref| {r.abs().max().item():.4g}", flush=True)
        check(dev_f32 <= PROBE_BAND, f"[12c] {tag}: card f32 {dev_f32}")
    print(f"[12c] the CPU capture took {cpu_s:.2f} s; the card's two forwards launched the "
          f"shift {2 * SHIFTS} times", flush=True)
    del cpu, model


def recipe_flops(jt):
    """12d: ``Model.flops`` at (1, 3, 224, 224) on the CPU in f32 and on the
    card in f32 and after to_bf16(), for Mixer-B/16, AS-MLP-T and GFNet."""
    for tag, build in (("Mixer-B/16", lambda: jt.MLPMixerForImageClassification(
            **MIXER_B16, device="cpu")), ("AS-MLP-T", lambda: jt.AS_MLP(**AS_MLP_T, device="cpu")),
            ("GFNet", lambda: jt.GFNet(device="cpu"))):
        model = build()
        counts = {"CPU f32": model.flops()}
        model.place("cuda")
        counts["card f32"] = model.flops()
        counts["card bf16"] = model.to_bf16().flops()
        print(f"[12d] {tag} flops: " + ", ".join(f"{k} {v:.0f} ({v / 1e9:.4f} GFLOPs)"
                                                  for k, v in counts.items()), flush=True)
        check(len(set(counts.values())) == 1 and counts["CPU f32"] > 0,
              f"[12d] {tag}: counts differ: {counts}")
        del model


def recipe_example(mods):
    """12e: ``examples.train.main`` with --data-dir, --mixed-precision,
    --metrics and --ckpt-dir on a seeded PNG folder: 4 steps straight, and 2
    steps then a resume of 2; the losses, the parameters, the metrics lines
    and the checkpoints kept."""
    import os
    import tempfile

    from jittor_mlp_tpu_torch.examples import train as train_ex
    from jittor_mlp_tpu_torch.utils.metrics import read_metrics

    mb = mods["mixer_block"]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "folder")
        write_folder(root, seed=1, n=EXAMPLE_IMAGES, hw=EXAMPLE_HW)

        def run(tag, steps):
            return train_ex.main(["--data-dir", root, "--image-size", "64", "--batch", "8",
                                  "--steps", str(steps), "--mixed-precision",
                                  "--metrics", os.path.join(tmp, tag, "m.jsonl"),
                                  "--ckpt-dir", os.path.join(tmp, tag, "ckpt"),
                                  "--ckpt-every", "1"])

        before = mb.LAUNCHES
        t0 = time.perf_counter()
        whole, losses = run("whole", 4)
        _, first = run("resumed", 2)
        resumed, rest = run("resumed", 4)
        secs = time.perf_counter() - t0
        n = mb.LAUNCHES - before
        delta = max((a.float() - b.float()).abs().max().item() for a, b in
                    zip(whole.state_dict().values(), resumed.state_dict().values()))
        top = max(v.float().abs().max().item() for v in whole.state_dict().values())
        print(f"[12e] examples/train.py on {EXAMPLE_IMAGES} PNGs of {EXAMPLE_HW[0]}x"
              f"{EXAMPLE_HW[1]}, Mixer (patch 8, d_model 128, depth 6) @64 b8 bf16: 4 steps "
              f"{losses}; 2 steps {first} + resumed 2 {rest}; max|param straight - resumed| "
              f"{delta:.3g} ({'bit-equal' if delta == 0 else 'not bit-equal'}; max|param| "
              f"{top:.3g}); {n} fused_mixer_block launches (6 a step); {secs:.1f} s", flush=True)
        check(delta <= 1e-3 * top and n == 6 * 8, f"[12e] params {delta}, launches {n}")
        for tag in ("whole", "resumed"):
            steps = read_metrics(os.path.join(tmp, tag, "m.jsonl"))["step"]
            kept = sorted(os.listdir(os.path.join(tmp, tag, "ckpt")))
            print(f"[12e] {tag}: metrics steps {steps}; checkpoints {kept}", flush=True)
            check(steps == [0, 1, 2, 3], f"[12e] {tag}: metrics steps {steps}")
            check(kept == ["step_00000003", "step_00000004"], f"[12e] {tag}: {kept}")
        del whole, resumed


def phase_recipes(jt, mods, name):
    """Phase 12; returns the recipe steps' launches of the Mixer's kernels."""
    t0 = time.perf_counter()
    counted = recipe_routes(jt, mods, name)
    torch.cuda.empty_cache()
    recipe_bn(jt)
    torch.cuda.empty_cache()
    recipe_probes(jt, mods)
    torch.cuda.empty_cache()
    recipe_flops(jt)
    torch.cuda.empty_cache()
    recipe_example(mods)
    print(f"[12] phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    return counted

PP_BATCH = 128
PP_MICROBATCHES = 4
PP_LOSS = 1e-2  # 13b: pipelined vs dense loss, relative
SP_BATCH = 256
SP_BF16, SP_TOP1, SP_F32 = 5e-2, 0.9, 1e-3  # 13c: of the dense f32 forward's max|logit|
PARALLEL_ITERS = 3  # 13b: timed steps a turn, after two warm-up steps


def one_rank_world():
    """13: a one-rank NCCL process group on card 0 (a HashStore: no port)
    and its ('data', 'model') mesh of 1 × 1."""
    import torch.distributed as dist

    from jittor_mlp_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_mesh()
    print(f"[13] world: {dist.get_world_size()} rank, backend {dist.get_backend()}, mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on {mesh.device_type}", flush=True)
    return mesh


def params_of(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def bit_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)


def parallel_dp(jt, mesh):
    """13a: one kernel-route AdamW step of Mixer-B/16 at b128 bf16 through
    make_train_step with the mesh and without, from one state: loss and
    parameters bit-equal."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import init_sharded, make_train_step

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(PP_BATCH, 17)
    config.pallas_bwd = True
    out = {}
    for tag, kw in (("without", {}), ("mesh", {"mesh": mesh})):
        model.load_state_dict(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
        if kw:
            init_sharded(model, opt, mesh)
        loss = make_train_step(model, opt, compute_dtype=torch.bfloat16, **kw)(batch)
        out[tag] = (loss.clone(), params_of(model))
    config.pallas_bwd = False
    equal = torch.equal(out["mesh"][0], out["without"][0]) and bit_equal(out["mesh"][1],
                                                                          out["without"][1])
    print(f"[13a] Mixer-B/16 b{PP_BATCH} bf16 kernel-route AdamW step, make_train_step(mesh=) "
          f"vs without: loss {out['mesh'][0].item():.6f} vs {out['without'][0].item():.6f}; "
          f"loss and {len(out['mesh'][1])} parameters bit-equal: {equal}", flush=True)
    check(equal, "[13a] the mesh step differs from the step without a mesh")


def _issue_wall_busy(fn, steps):
    """(host issue ms, wall ms, card busy ms) a step of ``fn`` over
    ``steps`` steps: the issue time runs to the last launch without waiting
    for the card, the wall time to a synchronize, and the busy time is the
    sum of the kernels' device times under ``torch.profiler``. A step whose
    issue time reaches its wall time is bound by the host."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    issue = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / steps
    return issue, wall, busy


def parallel_pipeline(jt, mods, mesh, name):
    """13b: the GPipe runner against the dense model on the kernel route:
    loss and gradients, the pipelined step's launches, img/s in turns.
    Returns the pipelined step's launches of the training kernels."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.core import nnf
    from jittor_mlp_tpu_torch.parallel import (init_sharded, loss_fn, make_train_step,
                                               pipeline_runner, pipeline_shardings)
    from jittor_mlp_tpu_torch.parallel.train import reduce_gradients

    runner = pipeline_runner(mesh, microbatches=PP_MICROBATCHES, data_axis="data")
    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    batch = train_batch(PP_BATCH, 19)
    config.pallas_bwd = True
    dense_loss, dense_grads = grads_of(model, batch, torch.bfloat16)
    with nnf.block_runner_scope(runner):
        pp_loss, pp_grads = grads_of(model, batch, torch.bfloat16)
        stages = pipeline_shardings(model, mesh, (1, 3, 224, 224))
    loss_rel = abs(pp_loss - dense_loss) / abs(dense_loss)
    grad_rel = rel_l2(pp_grads, dense_grads)
    print(f"[13b] Mixer-B/16 b{PP_BATCH} bf16 kernel route, pipeline of 1 stage x "
          f"{PP_MICROBATCHES} microbatches vs dense: loss {pp_loss:.6f} vs {dense_loss:.6f} "
          f"(relative {loss_rel:.3g}, limit {PP_LOSS}); gradients' global relative L2 "
          f"{grad_rel:.6g} (limit {GRAD_PLAIN})", flush=True)
    check(loss_rel <= PP_LOSS and grad_rel <= GRAD_PLAIN,
          f"[13b] pipelined vs dense: loss {loss_rel}, gradients {grad_rel}")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    init_sharded(model, opt, mesh, stages=stages)
    owned = sum(v is not None for v in stages.values())
    pp_step = make_train_step(model, opt, compute_dtype=torch.bfloat16, mesh=mesh)
    dense_step = make_train_step(model, opt, compute_dtype=torch.bfloat16)

    def piped():
        with nnf.block_runner_scope(runner):
            return pp_step(batch)

    bwd = mods["mixer_block_bwd"]
    reset_counts(mods)  # the pipelined step's run starts here
    loss = piped()
    torch.cuda.synchronize()
    counted = {k: bwd.LAUNCHES[k] for k in TRAIN_KERNELS}
    want = dict.fromkeys(TRAIN_KERNELS, DEPTH * PP_MICROBATCHES)
    print(f"[13b] pipelined make_train_step(mesh=): loss {loss.item():.6f}; {owned} block "
          f"tensors placed on stage 0; launches {json.dumps(counted)} (want "
          f"{json.dumps(want)})", flush=True)
    check(counted == want and bool(torch.isfinite(loss)),
          f"[13b] pipelined step launches {counted}, want {want}; loss {loss.item()}")
    mesh_step = make_train_step(model, opt, compute_dtype=torch.bfloat16, mesh=mesh)
    variants = {"dense": lambda: dense_step(batch), "mesh, no runner": lambda: mesh_step(batch),
                "pipelined": piped}
    ms, runs = _timed_turns(variants, PARALLEL_ITERS)
    print(f"[13b] Mixer-B/16 b{PP_BATCH} bf16 kernel-route train step, in turns, ms (img/s, "
          f"share of dense): " + "; ".join(
              f"{k} {v:.4f} ({PP_BATCH * 1e3 / v:.1f}, {ms['dense'] / v:.4f})"
              for k, v in ms.items()) + f" (pipelined: 1 stage x {PP_MICROBATCHES}; runs "
          f"{json.dumps(runs)})  [{name}]", flush=True)
    for k, fn in variants.items():
        issue, wall, busy = _issue_wall_busy(fn, PARALLEL_ITERS)
        print(f"[13b] {k} step: host issue {issue:.3f} ms, wall {wall:.3f} ms, card busy "
              f"{busy:.3f} ms ({busy / wall:.1%} of the wall), mean of {PARALLEL_ITERS}  "
              f"[{name}]", flush=True)
    model.zero_grad(set_to_none=True)
    with nnf.block_runner_scope(runner):
        loss_fn(model, batch, torch.bfloat16).backward()
    n_grads = sum(p.grad is not None for p in model.parameters())
    host = []
    for _ in range(PARALLEL_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(model, mesh)  # the gradients become their mean: 1 rank, unchanged
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    config.pallas_bwd = False
    print(f"[13b] reduce_gradients of the pipelined model's {n_grads} gradients: host "
          f"{', '.join(f'{v:.3f}' for v in host)} ms  [{name}]", flush=True)
    return counted


def parallel_tokens(jt, mesh):
    """13c: token_parallel_runner on Mixer-B/16 and ResMLP-S24 at b256,
    bf16 and f32, against the dense f32 forward."""
    from jittor_mlp_tpu_torch.parallel import token_parallel_runner

    x = images(SP_BATCH, 23)
    for label, factory, kw, family in (
            ("Mixer-B/16", jt.MLPMixerForImageClassification, MIXER_B16, "mlp_mixer"),
            ("ResMLP-S24", jt.ResMLPForImageClassification, RESMLP_S24, "res_mlp")):
        with torch.no_grad():
            ref = factory(**kw).eval().forward(x).float()
            sp = factory(**kw, block_runner=token_parallel_runner(mesh, family)).eval()
            f32 = sp.forward(x).float()
            bf16 = sp.to_bf16().forward(x.to(torch.bfloat16)).float()
        torch.cuda.synchronize()
        for tag, got, lim, lim_top1 in (("f32", f32, SP_F32, None),
                                        ("bf16", bf16, SP_BF16, SP_TOP1)):
            rel = rel_dev(got, ref)
            top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
            print(f"[13c] {label} token-parallel {tag} vs dense f32, b{SP_BATCH}: "
                  f"max|dlogit|/max|logit| {rel:.6g} (limit {lim}), top-1 agreement "
                  f"{top1:.4f} (limit {lim_top1})", flush=True)
            check(bool(torch.isfinite(got).all()) and rel <= lim
                  and (lim_top1 is None or top1 >= lim_top1),
                  f"[13c] {label} {tag}: rel {rel}, top-1 {top1}")
        del sp


def parallel_shard_and_recipe(jt, mesh):
    """13d: Model.shard on the bf16 kernel path, and one kernel-route recipe
    step with mesh= (mixup, cutmix, EMA), each bit-equal to the call
    without the mesh."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch import train_recipes as tr

    model = jt.MLPMixerForImageClassification(**MIXER_B16).eval().to_bf16()
    x = images(64, 29)
    with torch.no_grad(), config.bf16_mode():
        want = model(x)
        got = model.shard(mesh)(x)
    model.mesh = None
    print(f"[13d] Mixer-B/16 b64 bf16 Model.shard(mesh) vs the model: logits bit-equal "
          f"{torch.equal(got, want)}", flush=True)
    check(torch.equal(got, want), "[13d] Model.shard changed the logits")
    del model
    recipe = tr.Recipe(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, ema_decay=0.9999)
    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(PP_BATCH, 31)
    config.pallas_bwd = True
    out = {}
    for tag, mesh_kw in (("without", None), ("mesh", mesh)):
        model.load_state_dict(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
        state = tr.init_recipe_state(model, opt, mesh=mesh_kw, recipe=recipe)
        step = tr.make_recipe_train_step(model, opt, 1000, recipe,
                                         compute_dtype=torch.bfloat16, mesh=mesh_kw)
        modes = []
        for k in range(2):
            state, metrics = step(state, batch, torch.Generator(device=model.device).manual_seed(3))
            modes.append(tr.mix_draws(tr.mix_generator(torch.Generator().manual_seed(3), k),
                                      PP_BATCH, 224, 224).cutmix)
        out[tag] = ({k: v.clone() for k, v in metrics.items()}, params_of(model),
                    {k: v.clone() for k, v in state.ema.items()})
    config.pallas_bwd = False
    (m0, p0, e0), (m1, p1, e1) = out["without"], out["mesh"]
    equal = bit_equal(m1, m0) and bit_equal(p1, p0) and bit_equal(e1, e0)
    print(f"[13d] Mixer-B/16 b{PP_BATCH} bf16 kernel-route recipe steps (modes "
          f"{['cutmix' if c else 'mixup' for c in modes]}), mesh= vs without: loss "
          f"{m1['loss'].item():.6f} vs {m0['loss'].item():.6f}; metrics, parameters and EMA "
          f"bit-equal: {equal}", flush=True)
    check(equal, "[13d] the recipe step on the mesh differs from the step without")


def phase_parallel(jt, mods, name):
    """Phase 13; returns the pipelined step's launches of the training
    kernels."""
    import torch.distributed as dist

    from jittor_mlp_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    mesh = one_rank_world()
    try:
        parallel_dp(jt, mesh)
        torch.cuda.empty_cache()
        counted = parallel_pipeline(jt, mods, mesh, name)
        torch.cuda.empty_cache()
        parallel_tokens(jt, mesh)
        torch.cuda.empty_cache()
        parallel_shard_and_recipe(jt, mesh)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    res = multihost.run_local_selftest(num_processes=2, timeout=120)
    print(f"[13e] CPU check (two gloo processes on this machine's CPU, not the card): "
          f"run_local_selftest: {json.dumps(res)} in {time.perf_counter() - t1:.1f} s",
          flush=True)
    print(f"[13] phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)
    return counted


TP_BATCH = 256  # 14a: the split entry at the timed batch of phase 5
TP_RANKS = (2, 4)
TP_SHARD_BATCH = 64  # 14b: Model.shard forwards
TP_TRAIN_BATCH = 32  # 14b: train steps
TP_STEPS = 2
TP_F32_LOGITS = 1e-4  # 14b: of the unsharded f32 forward's max|logit| on this card
TP_BF16_LOGITS, TP_BF16_TOP1 = 5e-2, 0.99  # 14b: bf16 TP vs the unsharded bf16 forward
TP_F32_LOSS, TP_F32_PARAMS = 1e-5, 1e-4  # 14b: f32 steps, relative (params: of each tensor's max)
TP_F32_GRADS = 1e-4  # 14b: the first f32 step's gradients, relative L2 (grad_dev)
# 14b: bf16 recompute-route steps vs the dense bf16 steps: the losses (relative), the first
# step's gradients (relative L2 in all, and in each tensor) and the parameters (of max(1,
# max|w|)); AdamW moves a weight by about lr a step whatever its gradient, so the gradient
# bands are the ones a wrong split backward fails
TP_BF16_LOSS, TP_BF16_GRADS, TP_BF16_PARAMS = 1e-4, (1e-2, 3e-2), 2e-4
# 14b: AdamW's eps 1e-4, as the CPU tests take it: the token mix's output
# bias has a zero gradient in exact arithmetic, which f32 leaves at noise in
# an order that differs between the split and the whole sums; eps 1e-8 would
# turn that noise into ±lr steps
TP_ADAMW = dict(lr=1e-4, weight_decay=1e-4, eps=1e-4)
TP_JOIN_S = 240  # 14b: the two ranks' time limit
TP_REPLACES = PALLAS + "mixer_block.py:157 (fused_mixer_block, its channel MLP split over ranks)"
FINISH_REPLACES = (PALLAS + "mixer_block.py:157 (fused_mixer_block's last bias and residual, "
                   "after the sum of the ranks' partials)")


def tp_slices(w, P):
    """Each of P ranks' twelve block weights: Wc1 and bc1 cut on the hidden
    axis, Wc2 on its input axis (contiguous), the rest whole."""
    out = []
    for r in range(P):
        wr = list(w)
        wr[8], wr[9] = w[8].chunk(P, 0)[r].contiguous(), w[9].chunk(P, 0)[r].contiguous()
        wr[10] = w[10].chunk(P, 1)[r].contiguous()
        out.append(wr)
    return out


def tp_split_block(x, slices, plain=False):
    """The split block in one process: ``tensor.split_mixer_block`` on rank
    0's slice, its reduce adding the other ranks' f32 partials (their split
    entries, or with ``plain`` the plain split's) in rank order."""
    from jittor_mlp_tpu_torch.ops.kernels import mixer_block as mb
    from jittor_mlp_tpu_torch.parallel import tensor

    partial = mb.mixer_block_plain_partial if plain else mb.PARTIAL_OP
    others = [partial(x, *wr[:-1])[1] for wr in slices[1:]]

    def reduce(p):
        for q in others:
            p = p + q
        return p

    return tensor.split_mixer_block(x, slices[0], reduce, plain=plain)


def tp_entry_routes(mb):
    """14a at the forward's route cases (MIXER_ROUTE_SHAPES), rank 0's slice
    at P = 2: the split entry's h and f32 partial against its twin within
    TOL of max(1, max|ref|), two calls bit-equal, its four products a call on
    the cores ROUTED gives at CD_r. Returns the largest max|Δ|."""
    worst = 0.0
    for shape in MIXER_ROUTE_SHAPES:
        x, w = block_inputs(*shape, seed=sum(shape))
        wr = tp_slices(w, 2)[0][:-1]
        before = mb.routes()
        h, p = mb.PARTIAL_OP(x, *wr)
        h2, p2 = mb.PARTIAL_OP(x, *wr)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in mb.routes().items()}
        want = {k: 2 * v for k, v in ROUTED["fused_mixer_block"](
            (*shape[:4], wr[8].shape[0])).items()}
        h_ref, p_ref = mb.mixer_block_partial_ref(x, *wr)
        rels = [(a.float() - b.float()).abs().max().item() / max(1.0, b.float().abs().max().item())
                for a, b in ((h, h_ref), (p, p_ref))]
        worst = max(worst, (h.float() - h_ref.float()).abs().max().item(),
                    (p - p_ref).abs().max().item())
        same = torch.equal(h, h2) and torch.equal(p, p2)
        print(f"[14a] split entry at {shape}, rank 0 of P = 2: h, partial vs twin max|d|/max(1,"
              f"max|ref|) {rels[0]:.6g} {rels[1]:.6g} (limit {TOL}); two calls bit-equal {same}; "
              f"products of two calls {json.dumps(moved)} (want {json.dumps(want)})", flush=True)
        check(max(rels) <= TOL and same and moved == want,
              f"[14a] split entry at {shape}: {rels}, bit-equal {same}, products {moved}")
    return worst


def tp_kernels(mods, name):
    """14a: the split entry at the forward's route cases (``tp_entry_routes``);
    the split entry and the finishing pass at Mixer-B/16's block shape, b256
    bf16, in one process: P = 2 and 4 ranks' partials summed in rank order
    against row 1's whole kernel and the plain split block; two calls
    bit-equal; every product on the wgmma core; ms per rank beside row 1's.
    Returns ({row: max_abs_err}, {row: timing})."""
    mb = mods["mixer_block"]
    errs = {"fused_mixer_block_tp": tp_entry_routes(mb), "mixer_block_tp_finish": 0.0}
    shape = (TP_BATCH, 196, MIXER_B16["d_model"], MIXER_B16["token_dim"],
             4 * MIXER_B16["d_model"])
    x, w = block_inputs(*shape, seed=0)
    whole = mb.fused_mixer_block(x, *w)
    per = BLOCK_PRODUCTS["mixer_block"][1]  # a split entry's products, as a whole launch's
    for P in TP_RANKS:
        slices = tp_slices(w, P)
        before = mb.routes()
        got = tp_split_block(x, slices)
        again = tp_split_block(x, slices)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in mb.routes().items()}
        plain = tp_split_block(x, slices, plain=True)
        # the entry and the pass against their direct twins, rank 0's slice
        h, p = mb.PARTIAL_OP(x, *slices[0][:-1])
        h_ref, p_ref = mb.mixer_block_partial_ref(x, *slices[0][:-1])
        fin = mb.FINISH_OP(h, p, w[-1])
        fin_ref = mb.mixer_block_finish_ref(h, p, w[-1])
        torch.cuda.synchronize()
        entry_err = max((h.float() - h_ref.float()).abs().max().item(),
                        (p - p_ref).abs().max().item())
        entry_lim = TOL * max(1.0, p_ref.abs().max().item())
        fin_err = (fin.float() - fin_ref.float()).abs().max().item()
        errs["fused_mixer_block_tp"] = max(errs["fused_mixer_block_tp"], entry_err)
        errs["mixer_block_tp_finish"] = max(errs["mixer_block_tp_finish"], fin_err)
        for ref_tag, ref in (("row 1's whole kernel", whole), ("the plain split block", plain)):
            err = (got.float() - ref.float()).abs().max().item()
            lim = TOL * max(1.0, ref.float().abs().max().item())
            print(f"[14a] Mixer-B/16 b{TP_BATCH} split over P = {P}, partials summed in rank "
                  f"order, vs {ref_tag}: max|d| {err:.6g} (limit {lim:.6g})", flush=True)
            check(err <= lim, f"[14a] P = {P} vs {ref_tag}: {err} > {lim}")
        print(f"[14a] P = {P}: two calls bit-equal {torch.equal(got, again)}; rank 0's entry vs "
              f"its twin max|d| {entry_err:.6g} (h and the f32 partial; limit {entry_lim:.6g}), "
              f"the finishing pass vs its twin {fin_err:.6g} (limit 0); products "
              f"{json.dumps(moved)} (want sm90 {2 * per * P}, wmma 0)", flush=True)
        check(torch.equal(got, again), f"[14a] P = {P}: two calls differ")
        check(entry_err <= entry_lim and fin_err == 0.0, f"[14a] P = {P}: entry {entry_err}, "
              f"finish {fin_err}")
        check(moved == {"sm90": 2 * per * P, "wmma": 0}, f"[14a] P = {P}: products {moved}")
        del got, again, plain, h, p, h_ref, p_ref, fin, fin_ref
    # times in turns: row 1 whole, each P's entry on one rank's slice, the pass
    fns = {"row 1 whole": lambda: mb.fused_mixer_block(x, *w)}
    slices = {P: tp_slices(w, P)[0] for P in TP_RANKS}
    for P in TP_RANKS:
        fns[f"entry P={P}"] = functools.partial(mb.PARTIAL_OP, x, *slices[P][:-1])
    h, p = mb.PARTIAL_OP(x, *slices[2][:-1])
    fns["finishing pass"] = lambda: mb.FINISH_OP(h, p, w[-1])
    ms, runs = _timed_turns(fns, 10)
    plain_entry = cuda_ms(lambda: mb.mixer_block_partial_ref(x, *slices[2][:-1]), 3)
    plain_fin = cuda_ms(lambda: mb.mixer_block_finish_ref(h, p, w[-1]), 5)
    B, N, D, TD, CD = shape
    CDr = CD // 2
    # least time: the entry's products (operations) or its bytes, whichever is more
    entry_flops = 4 * B * N * D * (TD + CDr)
    entry_bytes = (2 * B * N * D * 2 + 4 * B * N * D
                   + 2 * sum(t.numel() for t in slices[2][:-1]))
    entry_bound = max(entry_flops / PEAK["bf16"], entry_bytes / HBM_BYTES_S) * 1e3
    entry_by = "operations" if entry_flops / PEAK["bf16"] >= entry_bytes / HBM_BYTES_S else "bytes"
    fin_bytes = 2 * B * N * D * 2 + 4 * B * N * D + 2 * D
    fin_bound = fin_bytes / HBM_BYTES_S * 1e3
    print(f"[14a] Mixer-B/16 b{TP_BATCH} bf16, ms in turns (mean of 2 turns of 10): "
          + "; ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; the entry at P = 2 is {ms['entry P=2'] / ms['row 1 whole']:.4f} of row 1, "
          f"P = 4 {ms['entry P=4'] / ms['row 1 whole']:.4f}; twins: entry {plain_entry:.4f}, "
          f"pass {plain_fin:.4f}; bounds: entry at P = 2 {entry_bound:.4f} ({entry_by}), "
          f"pass {fin_bound:.4f} (bytes)  [{name}]", flush=True)
    timings = {"fused_mixer_block_tp": (ms["entry P=2"], plain_entry, entry_bound, entry_by),
               "mixer_block_tp_finish": (ms["finishing pass"], plain_fin, fin_bound, "bytes")}
    return errs, timings


def tp_rank(rank, port, out_path):
    """14b, one of the two ranks: a gloo world of two processes sharing card
    0, the 1 × 2 ('data', 'model') mesh; Model.shard forwards and
    make_train_step(mesh=) steps of Mixer-B/16 against the same calls on the
    dense model; writes what it measured to ``out_path`` (JSON)."""
    import datetime

    import torch.distributed as dist

    import jittor_mlp_tpu_torch as jt
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.ops.kernels import mixer_block as mb
    from jittor_mlp_tpu_torch.parallel import (gather_state_dict, init_sharded, make_mesh,
                                               make_train_step, tensor)

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(model_parallel=2, devices="cuda")
    out = {"rank": rank, "backend": dist.get_backend(), "device_type": mesh.device_type}
    base = jt.MLPMixerForImageClassification(**MIXER_B16).eval()
    x = images(TP_SHARD_BATCH, 41)

    def counts():
        return {"split_entry": mb.TP_LAUNCHES, "finish": mb.FINISH_LAUNCHES,
                "whole_kernel": mb.LAUNCHES, **tensor.COUNTS}

    def reset():
        mb.TP_LAUNCHES = mb.FINISH_LAUNCHES = mb.LAUNCHES = 0
        tensor.reset_counts()

    main_path = {"split_entry": 0, "finish": 0}
    # forwards: f32 (the plain split path) and bf16 (the split kernel entry)
    with torch.no_grad():
        dense32 = base(x).float()
        dense16 = copy.deepcopy(base).to_bf16()
        with config.bf16_mode():
            want16 = dense16(x).float()
        del dense16
        tp32 = copy.deepcopy(base).shard(mesh)
        reset()
        got32 = tp32(x).float()
        torch.cuda.synchronize()
        out["f32_counts"] = counts()
        del tp32
        tp16 = copy.deepcopy(base).to_bf16().shard(mesh)
        reset()
        with config.bf16_mode():
            got16 = tp16(x).float()
        torch.cuda.synchronize()
        out["bf16_counts"] = counts()
        for k in main_path:
            main_path[k] += out["bf16_counts"][k]
        out["placed"] = len(tp16.tp_specs)
        out["split_names"] = len(tp16.tp_split)
        del tp16
    out["f32_rel"] = rel_dev(got32, dense32)
    out["bf16_rel"] = rel_dev(got16, want16)
    out["bf16_top1"] = (got16.argmax(-1) == want16.argmax(-1)).float().mean().item()
    out["bf16_vs_f32_rel"] = rel_dev(got16, dense32)
    # train steps: dense, then TP, from the same weights and batches
    batches = [train_batch(TP_TRAIN_BATCH, 43 + s) for s in range(TP_STEPS)]
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        runs = {}
        for placed in (False, True):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            model = copy.deepcopy(base)
            opt = torch.optim.AdamW(model.parameters(), **TP_ADAMW)
            kw = {}
            if placed:
                init_sharded(model, opt, mesh)
                kw["mesh"] = mesh
            step = make_train_step(model, opt, compute_dtype=dtype, **kw)
            reset()
            losses, grads = [], None
            for b in batches:
                losses.append(step(b).item())
                if grads is None:  # the first step's gradients, from the same weights
                    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                             if p.grad is not None}  # on the host: out of the memory reading
            torch.cuda.synchronize()
            if placed:
                out[f"{tag}_step_counts"] = counts()
                for k in main_path:
                    main_path[k] += out[f"{tag}_step_counts"][k]
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated() - mem0  # parameters and AdamW state
            sd = gather_state_dict(model, mesh) if placed else model.state_dict()
            if placed:
                grads = tensor.gather_tp(grads, model.tp_specs, tensor.model_group(model))
            runs[placed] = (losses, {k: v.detach().clone() for k, v in sd.items()}, mem, grads)
            del model, opt, step, sd, grads
        (dl, dsd, dmem, dg), (tl, tsd, tmem, tg) = runs[False], runs[True]
        out[f"{tag}_loss"] = [dl, tl]
        out[f"{tag}_param_rel"] = max(
            (((tsd[k].float() - v.float()).abs().max()
              / v.float().abs().max().clamp_min(1e-12)).item(), k)
            for k, v in dsd.items() if v.is_floating_point())
        out[f"{tag}_param_abs"] = max(
            (((tsd[k].float() - v.float()).abs().max()
              / max(1.0, v.float().abs().max().item())).item(), k)
            for k, v in dsd.items() if v.is_floating_point())
        out[f"{tag}_grad"] = grad_dev(tg, dg)
        out[f"{tag}_mem"] = [dmem, tmem]
        del runs, dsd, tsd, dg, tg
        torch.cuda.empty_cache()
    out["main_path"] = main_path
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def grad_dev(got, want):
    """(global relative L2 of the gradients, [(relative L2, name, share of
    the global norm) of the three worst tensors]): a tensor's ||got - want||
    over ||want||, floored at 1e-2 of the global ||want|| (a tensor whose
    gradient is rounding alone, as the token-mix output bias's, which
    LayerNorm's removal of a per-token shift makes zero, is held to the
    floor)."""
    if set(got) != set(want):
        return float("inf"), [(float("inf"), f"names {sorted(set(got) ^ set(want))}", 0.0)]
    norm = sum((v.float() ** 2).sum().item() for v in want.values()) ** 0.5
    per = sorted((((got[k].float() - v.float()).norm().item()
                   / max(v.float().norm().item(), 1e-2 * norm)), k, v.float().norm().item() / norm)
                 for k, v in want.items())
    return rel_l2(got, want), per[::-1][:3]


def tp_two_ranks(name):
    """14b: two processes (this script with --tp-rank) in a gloo world on
    card 0; returns each rank's results."""
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "--tp-rank", str(r), str(port),
                                   paths[r]], env=env) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=TP_JOIN_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs),
              f"[14b] the two ranks exited {[p.returncode for p in procs]}")
        res = []
        for path in paths:
            with open(path) as f:
                res.append(json.load(f))
    return res


def tp_report(res, name):
    """14b's bands on each rank's results; returns the main path's launches
    of the split entry and the finishing pass, both ranks together."""
    depth = MIXER_B16["depth"]
    launches = {"fused_mixer_block_tp": 0, "mixer_block_tp_finish": 0}
    for r in res:
        tag = f"[14b] rank {r['rank']} ({r['backend']} on {r['device_type']})"
        check(r["backend"] == "gloo" and r["device_type"] == "cuda",
              f"{tag}: want a gloo world on the card")
        print(f"{tag}: gloo's all-reduce and all-gather took the CUDA tensors as they are "
              f"(no host staging in the port)", flush=True)
        print(f"{tag}: Model.shard(mesh) of Mixer-B/16 on the 1 x 2 mesh, {r['placed']} tensors "
              f"placed, {r['split_names']} split; b{TP_SHARD_BATCH} f32 vs the unsharded f32 "
              f"forward {r['f32_rel']:.6g} of max|logit| (limit {TP_F32_LOGITS}); bf16 vs the "
              f"unsharded bf16 forward {r['bf16_rel']:.6g} (limit {TP_BF16_LOGITS}), top-1 "
              f"{r['bf16_top1']:.4f} (limit {TP_BF16_TOP1}), vs f32 {r['bf16_vs_f32_rel']:.6g}; "
              f"counts f32 {json.dumps(r['f32_counts'])}, bf16 {json.dumps(r['bf16_counts'])}",
              flush=True)
        check(r["f32_rel"] <= TP_F32_LOGITS and r["bf16_rel"] <= TP_BF16_LOGITS
              and r["bf16_top1"] >= TP_BF16_TOP1, f"{tag}: logits out of band")
        want16 = {"split_entry": depth, "finish": depth, "whole_kernel": 0, "split": depth}
        want32 = {"split_entry": 0, "finish": 0, "whole_kernel": 0, "split": depth}
        check(r["bf16_counts"] == want16 and r["f32_counts"] == want32,
              f"{tag}: counts {r['bf16_counts']} (want {want16}), {r['f32_counts']} "
              f"(want {want32})")
        for dt in ("f32", "bf16"):
            (dl, tl), (rel, worst) = r[f"{dt}_loss"], r[f"{dt}_param_rel"]
            absolute, worst_abs = r[f"{dt}_param_abs"]
            g_all, g_top = r[f"{dt}_grad"]
            g_rel = g_top[0][0]
            loss_rel = max(abs(a - b) / abs(a) for a, b in zip(dl, tl))
            dmem, tmem = r[f"{dt}_mem"]
            print(f"{tag}: {TP_STEPS} {dt} AdamW steps of make_train_step(mesh=) at "
                  f"b{TP_TRAIN_BATCH} (recompute route) vs the dense steps: losses {tl} vs {dl} "
                  f"(relative {loss_rel:.6g}); the first step's gradients, gathered: relative "
                  f"L2 {g_all:.6g} in all; the worst tensors (relative L2, name, share of the "
                  f"norm) {json.dumps(g_top)}; "
                  f"parameters {rel:.6g} of each tensor's max (at most in {worst}), "
                  f"{absolute:.6g} of max(1, max|w|) (at most in {worst_abs}); "
                  f"parameters and AdamW state {tmem / 2 ** 20:.1f} MiB on this rank vs "
                  f"{dmem / 2 ** 20:.1f} MiB dense ({tmem / dmem:.4f}); counts "
                  f"{json.dumps(r[f'{dt}_step_counts'])}  [{name}]", flush=True)
            if dt == "f32":
                check(loss_rel <= TP_F32_LOSS and rel <= TP_F32_PARAMS
                      and max(g_all, g_rel) <= TP_F32_GRADS, f"{tag}: f32 steps: loss "
                      f"{loss_rel}, parameters {rel}, gradients {g_all} and {g_rel}")
            else:
                check(loss_rel <= TP_BF16_LOSS and g_all <= TP_BF16_GRADS[0]
                      and g_rel <= TP_BF16_GRADS[1] and absolute <= TP_BF16_PARAMS,
                      f"{tag}: bf16 steps: loss {loss_rel} (limit {TP_BF16_LOSS}), gradients "
                      f"{g_all} in all and {g_rel} in a tensor (limits {TP_BF16_GRADS}), "
                      f"parameters {absolute} (limit {TP_BF16_PARAMS})")
                want = {"split_entry": depth * TP_STEPS, "finish": depth * TP_STEPS,
                        "whole_kernel": 0, "split": depth * TP_STEPS}
                check(r["bf16_step_counts"] == want,
                      f"{tag}: bf16 step counts {r['bf16_step_counts']}, want {want}")
            check(tmem < 0.6 * dmem, f"{tag}: {dt} memory {tmem} vs dense {dmem}")
        launches["fused_mixer_block_tp"] += r["main_path"]["split_entry"]
        launches["mixer_block_tp_finish"] += r["main_path"]["finish"]
    return launches


def phase_tensor_parallel(jt, mods, name):
    """Phase 14; returns (errs, timings, launches) of its two kernel rows."""
    t0 = time.perf_counter()
    errs, timings = tp_kernels(mods, name)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches = tp_report(tp_two_ranks(name), name)
    print(f"[14] phase 14 in {time.perf_counter() - t0:.1f} s (14b {time.perf_counter() - t1:.1f} "
          f"s); main-path launches {json.dumps(launches)}", flush=True)
    return errs, timings, launches


# Phase 15: the harness layer on the card, through its entry points:
# tools/compare.main (as the sweeps call it), tools/gen_tuned, the committed
# tuned.SERVE row of S2-MLPv2 through Predictor, and examples/create_model.
HARNESS_ITERS = 3  # 15a: forwards a timed run (the sweep's 20, cut for time); train steps: 5
HARNESS_PREDICT = 16  # 15b: images through Predictor
GENERATOR_FIELDS = ("fps", "int8_fps", "bf16_argmax_agree", "int8_argmax_agree",
                    "int8_argmax_agree_vs_bf16")


def harness_record(compare, argv, path):
    """Run ``compare.main(argv + --json path)``; its exit code and the one
    record it appended."""
    before = len(compare_records(path))
    rc = compare.main([*argv, "--json", path])
    recs = compare_records(path)
    check(len(recs) == before + 1, f"[15] compare {argv} appended {len(recs) - before} records")
    return rc, recs[-1]


def compare_records(path):
    import os

    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def harness_mixer(mods, serving, train, name):
    """15a: compare's serving run on Mixer-B/16 (b256 bf16 and int8
    throughput, b64 serving numerics, b2 card-vs-CPU parity) and its train
    run at b32 with --try-remat. Returns the main path's launches."""
    from jittor_mlp_tpu_torch.tools import compare

    t0 = time.perf_counter()
    reset_counts(mods)
    libs = ("mixer_block", "mixer_block_int8")
    routes0 = {lib: mods[lib].routes() for lib in libs}
    rc, rec = harness_record(compare, ["--model", "mlp_mixer", "--batch", "256", "--iters",
                                       str(HARNESS_ITERS), "--int8", "--serving-numerics"],
                             serving)
    counted = {"fused_mixer_block": mods["mixer_block"].LAUNCHES,
               "fused_mixer_block_int8": mods["mixer_block_int8"].LAUNCHES}
    # a warm-up and 3 repeats of the timed run, and the numerics' forward: each path's
    # kernel once a block a forward (the parity forward is f32: no kernel)
    want = DEPTH * (2 + 3 * HARNESS_ITERS)
    print(f"[15a] compare --model mlp_mixer --batch 256 --int8 --serving-numerics: rc {rc}; "
          f"bf16 {rec['fps']:.1f} img/s, int8 {rec['int8_fps']:.1f} img/s; bf16 vs f32 "
          f"max {rec['bf16_max_rel']:.4g} of max|logit|, top-1 {rec['bf16_argmax_agree']:.4f}; "
          f"int8 vs f32 {rec['int8_max_rel']:.4g}, top-1 {rec['int8_argmax_agree']:.4f} (vs bf16 "
          f"{rec['int8_argmax_agree_vs_bf16']:.4f}); parity card f32 vs CPU max|d| "
          f"{rec['max_abs']:.4g} of max|logit| {rec['out_scale']:.4g} (limit "
          f"{compare.PARITY_BAND:g} of it); launches {json.dumps(counted)} (want {want} each); "
          f"{rec['card']}, {rec['power_limit']}  [{name}]", flush=True)
    check(rc == 0 and rec["parity_ok"], f"[15a] compare's serving run: rc {rc}, record {rec}")
    check(rec["max_abs"] <= CARD_VS_CPU * rec["out_scale"], f"[15a] parity {rec['max_abs']}")
    for k in GENERATOR_FIELDS:
        check(np.isfinite(rec[k]) and rec[k] > 0, f"[15a] {k} = {rec.get(k)}")
    check(counted == dict.fromkeys(counted, want), f"[15a] launches {counted}, want {want} each")
    for lib in libs:  # each launch's products on its wgmma core (TD = 784, D = 768)
        route, per = BLOCK_PRODUCTS[lib]
        check_routes(f"[15a] {lib}", routes0[lib], mods[lib].routes(), per * want, route=route)
    check(f"{rec['card']}, {rec['power_limit']}" == name, f"[15a] record names {rec['card']}")
    reset_counts(mods)
    rc, trec = harness_record(compare, ["--model", "mlp_mixer", "--train", "--try-remat",
                                        "--batch", "32", "--iters", str(2 * HARNESS_ITERS),
                                        "--skip-throughput", "--skip-parity"], train)
    steps = mods["mixer_block"].LAUNCHES
    print(f"[15a] compare --model mlp_mixer --train --try-remat --batch 32: rc {rc}; "
          f"{trec.get('train_fps', float('nan')):.1f} img/s, remat {trec.get('train_remat')}; "
          f"{steps} fused_mixer_block launches (the recompute route's forward kernel)"
          f"{'; ERROR ' + trec['train_error'] if 'train_error' in trec else ''}", flush=True)
    check(rc == 0 and np.isfinite(trec["train_fps"]) and trec["train_fps"] > 0
          and isinstance(trec["train_remat"], bool) and trec["train_batch"] == 32,
          f"[15a] compare's train run: rc {rc}, record {trec}")
    check(steps > 0, "[15a] the train steps launched no forward kernel")
    counted["fused_mixer_block"] += steps
    print(f"[15a] in {time.perf_counter() - t0:.1f} s", flush=True)
    return counted


def harness_s2(jt, serving, name):
    """15b: compare's serving run on S2-MLPv2 (seed 0): the rule's choice on
    this reading equals the committed SERVE row, and Predictor(S2MLPv2())
    resolves that dtype; its top-5 labels equal those of the forward in that
    dtype (f32: the parity forward's logits)."""
    from jittor_mlp_tpu_torch import config, tuned
    from jittor_mlp_tpu_torch.tools import compare, gen_tuned

    t0 = time.perf_counter()
    rc, rec = harness_record(compare, ["--model", "s2_mlp_v2", "--batch", "256", "--iters",
                                       str(HARNESS_ITERS), "--int8", "--serving-numerics",
                                       "--skip-parity"], serving)
    choice = gen_tuned.serve_row(rec)["dtype"]
    row = tuned.serve_settings("S2MLPv2")
    print(f"[15b] compare --model s2_mlp_v2: rc {rc}; bf16 vs f32 top-1 "
          f"{rec['bf16_argmax_agree']:.4f} (max {rec['bf16_max_rel']:.4g} of max|logit|), int8 "
          f"{rec['int8_fps'] / rec['fps']:.4f}x bf16 with top-1 {rec['int8_argmax_agree_vs_bf16']:.4f} "
          f"vs bf16: the rule gives {choice!r}; the committed SERVE row {row['dtype']!r} (its "
          f"bf16 top-1 {row['bf16_argmax']})  [{name}]", flush=True)
    check(rc == 0 and choice == row["dtype"], f"[15b] rule {choice} vs committed {row['dtype']}")
    x = images(HARNESS_PREDICT, seed=15)
    p = jt.Predictor(jt.S2MLPv2(), batch_size=HARNESS_PREDICT, preprocess=False)
    ref = jt.S2MLPv2().eval()
    mode = {"f32": config.parity_mode, "bf16": config.bf16_mode}[p.dtype]
    if p.dtype == "bf16":
        ref.to_bf16()
    with mode(), torch.inference_mode():  # parity_mode: TF32 off for both
        labels, _ = p.predict(x.cpu().numpy())
        # the Predictor's own ranking: top-5 of the float32 softmax of the logits
        want = torch.softmax(ref(x).float(), -1).topk(5, dim=-1).indices.cpu().numpy()
    same = np.array_equal(labels, want)
    print(f"[15b] Predictor(S2MLPv2()) resolves dtype {p.dtype!r}; top-5 labels on "
          f"{HARNESS_PREDICT} images equal the {p.dtype} forward's: {same}; in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(p.dtype == row["dtype"], f"[15b] Predictor serves {p.dtype}, the row {row['dtype']}")
    check(same, "[15b] Predictor's top-5 labels differ from the forward's")
    return rec


def harness_generator(serving, train, tmp):
    """15c: gen_tuned on 15a's and 15b's records writes a module that
    imports, whose rows are the rule's choices on those records."""
    import importlib.util

    from jittor_mlp_tpu_torch.tools import gen_tuned

    out = f"{tmp}/tuned_15c.py"
    check(gen_tuned.main(["--train", train, "--serving", serving, "--out", out]) == 0,
          "[15c] gen_tuned failed")
    spec = importlib.util.spec_from_file_location("tuned_15c", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    recs = compare_records(serving)
    (trec,) = compare_records(train)
    want = {r["model"]: gen_tuned.serve_row(r)["dtype"] for r in recs}
    got = {k: v["dtype"] for k, v in mod.SERVE.items()}
    print(f"[15c] gen_tuned on 15a's and 15b's records: SERVE {json.dumps(got)} (the rule: "
          f"{json.dumps(want)}), TRAIN mlp_mixer remat {mod.TRAIN['mlp_mixer']['remat']} at "
          f"b{mod.TRAIN['mlp_mixer']['batch']}", flush=True)
    check(got == want, f"[15c] SERVE {got} vs the rule {want}")
    check(mod.TRAIN["mlp_mixer"]["remat"] == trec["train_remat"]
          and mod.train_settings("MLPMixerForImageClassification") is mod.TRAIN["mlp_mixer"],
          f"[15c] TRAIN {mod.TRAIN}")


def harness_create_model():
    """15d: create_model --model MLPMixerForImageClassification --time."""
    import io
    import re

    from jittor_mlp_tpu_torch.examples import create_model

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = create_model.main(["--model", "MLPMixerForImageClassification", "--time"])
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[15d] {line}", flush=True)
    m = re.search(r"^MLPMixerForImageClassification\s+([\d,]+)\s+([\d.]+)\s+\((\d+), (\d+)\)"
                  r"\s+([\d.]+)$", out, re.M)
    check(rc == 0 and m is not None, f"[15d] create_model rc {rc}: {out}")
    params, shape, ms = int(m[1].replace(",", "")), (int(m[3]), int(m[4])), float(m[5])
    check(params > 0 and shape == (8, 1000) and ms > 0, f"[15d] row {m[0]}")


def phase_harness(jt, mods, name):
    """Phase 15; returns the harness runs' launches of the Mixer's kernels."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        serving, train = f"{tmp}/serving.jsonl", f"{tmp}/train.jsonl"
        counted = harness_mixer(mods, serving, train, name)
        torch.cuda.empty_cache()
        harness_s2(jt, serving, name)
        torch.cuda.empty_cache()
        harness_generator(serving, train, tmp)
    harness_create_model()
    torch.cuda.empty_cache()
    print(f"[15] phase 15 in {time.perf_counter() - t0:.1f} s; main-path launches "
          f"{json.dumps(counted)}", flush=True)
    return counted


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-rank":  # a rank of phase 14b
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a only")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' f32 matmuls
    name = card()
    print(f"[1] card: {name}", flush=True)

    import importlib

    import jittor_mlp_tpu_torch as jt

    mods = {m: importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{m}")
            for m in KERNEL_MODULES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda m: m.build(), mods.values()))
    print(f"[1] kernel builds + loads ({len(mods)} in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"[1] the blocks' GEMM core (gemm_sm90.cuh): {json.dumps(mods['gemm_sm90'].config())}",
          flush=True)

    table = kernel_table(mods)
    errs = phase_kernels(table)
    errs["axial_shift"] = phase_shift(mods["axial_shift"])
    errs.update(phase_lab(mods["kernel_lab"]))
    errs["gemm_tn_sm90"] = phase_gemm(mods["gemm_sm90"])
    errs.update(phase_core(mods["gemm_sm90"]))
    errs.update(phase_modes(mods["gemm_sm90"], mods["mixer_block_bwd"]))
    mixer, res, gmlp, as_mlp = phase_logits(jt, mods)
    launches = phase_serving(jt, mods, mixer, res, gmlp, as_mlp)
    del mixer, res, gmlp, as_mlp
    torch.cuda.empty_cache()
    timings = phase_timing(jt, table, name)
    timings["axial_shift"] = shift_timing(mods["axial_shift"], name)
    timings.update(lab_timing(mods["kernel_lab"], name))
    library = {}
    timings["gemm_tn_sm90"], library["gemm_tn_sm90"] = gemm_timing(mods["gemm_sm90"], name)
    for row, (timing, lib_ms) in core_timing(mods["gemm_sm90"], name).items():
        timings[row], library[row] = timing, lib_ms
    for row, (timing, lib_ms) in mode_timing(mods["gemm_sm90"], mods["mixer_block_bwd"],
                                             name).items():
        timings[row], library[row] = timing, lib_ms
    torch.cuda.empty_cache()
    launches.update(phase_train(jt, mods, name))
    torch.cuda.empty_cache()
    launches.update(phase_lab_stack(mods, name))
    torch.cuda.empty_cache()
    phase_families(jt, mods, name)
    torch.cuda.empty_cache()
    phase_dcn(mods, name)
    torch.cuda.empty_cache()
    phase_train_zoo(jt, mods, name)
    torch.cuda.empty_cache()
    phase_serving_layer(jt, mods, name)
    torch.cuda.empty_cache()
    for kname, n in phase_recipes(jt, mods, name).items():
        launches[kname] = launches.get(kname, 0) + n
    torch.cuda.empty_cache()
    for kname, n in phase_parallel(jt, mods, name).items():
        launches[kname] = launches.get(kname, 0) + n
    torch.cuda.empty_cache()
    tp_errs, tp_timings, tp_launches = phase_tensor_parallel(jt, mods, name)
    errs.update(tp_errs)
    timings.update(tp_timings)
    launches.update(tp_launches)
    torch.cuda.empty_cache()
    for kname, n in phase_harness(jt, mods, name).items():
        launches[kname] = launches.get(kname, 0) + n

    sources = {k: (source, PALLAS + replaced)
               for k, (*_mid, source, replaced, _depth) in table.items()}
    sources["axial_shift"] = ("axial_shift.cu", SHIFT_REPLACES)
    sources.update(LAB_KERNELS)
    sources["gemm_tn_sm90"] = ("gemm_sm90.cuh", GEMM_REPLACES)
    sources["gemm_s8_sm90"] = ("gemm_sm90.cuh", S8_REPLACES)
    sources["gemm_s8_mixer_sm90"] = ("gemm_sm90.cuh", MIXER_S8_REPLACES)
    sources["gemm_bf16_gmlp_sm90"] = ("gemm_sm90.cuh", GMLP_BF16_REPLACES)
    sources["gemm_bf16_resmlp_sm90"] = ("gemm_sm90.cuh", RES_BF16_REPLACES)
    sources["gemm_bf16_mixer_token_sm90"] = ("gemm_sm90.cuh", MIXER_TOKEN_REPLACES)
    sources["gemm_s8_resmlp_sm90"] = ("gemm_sm90.cuh", RES_S8_REPLACES)
    sources["gemm_bwd_sm90"] = ("gemm_sm90.cuh", BWD_REPLACES)
    sources["gemm_bf16_dual_sm90"] = ("gemm_sm90.cuh", DUAL_REPLACES)
    sources["gemm_bf16_group_sm90"] = ("gemm_sm90.cuh", GROUP_REPLACES)
    sources["fused_mixer_block_tp"] = ("mixer_block.cu", TP_REPLACES)
    sources["mixer_block_tp_finish"] = ("mixer_block.cu", FINISH_REPLACES)
    rows = []
    for kname, (source, replaced) in sources.items():
        ms, plain_ms, bound_ms, bound_by = timings[kname]
        check(launches.get(kname, 0) > 0, f"{kname} was not launched on its path")
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"jittor_mlp_tpu_torch/csrc/{source}",
            "replaces": replaced,
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes a whole block (of any lab variant),
            # a block's backward, the split block's products or its finishing
            # pass, or the zero-fill grouped shift (torch.roll wraps around);
            # the GEMM core's rows: cuBLAS's products
            "library_ms": library.get(kname),
        })
    print(f"[end] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
