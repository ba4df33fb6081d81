"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card; without one it
prints no result and exits non-zero. It imports nothing of JAX or
paddle_tpu. Phases, in order; any failure ends the run non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from paddle_tpu_torch/csrc/ (one nvcc per
   source, all started together), timed, with each kernel's registers
   and spills (each flash kernel at head_dim 64 and 128, the paged
   kernels at each head dim and q rows a CUDA-core unit, the LayerNorm
   kernels at the layouts GPT-medium's and GPT-1.3B's widths take, the
   selective scan at each tokens a thread, the tree update at each
   param type, state type, optimizer kind and rounding; the other
   LayerNorm layouts summed up on one line); a tensor-core kernel (a
   name with "_tc_kernel"), a main-path LayerNorm layout, a main-path
   scan kernel (the served steps', the full forward's) or a main-path
   tree-update variant (TREE_MAIN) that spills fails the run; the
   device times the smoke reads from the profiler's Kineto events
   (device_events) equal prof.events()' on a small profile;
3. the ragged paged-attention kernel against its plain PyTorch twin at
   serving shapes (16 heads, head_dim 64, page 16), in bfloat16 and
   float32: pure decode, a prefill chunk mixed with decode rows, pad
   tokens, grouped-query fold 4, a lone 1023-token decode row (split
   across blocks) and the chunk with decode rows at head_dim 128.
   Outputs within tolerance, work counters equal, pad rows exactly 0,
   and the same bits and work with the schedule shipped as with the one
   the wrapper builds, and with that schedule's table padded to the
   capacity of the call's (tokens, rows, width) signature (the table a
   captured serving step ships); per shape the kernel's time (capacity
   table shipped, as a served step runs it; the exact table's beside
   it), the twin's, one PyTorch call's
   (scaled_dot_product_attention on a dense copy of the same K/V), the
   least time the card could take (bound), the CUDA launches a call
   makes and the schedule's units, split units and splits;
4. GPT-medium at full width (vocab 50304, hidden 1024, 24 layers, 16
   heads) in bfloat16, weights drawn from a numpy seed by the
   reference's init (Normal(0, 0.02), zero biases, unit LayerNorms),
   served by GenerationEngine (1024 pages of 16, max_batch 8, prefill
   chunk 128), every step a replay of its signature's CUDA graph: 8
   greedy requests of 64 new tokens over prompts of 64-640 tokens, two
   sharing a 128-token prefix (the second arrives after the first is
   done, so it hits the prefix cache), three times on one engine: wave
   A untimed (each new signature captured inline: captures, their ms,
   retraces, TTFT), wave B (the main path: prompts of A's lengths with
   new tokens; timed) and wave C (the same again, profiled). Every
   handle must finish with 64 tokens; in wave B the kernel must have
   launched exactly (replays + captures) x 24 times (a replay launches
   it once a layer, as does the eager run before a capture) and no
   other kernel (#2-#11) at all; printed: retraces in wave B, wall and
   device ms a step, idle share, tokens/s, TTFT, the graphs' memory
   pool and the peak memory, and the host planner's microseconds a step
   (the cache's step plan and kernel #1's schedule, both numpy). Wave
   C's profile must show no sort kernel (greedy steps replay the greedy
   head). Then wave D: wave B's prompt lengths with new tokens, the
   odd-numbered requests sampled (temperature 0.8, top_k 50, top_p
   0.95, seed = the index), the others greedy: retraces must be 0 (wave
   A captured both heads of each signature); timed, then again
   profiled (sort kernels must show); a seeded request alone twice
   gives bit-equal streams; tokens/s, wall and device ms a step. Then,
   on the engine's cache, a mixed step (a 128-token chunk and 7 decode
   rows with histories of 63-699 tokens), a decode step of 8 rows and
   the mixed step again with the odd rows sampled, each replayed and
   its layers and head run eagerly on a copy of the pools from before
   it, with the plan the replay copied in: logits, next tokens and
   every pool bit-equal; the sampled and greedy heads of that step's
   graph replayed alone under the profiler give the sampler's device
   ms a sampled step. The kernel is held against the twin on layer 0's
   inputs of the first two eager runs;
4b. speculative decoding on phase 4's model: a 6-layer draft of the
   same width carrying the target's first 6 blocks, embeddings and
   final LayerNorm by name, k = 4. A greedy and a fully sampled wave
   (phase 4's prompt lengths, new tokens, seeds 100-107) on one engine,
   the sampled wave again with the draft's temperature 1.5 on another:
   streams equal to a non-speculative engine's on the same prompts and
   seeds, or at the first mismatch the target's top-2 gap there (of
   the perturbed values, for a sampled request) within 4 bf16 ulps of
   its largest logit (over the temperature); accepted and rejected
   proposals both > 0; kernel #1's launches over the speculative runs
   exactly (target replays + captures) x 24 + (draft replays +
   captures) x 6; accept rate, tokens/s, target and draft steps and
   wall ms a target step printed. Then a verify-shaped step (8 rows of
   5 tokens, the per-token sampled head) replayed and held against its
   eager layers and head bit for bit;
5. the same prompts at GPT-medium width with 2 layers in float32, once
   on the card (kernel) and once on the CPU (plain twin; the CPU half,
   which needs no card, is served beside phase 2's build from the same
   weights, held equal to phase 4's first 2 blocks): greedy
   streams must be equal; at a mismatch the CPU's top-2 logit gap at
   that token is printed and must be at most 1e-3 (a near-tie); then
   every request sampled (seeds 200-207): equal, or the CPU's top-2 gap
   of the perturbed values at the first mismatch at most 1e-3;
6. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain twins, q/k/v as strided views of one fused projection, in
   bfloat16 and float32: at head_dim 64 [8, 1024, 16, 64] causal and
   full, a ragged T = 1000 causal, Tq = 256 against Tk = 1024 full; at
   head_dim 128 GPT-1.3B's [4, 1024, 16, 128] causal and full.
   bfloat16 runs on the tensor cores (wgmma), float32 on the CUDA
   cores. Per case each kernel's time, its twin's, one PyTorch call's
   (scaled_dot_product_attention forward, or its backward), the bound
   and the achieved TFLOP/s, and dQ + dK/dV against the backward call.
   After phase 7, the forward, dQ and dK/dV again on layer 0's q, k, v,
   dO, lse and delta of the first main-path training step (kept by a
   hook on the dQ wrapper; dO there is ~1e-6, which random inputs never
   show; the lse the forward kernel saved in the step is held too);
7. GPT-medium at full width in bfloat16 (the phase-4 weights) trained by
   TrainStep(monitor_health=True), with no fused_update argument, with
   AdamW(lr=1e-4, multi_precision=True) on bench.py's batch (8 x 1024,
   ids from RandomState(0), labels = ids): 3 warm-up, 10 timed and 1
   profiled step. This main path must take the fused epilogue (kernels
   #9-#10, one launch of each per step), launch each flash kernel
   steps x 24 times and none of #5-#8. Then the same 14 steps with
   fused_update=False from the same weights (the tree epilogue: one
   tree-update launch a step, no standalone rounding), and
   the same 14 on the default epilogue with PADDLE_TPU_PALLAS_LN=1 and
   PADDLE_TPU_PALLAS_XENT=1 (this slice's main path: each LayerNorm
   kernel must launch steps x 49 times, 24 blocks x 2 and the final
   one, each softmax-xent kernel steps x 1, and its step-1 loss agree
   with the default run's to 1e-3 relative). For each run: losses and
   health vectors finite, found_inf 0, the loss falling; ms/step,
   tokens/s, MFU, peak memory, device ms, idle share, the epilogue's
   device ms and the CUDA kernel launches of the profiled step; each
   run's step-13 loss within 0.01 of the one the CUDA-core forward
   kernel gave (PERF.md section 5). Then a fourth run of 14 steps on the
   switched route with AdamW(LinearWarmup(CosineAnnealingDecay(1e-4,
   T_max=14), warmup_steps=4, start_lr=0, end_lr=1e-4),
   multi_precision=True) and `_state_dtype = bfloat16` (kernel #10's
   bf16-moment variant), the scheduler stepped after each step: loss
   falling, finite losses and health, #10 launches = steps x groups;
   device ms, epilogue ms and peak memory printed beside the f32-state
   switched run's. Last, 5 steps on the switched route with
   Adamax(1e-4), stochastic rounding and bf16 moments: an optimizer
   without a fused mapping keeps its per-leaf code, whose downcasts
   launch the standalone rounding kernel (K2) exactly steps x 3 x 292
   times (each parameter and both moments), and no tree update. Then,
   on the switched route from the phase-4 weights: `run_steps(4)`
   against four calls from the same state (restored by
   `snapshot_state` / `set_tree_state`), losses and every parameter
   bit-equal; `accumulate(2)` on two [4, 1024] microbatches against one
   call on the [8, 1024] batch from the same state, losses within 1e-3
   relative, each fused pass launched once a group and the forward's
   kernels twice;
7b. GPT-1.3B (gpt_1p3b(), head_dim 128) at full width and depth
   (vocab 50304, hidden 2048, 24 layers, 16 heads; 1,313,722,368
   parameters with the tied head; max_position_embeddings 1024 as
   bench.py sets it) in bfloat16, the reference's init drawn on the
   card from a seeded CUDA generator (timed), trained by the default
   fused TrainStep with both
   switches set (the port's fastest route), AdamW(lr=1e-4,
   multi_precision=True), on bench.py's batch 4 x 1024 (ids from
   RandomState(0), labels = ids): 2 warm-up, 5 timed, 1 profiled step.
   Its optimizer is not bench.py's (the second run's is), and neither
   run has bench.py's scan_remat="dots" and fused_loss(chunk=2048)
   (phase 7c has both).
   Each flash kernel must launch steps x 24 times, each LayerNorm
   kernel steps x 49, each xent kernel steps x 1, each fused pass
   steps x groups; losses and health finite, found_inf 0, the loss
   falling; ms/step, tokens/s, MFU, device ms, idle share, peak memory
   and the flash kernels' device ms of the profiled step; the last
   timed step's loss beside the recorded one. Then a second run from
   the same weights (the first's state freed) with bench.py's own
   optimizer (bench.py:683-688): Momentum(1e-4, 0.9) with stochastic
   rounding and a bf16 velocity, no masters, both switches, plain
   cross_entropy: the tree path, 2 warm-up, 5 timed, 1 profiled step;
   the loss falling and finite, the tree update launched exactly once a
   step (its 292 leaves in one group: bf16 params and velocities, no
   masters), no standalone rounding launch and no fused pass; ms/step,
   the tree update's and the epilogue's device ms in the profiled step,
   its CUDA kernel launches and peak memory. Then its
   first 2 layers in float32 (hidden 2048, head_dim 128), 3 steps at
   batch 2 x 256 on the card (the CUDA-core flash kernels at head_dim
   128) and on the CPU (twins) from the same weights, on the same
   route: losses and health vectors agree to rtol 1e-3;
7c. bench.py's GPT-1.3B headline as bench.py writes it
   (bench.py:667-714), on 7b's weights (not drawn again) and batch:
   scan_remat="dots", dropout 0, bench.py's wrapper whose forward is
   fused_loss(ids, labels, chunk=2048) (the chunked vocab loss on
   kernels #7-#8), TrainStep(model_returns_loss=True) with no
   fused_update argument and, as bench.py, no monitor_health,
   Momentum(1e-4, 0.9) with stochastic rounding and a bf16 velocity
   (the tree path), both switches (bench.py sets neither; until ROADMAP
   A.2 makes both routes the CUDA default): 2 warm-up, 8 timed and 1
   profiled step, every one after the first a replay of the step's
   CUDA graph; then the same with scan_remat=True and "names", 1
   warm-up, 3 timed and 1 profiled step each. Launches a step, counted
   through the replays, constants worked out from the code
   (BENCH_1P3B_LAUNCHES): flash forward 48 (the recompute runs it
   again), dQ and dK/dV 24, LayerNorm forward 97 (ln_1 and ln_2 again in
   the recompute, ln_f once), backward 49, #7 and #8 2 (two chunks),
   the tree update 1, no fused pass and no K2; the returned losses
   finite and falling; the "dots" run's step-1 loss within 1e-3
   relative of 7b's bench-optimizer run's; the three policies' step-1
   losses bit-equal; the peak under True below 7b's bench-optimizer
   run's. Then each policy's replays held against the step's eager body
   from one snapshot (3 replays, 3 eager steps: losses, every parameter
   and velocity bit-equal) and eager against replayed wall ms, device ms
   and idle share; under "dots" 3 more replayed steps with the health
   vector on (one more capture), so that the grad norm's cost shows.
   For each run: wall and device ms a step, tokens/s, MFU (the
   recompute not counted), idle share, peak memory, launches, the loss
   from first step to last, captures, capture ms and the graph pool;
7d. (run after phase 7's flavors) captured train steps on GPT-medium
   bf16 (the phase-4 weights, 8 x 1024, switches unset): the default
   fused AdamW with f32 masters under LinearWarmup(CosineAnnealing(
   1e-4, 14), 4, 0, 1e-4), stepped between steps, with a GradScaler
   (2^10, doubled every 2 good steps) and the health vector: one call
   captures, then from the snapshot taken before it 6 replays against
   6 runs of the eager body (`TrainStep._eager_call`): losses, every
   parameter, moment and master and the GradScaler's state bit-equal;
   `run_steps(4)` replayed against 4 eager calls; `accumulate(2)` on
   2 x [4, 1024] against its eager body; Adamax + SR + bf16 moments
   (the tree path's per-leaf code and K2, 2 x 1024, switches set)
   against its eager body. Each: eager against replayed wall and device
   ms a step, idle share, capture ms, graph pool; peak memory;
8. GPT-medium width with 2 layers in float32, 3 train steps (batch
   2 x 256) on the card (kernels) and on the CPU (twins) from the same
   weights, on each epilogue and on the default one with both switches
   set (one function: the CPU runs it once, its reference for all
   three): losses and health vectors agree to rtol 1e-3; the same for the
   eager loop (AdamW, and Adam, with L2Decay, ClipGradByNorm and a
   step-decay scheduler; losses), Lamb on TrainStep's tree path and
   AdamW on the fused epilogue with bf16 moments; and remat "dots" with
   fused_loss behind bench.py's wrapper (model_returns_loss), 3
   accumulate(2) steps on the fused epilogue (#7-#8 once a microbatch,
   the flash forward twice a layer a microbatch);
9. the fused epilogue's kernels against their twins on the card at
   GPT-medium's layout (16 buckets, 354,871,296 parameters), bf16 with
   f32 masters, AdamW, stats on: with a live GradScaler (pass 1 writes
   the unscaled grads), with found_inf = 1 (every buffer must keep its
   input bit for bit), without a scaler (the main path's passes, timed
   with their twins, their byte bounds and a library yardstick:
   torch._foreach_norm for pass 1, torch._fused_adamw_ over the f32
   master buckets for pass 2), with ClipGradByGlobalNorm, with
   ClipGradByValue, under Momentum-Nesterov and SGD, and on an f32
   model without masters; then a small ragged layout with a
   need_clip=False, a decay=False and an lr_scale=0.5 leaf and buckets
   that are not a multiple of the chunk; #10 with bf16 moments (AdamW
   with f32 masters, 22 B a parameter, and Momentum without masters, 10
   B), with and without a GradScaler, timed beside their byte bounds.
   Written buffers must equal the twin's bit for bit; sums agree to
   1e-4 relative;
9b. the tree update against its twin at GPT-1.3B's 292 leaves
   (1,313,722,368 bf16 parameters) on bench.py's optimizer (Momentum
   0.9, bf16 velocity, stochastic rounding) at steps 1 and 2 and under
   found_inf (every buffer as it was), and with rounding to nearest; at
   GPT-medium's 292 leaves on phase 7's tree run's optimizer (AdamW,
   f32 masters and moments): every written buffer bit-equal, the health
   sums within 1e-4 relative, one launch a group. Times of the kernel,
   the twin and a library call where one computes the same update
   (nearest: torch._fused_sgd_ with bf16 momentum buffers; AdamW:
   torch._fused_adamw_ over the f32 masters and f32 copies of the
   grads; stochastic rounding: none), beside the bound (the larger of
   the bytes at 3.35 TB/s and the operations: 76 32-bit integer
   operations a stochastically rounded target at 33.5 T/s, the update's
   float ones at 67 T/s); the SASS of the main variant (cuobjdump): its
   instructions and the most common opcodes. Then the
   stochastic-rounding kernel (K2, float32 -> bf16 with threefry bits)
   against its twin at GPT-1.3B's leaf sizes (wte, an MLP weight, qkv, a
   bias) and odd ones (4099, 7, 1), two keys: bf16 bits equal; at wte's
   size the kernel's time, the twin's and the bound (6 bytes an element,
   or its 76 integer operations; no PyTorch call rounds stochastically);
10. 2-layer float32 steps with a GradScaler on the card, on each
   epilogue, with one batch whose loss is not finite: params and
   moments stay bit-equal, the scale halves, the next good step
   updates; and the eager GradScaler around AdamW's eager step: the
   non-finite step's `scaler.step` skips `opt.step()`, `update` halves
   the scale, the next step updates;
11. the LayerNorm kernels (#5 forward, #6 backward) and the softmax
   cross-entropy kernels (#7 forward, #8 backward) against their plain
   twins: LayerNorm at [8192, 1024] and [4096, 2048] in bf16 (bf16
   weight and bias, as GPT's), [8192, 1024] in f32, [1000, 4096]
   (gpt_6p7b's width, a ragged row count), [8192, 1000] and [257, 1001]
   (scalar loads), [64, 16384] (the widest row); xent at a chunk of
   phase 7c's chunked loss [2048, 50304] and at [8192, 50304] in bf16,
   [8192, 50304] in f32, phase 18 (a)'s float32 LayerNorm [4096, 512]
   and xent [4096, 32000], with about 10 % of the xent labels -1 and some
   >= V, and [1000, 50257] (a row that is not 16-byte aligned);
   xent dx is held per element against |twin| (one bf16 ulp, or
   1e-5 relative plus 1e-9 in f32), since most of it is far below 1.
   At the training shapes (LayerNorm [8192, 1024] and GPT-1.3B's
   [4096, 2048] bf16, xent [2048, 50304] and [8192, 50304] bf16) each
   kernel's time, its twin's, one PyTorch
   call's (torch.nn.functional.layer_norm forward and its backward;
   torch.nn.functional.cross_entropy(reduction="none") forward and its
   backward) and the byte bound. Then the chunked loss
   (ops/chunked_xent.py) on #7-#8 against the same function on their
   twins at 7c's shapes (hidden [4096, 2048], tied head [50304, 2048],
   bf16, chunk 2048): the loss within 1e-5 * max(1, |twin|), dh and dw
   within 1e-2 of their largest value, #7 and #8 once a chunk; its
   forward + backward timed on the kernels, on the twins and unchunked
   (F.cross_entropy over h @ w^T);
12. the selective-scan kernel (#11) against its plain twin at serving
   shapes (D 1536, N 16, float32): pure decode (T 8, R 8), a 128-token
   chunk with 7 decode rows (T 256), pads on row 0 with dt = 0,
   interleaved rows, and the full causal forward of Mamba-130M's width
   (4 rows x 1024 contiguous tokens: T 4096, R 4). y and the final
   states within rtol 1e-5, atol 1e-5 (the atol scaled by the tensor's
   largest entry where that is below 1); rows that only pads touch keep
   their state bit for bit; per shape the kernel's time, the twin's, the
   byte bound and the longest row's tokens (pads included: the length
   of the longest scan; no PyTorch call computes a selective scan:
   library "none"), beside the floor of the timing method (an empty
   kernel timed the same way);
13. a Mamba-130M-shaped SSM (SSMConfig at state-spaces/mamba-130m's
   published shape: vocab 50304, d_model 768, 24 layers, d_state 16,
   d_conv 4, expand 2; 129,191,424 parameters) in bfloat16, weights
   drawn from a numpy seed by the reference's init (Normal(0, 0.02),
   A_log = log(1..16), D = 1, zero biases, unit LayerNorms), served by
   GenerationEngine on a RecurrentStateCache (65 pages: 64 state slots,
   max_batch 8, prefill chunk 128) through replayed CUDA graphs, in
   phase 4's three waves: every handle must finish with 64 tokens, in
   wave B the scan must have launched exactly (replays + captures) x 24
   times and no other kernel (#1-#10) at all, and the inert prefix cache
   must have served no token; the same prints as phase 4, wave D and
   its checks included. Then phase 4's replayed mixed, decode and
   sampled mixed steps against their eager bodies, and the kernel held
   against the twin on the first two's layer-0 scan inputs (|y| there
   is ~1e-6, so the scaled atol is what holds it);
14. the same prompts through 2-layer float32 SSMs at that width, pure
   and hybrid (attn_every 2, 12 heads: head_dim 64, so kernels #1 and
   #11 both run), weights of std 0.5 so that the greedy streams vary
   (checked), on the card and on the CPU (the CPU halves served beside
   phase 2's build): greedy streams equal, or the
   CPU's top-2 gap at the first mismatch at most 1e-3; with every stream
   equal, the real slots' conv tails and states after the run within
   1e-3 of each pool's largest entry; every request sampled (seeds
   300-307): as phase 5's sampled streams;
15. the Paddle dygraph surface (`import paddle_tpu_torch as paddle`,
   `set_device("gpu")`, `seed(0)`): (a) GPT-medium bf16 as a Layer,
   loaded with the phase-4 weights through `set_state_dict`, trained by
   the eager loop `model(ids)` -> `F.cross_entropy` -> `loss.backward()`
   -> `opt.step()` -> `opt.clear_grad()` (AdamW 3e-4 with
   ClipGradByGlobalNorm(1.0), examples/train_gpt.py's) on phase 7's
   batch from `paddle.to_tensor`: losses finite and falling, the step-1
   loss within 1e-3 relative of phase 7's default TrainStep step-1
   loss, kernels #2-#4 launched exactly steps x 24 times and no other;
   wall and device ms a step, idle share, peak memory; (c)
   `paddle.save(model.state_dict())` -> `paddle.load` ->
   `set_state_dict` into a fresh model: every parameter and one
   forward's logits bit-equal; (b) the same Layer model through
   examples/train_gpt.py's `TrainStep(model, loss_fn, opt)` fed Paddle
   Tensors: losses finite, #9 and #10 launched steps x bucket groups,
   #2-#4 steps x 24; wall and device ms beside phase 7's default run;
   (d) tests/test_torch_dygraph.py's user Layer at head_dim 64, float32
   with TF32 off, 3 eager steps on the card and on the CPU from the same
   numpy weights: losses within 1e-3 relative, the flash kernels
   launched on the card; (e) host microseconds of `paddle.add` and
   `x + y` on Tensors against `torch.add`, and of a Layer call with a
   Tensor or a torch tensor against the bare forward;
16. examples/bench_bert.py's ERNIE-base MLM step (`BertForMaskedLM(
   ernie_base())`, vocab 40000, hidden 768, 12 layers, 12 heads, 117.4 M
   parameters, dropouts 0, weights drawn from a numpy seed by the
   reference's init): (a) `model.bfloat16()`, AdamW 1e-4 with f32
   masters, bench_bert's `TrainStep(model, loss_fn, o)` (the fused
   epilogue, replayed as CUDA graphs) on its batch of 32 x 128 (ids and
   MLM labels from RandomState(0)): 3 warm-up, 30 timed and 1 profiled
   step; step ms, sequences/s, tokens/s, MFU (profiler/cost.py's FLOPs
   of the step), device ms, idle share, peak memory; losses finite and
   falling; over the timed steps #2-#4 launched exactly 30 x 12 times
   each, #10 30 x bucket groups and no other kernel (#9 neither: with no
   clip, no GradScaler and health off the epilogue skips pass 1); (b) the AMP
   eager loop on the float32 model (`auto_cast` -> `model.loss` ->
   `scaler.scale(loss).backward()` -> `scaler.step(opt)` ->
   `scaler.update()` -> `opt.clear_grad()`, 1 + 4 + 1 profiled steps)
   under O1 bf16, `decorate(level="O2")` bf16 and O1 float16 with a
   dynamic GradScaler: losses finite and float32, grads float32 under
   O1 and the low dtype under O2, #2-#4 launched steps x 12 times, the
   profiled step's flash kernels the bf16 or float16 variants as the
   mode says; wall and device ms, idle share, peak memory; (c) 2 of its
   layers at full width in float32 (TF32 off), 3 TrainSteps on the card
   and on the CPU from the same numpy weights within 1e-3 relative, one
   O1-bf16 eager step within 2e-2; (d) the flash kernels against their
   twins at ERNIE's shape [32, 128, 12, 64] non-causal in bf16 and
   float16, and in float16 at GPT-medium's and GPT-1.3B's training
   shapes, with each kernel's, twin's, SDPA's (same dtype) time and the
   bound;
17. examples/train_vision_hapi.py's workflow on ResNet-50 (BASELINE.json's
   "ResNet-50 dygraph on CIFAR-10"; no dataset files: the example's
   SyntheticImages at CIFAR-10's 3 x 32 x 32, 10 classes), float32
   (torch's TF32 defaults), weights from `paddle.seed`: (a)
   `Model.prepare(Momentum(0.01, momentum=0.9), CrossEntropyLoss(),
   Accuracy())`, `fit` on 3328 images in batches of 128 (shuffled),
   validating on 1024, 2 epochs, then `evaluate`; each epoch's wall s,
   images/s, ms a replayed step, captures, compile_s, graph pool, peak
   memory; losses finite; each epoch's step captured once and replayed
   for the rest (evaluate drops the step, so the next epoch captures
   anew); over fit's 52 steps #10 launched 52 x bucket groups and no
   other kernel of the table (#9 neither: no clip, scaler or health);
   every BatchNorm running statistic finite and moved; epoch 2's peak
   at most epoch 1's plus one graph pool, and what stays allocated after
   each epoch's evaluate equal within 0.25 GiB (the dropped step's pool
   freed); one profiled step: device ms, idle share, MFU
   (profiler/cost.py's FLOPs over 989 TFLOP/s); (b) the TrainStep that
   fit builds, at ImageNet's 64 x 3 x 224 x 224 and 1000 classes, 2 + 10
   + 1 profiled steps in float32 and under `auto_cast(level="O1",
   dtype="bfloat16")` (kernels named bf16 at least a quarter of its
   device time): ms a step, images/s, device ms, idle share, peak, MFU;
   (c) the dygraph eager loop (`net(x)` -> `F.cross_entropy` ->
   `backward` -> `opt.step()` -> `opt.clear_grad()`) at (a)'s shape, 1
   + 5 + 1 profiled steps: wall and device ms, idle share; (d) ResNet-18
   at full width, float32 with TF32 off, 8 x 3 x 32 x 32, from the same
   numpy weights: 3 `train_batch` steps on the card and on the CPU
   within 1e-3 relative, the running statistics within 1e-4 of each
   buffer's largest value, then `evaluate` on 32 images: accuracy equal,
   loss within 1e-3; (e) a ResNet-18 step replayed against its eager
   body from one snapshot (cuDNN deterministic), losses, parameters,
   velocities and BatchNorm's buffers bit-equal (`hold_replayed`);
18. the recurrent slice, float32 on the default CUDA generator: (a)
   Transformer-base (`Seq2SeqTransformer(Seq2SeqConfig())`: vocab 32000
   / 32000, d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1,
   77,168,640 parameters in 255 leaves, weights from a numpy seed,
   TF32 products) on 32 sources x 128 and 32 targets x 128 with pad
   tails of seeded lengths 64-128, trained by
   TrainStep(monitor_health=True) with AdamW: 2 + 3 timed + 1 profiled
   steps on the default route, then as many with PADDLE_TPU_PALLAS_LN=1
   and PADDLE_TPU_PALLAS_XENT=1 (a new capture); for each: ms a step,
   target tokens/s, device ms, idle share, peak memory from
   paddle.device.max_memory_allocated() and torch.cuda's (equal), the
   launches (#9 and #10 once a bucket group a step; #5 and #6 30 a step
   and #7 and #8 one a step on the switched route; #2-#4 never: every
   attention has a mask); a replay against its eager body from one
   snapshot and CUDA generator state, bit for bit; with TF32 off and
   dropout 0, the losses of 2 steps on 2 sequences on the card's
   default route and on its switched route (#5-#8 launched 2 x 30 and
   2 x 1) against the CPU's within 1e-4 relative, and
   greedy_decode(max_len=32) on 8 sources: tokens
   equal, or at a row's first mismatch the CPU's top-2 logit gap at
   most 1e-3; (b) PaddleNLP's machine_translation/seq2seq model
   (IWSLT'15 En-Vi widths: vocab 17191 / 7709, embedding and hidden
   512, 2 layers, dropout 0.2, attention with input feeding) composed
   from nn.LSTM, LSTMCell, RNN and Linear, batch 128 x 50 with seeded
   pad tails, trained 4 steps by a TrainStep (AdamW,
   ClipGradByGlobalNorm(5)): ms a replayed step, tokens/s, launches (#9
   and #10 once a group a step, nothing else), a replay against its
   eager body bit for bit (eager and replayed ms); then
   BeamSearchDecoder(beam_size=10) + dynamic_decode(max_step_num=50)
   over the 128 sources: ms and device ms a decode step, device-to-host
   copies a step; 4 sources with TF32 off card against CPU: sequences
   equal, scores within 1e-4 relative; (c) bidirectional 2-layer GRU
   and SimpleRNN card against CPU (1e-4), paddle.device.Event against
   torch.cuda.Event around an 8192^3 product, get_device_properties's
   name against nvidia-smi's, memory_reserved >= memory_allocated;
19. the data path: (a) phase 17's ResNet-50 `Model.fit` at CIFAR-10's
   shape (the same model, Momentum, data and batch of 128; one epoch, no
   evaluation) through DataLoader(num_workers=4, prefetch_to_device=2):
   spawned worker processes collate (the port's TensorDataset over
   SyntheticImages' arrays, which a worker can unpickle), the device
   prefetch ring copies each batch from pinned memory on a side stream.
   Held: the native ring loaded; the batches fit's step receives equal
   (order-sensitive checksums) those of DataLoader(num_workers=0) under
   the same numpy seed, as do those of the threaded path (4 worker
   threads over the native ring); fit binds its step's input_sharding
   and releases it; #10 once a group a step, nothing else. Printed: ms
   a replayed step, images/s, device ms and idle share (a profiled
   step), dataloader.wait_s p50 / p99 and its first wait (the workers'
   start), prefetch.h2d_bytes, beside phase 17's num_workers=0 figures
   of this run; (b) bench.py's steady loop (bench.py:430-439) on 7c's
   step (GPT-1.3B bf16, remat "dots", the chunked loss, bench.py's
   Momentum, both switches): fed from the host (a new [4, 1024] batch a
   step copied in the loop) and through device_prefetch_iterator(depth=
   2, sharding_fn=step.input_sharding), from the same weights and
   batches, 2 + 10 timed steps each: losses bit-equal, the ring's
   launches 7c's a step, prefetch.h2d_bytes exactly the batches' bytes;
   ms a step and idle share (a profiled step's device ms) of both,
   beside 7c's;
20. the legacy generation path: (a) examples/bench_decode.py's TPU
   configuration on phase 4's weights (GPT-medium bf16, prompt 32, 128
   new tokens, top_k 50, batch 1, 8 and 32): `generate` twice, printing
   compile_s (the first call: the prefill and decode graphs captured),
   decode_tok_per_s and e2e_ms_per_new_token of the second, the device
   ms of one decode step (its graph replayed 127 times under CUDA
   events) and its bound (the weights' and the static cache's bytes
   over HBM bandwidth); tokens in range, the prompt kept; (b)
   GenerationEngine(ragged=False), the bucketed loop, against the ragged
   engine on phase 4's engine config and weights, greedy, each warmed
   for every prompt length, an untimed wave of phase 4's prompts, then
   a timed wave of new prompts of their lengths: the bucketed engine
   captures nothing after warm (held), launches no kernel; output
   tokens/s and pad_token_fraction() of both; the timed streams equal,
   or at a first mismatch both tokens within 4 bf16 ulps of the largest
   logit (`bf16_rule`); (c) InferenceEngine over bench.py --serve's
   model (Linear(2048, 2048), Tanh, Linear(2048, 2048), float32, TF32
   off), BucketLadder((1, 2, 4, 8)) warmed, 8 client threads of 40
   requests: requests/s, p50 / p99 ms, mean batch, retraces 0 over the
   traffic (held), beside the serial baseline; every output within 1e-5
   relative of the serial model's; (d) a 2-layer float32 GPT-medium,
   card against CPU, TF32 off: generate(top_k=1) tokens equal (or
   phase 5's gap rule at a first mismatch), paged_decode_step logits
   (three prefills, 8 decode steps padded to 4 rows) within 1e-4;
21. the serving front door (ServingRouter, the prefill/decode handoff
   and the serving observatory) on phase 4's weights: (a) 16 greedy
   requests (phase 4's prompts and 8 behind one 64-token system prompt,
   64 tokens each) through one GenerationEngine of 8 slots and through a
   disaggregated pair (a prefill engine of 4 slots, a decode engine of
   4, a prefill chunk of 32) over one pool of 512 pages of 16, prefix
   cache off: the one engine runs the requests untimed (captures
   inline), then timed; the pair (`ServingRouter.disaggregated`) has its
   cache warmed for every signature it can take, then `router.warm`;
   held: no capture in the pair's run (retraces 0 after the warm), #1 =
   replays x 24
   and no other kernel, one handoff a request, each adopted chain the
   exporter's page ids, pages drawn equal in both topologies and none
   copied, streams equal or `bf16_rule` ties; printed: requests/s and
   TTFT p50 / p99 of both; (b) the port's tools/load_harness.py trace
   (seed 0, 64 requests at 8 req/s, x10 over indices 0.4-0.7, prompts
   lognormal mean 128 sigma 0.6 clipped at 1024, outputs mean 32 sigma
   0.5 clipped at 128, vocab 50304, the reference's SLO tiers) driven
   open-loop through a pair of (a)'s shape with max_queue 8, its cache
   warmed for the trace's lengths, the metrics JSONL (PADDLE_TPU_METRICS_FILE) passing
   tools/check_metrics_schema.py run as a script; printed: goodput,
   attainment by class, TTFT / TPOT p50 / p99, rejected and expired
   fractions, peak in flight, pressure events, kv_peak_occupancy,
   fragmentation; (c) phase 13's SSM as a disaggregated pair over one
   RecurrentStateCache against one engine: streams equal or ties, #11 =
   (replays + captures) x 24;
22. the profiler on bench.py's stages (A.12): (a) 7c's step (GPT-1.3B
   bf16, remat "dots", bench.py's optimizer, both switches) in bench.py's
   steady loop through the prefetch ring, under Profiler(targets=[CPU,
   GPU], make_scheduler(closed=1, ready=1, record=4),
   export_chrome_tracing) opened before the first call and a RecordEvent
   a step, with the metrics JSONL and the device-time probe every 2
   steps; held: losses bit-equal to the same steps from a snapshot
   without telemetry, launches 6 x 7c's a step (the wrappers) and 4 x
   them in the device trace, every JSONL record through
   tools/check_metrics_schema.py, the probed steps' records carrying
   step_time_device_s, the probe's median within 10% of the trace's
   device ms a step, mem_report()'s params tag the parameter bytes, ms a
   step with telemetry on within 2% of off; (b) GPT-medium bf16 served
   under the Profiler (two requests, each warmed, served in a first
   window whose counts are printed, then again in the held one: CUPTI
   lost a #1 launch of the first window's first step): serve.batch
   spans = steps, #1 in the trace = steps x 24, no capture; (c) a debug bundle
   after (a) (no allocation), a Watchdog quiet over steps and firing once
   in a pause, dumps from another thread and a SIGQUIT dump on the
   capturing thread during a TrainStep capture (the replay equal to the
   eager body), nan@train.step#3 on replayed steps (retraces 1, step 3
   flagged first), oom@train.step (DeviceOOMError, a device_oom event),
   FLAGS_check_nan_inf on an eager op on the card (the reference's
   event);
23. the smoke's run time and the kernels line (each flash kernel
   three times: head_dim 64, with the suffix "_d128" head_dim 128, with
   "_f16" float16; #10's bf16 variant as "fused_pass2_bf16_state"; the
   tree update as "tree_update"; K2 as "stochastic_round"), then, last,
   {"ok": true, "device": {...}}.

Each main path (GPT serving in phase 4's wave B, training in phase 7's
first run for kernels #2-#4 and #9-#10, phase 7's third run for #5-#6,
phase 7c's "dots" run (bench.py's headline) for #7-#8,
its fourth for #10's bf16 variant, its fifth for K2, GPT-1.3B training
in phase 7b for #2-#4 at head_dim 128, its second run for the tree
update, SSM serving in phase 13's wave B for #11, phase 16's O1-float16
AMP run for #2-#4 in float16, phase 18 (a)'s two routes for #5-#10
and (b)'s training for #9-#10, and this slice's: phase 19 (a)'s fit for
#10, (b)'s ring-fed loop for #2-#8 at head_dim 128 and the tree update,
phase 20 (b)'s ragged engine's timed wave for #1, phase 21 (a)'s pair
and (b)'s open-loop run for #1 and (c)'s SSM pair for #11, each added to its
kernel's launches in the kernels line) runs with the launch counts set
to 0 just before it and read just after; a CUDA graph's replay adds the launches
its capture recorded (the wrappers count launches, and a capture, which
launches nothing, records them instead).
Times are CUDA-event times with the 50 MB L2 flushed before each
launch (by writing a 64 MB buffer), as the serving loop finds it cold
(each layer has its own pools); the LayerNorm kernels are timed
after a flush that reads the buffer too, which leaves no dirty line
for their misses to write back. Bounds use the H100 SXM's published
peaks: 3.35 TB/s of HBM, 989 TFLOP/s bf16 and float16 (tensor cores),
67 TFLOP/s float32.
"""
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
              "torch.float32": 67e12}
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
H, D, P = 16, 64, 16
SERVE = dict(n_pages=1024, page_size=16, max_batch=8, max_new_tokens=64,
             prefill_chunk=128)
NEW_TOKENS = 64
GAP_LIMIT = 1e-3
# the sampled requests of the waves D (phases 4, 13) and 4b
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# phase 4b: the layer-truncated self-draft's depth, its proposals a step,
# the third run's draft temperature; the bf16 gap rule of the tier-1
# tests (a near-tie within BF16_ULPS ulps of the largest logit)
DRAFT_LAYERS = 6
SPEC_K = 4
DRAFT_TEMPERATURE = 1.5
BF16_ULPS = 4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# a template argument of a mangled kernel name: bf16, f16, f32, a repeat
# of an earlier type (in these kernels always bf16), an int (a head dim,
# q rows; in the LayerNorm kernels vectors a lane, warps a row, stages; in
# the tree update the optimizer kind) or a bool (the tree update's
# stochastic rounding)
_TEMPLATE_ARG = re.compile(
    r"13__nv_bfloat16|6__half|f|S\d*_|Li(\d+)E|Lb(\d)E")


def kernel_label(ptxas_line):
    """'ln_bwd_kernel<bf16, f32, VPL=2, WPR=2, STAGES=3>',
    'flash_dq_kernel<bf16, D=64>' or 'paged_cc_kernel<bf16, D=64,
    rows=16>' from ptxas's line naming a mangled kernel."""
    mangled = ptxas_line.split("'")[1]
    found = re.search(r"_kernel(?=[IE])", mangled)
    if not found:
        return mangled[:60]
    end = found.end()
    # the name is prefixed by its length in decimal
    name = next((mangled[end - n:end] for n in range(len("_kernel"), 61)
                 if mangled[:end - n].endswith(str(n))), mangled[:60])
    if mangled[end] == "E":  # not a template
        return name
    args, at = [], end + 1
    ints = ("VPL", "WPR", "STAGES") if name.startswith("ln_") \
        else ("L",) if name.startswith("ssm_") \
        else ("KIND",) if name.startswith("tree_") else ("D", "rows")
    while (m := _TEMPLATE_ARG.match(mangled, at)):
        if m.group(1):  # the first int a head dim, the second q rows
            args.append(f"{ints[0]}={m.group(1)}")
            ints = ints[1:] or ints
        elif m.group(2):
            args.append(f"SR={m.group(2)}")
        else:
            args.append({"f": "f32", "6__half": "f16"}.get(m.group(0),
                                                          "bf16"))
        at = m.end()
    return f"{name}<{', '.join(args)}>"


def ln_main_labels(lk):
    """Labels of the LayerNorm kernels the main paths launch: bf16 x, w
    and b at GPT-medium's width 1024 and GPT-1.3B's 2048."""
    out = set()
    for C in (1024, 2048):
        for backward in (False, True):
            vpl, wpr, stages = lk.row_layout(C, backward)
            out.add(f"ln_{'bwd' if backward else 'fwd'}_kernel<bf16, bf16, "
                    f"VPL={vpl}, WPR={wpr}, STAGES={stages}>")
    return out


def scan_main_labels(sk):
    """Labels of the selective-scan kernels the main paths launch: the
    served decode step (T 8: the decode kernel), the mixed one (T 256)
    and the full forward of 4 x 1024 tokens at Mamba-130M's width (D
    1536, N 16)."""
    return {"ssm_decode_kernel"} | {
        f"ssm_scan_kernel<L={sk.scan_tiling(T, 1536, 16).tokens}>"
        for T in (256, 4096)}


# the tree-update variants the main paths launch: bench.py's GPT-1.3B
# Momentum (bf16 params and velocity, stochastic rounding) and phase 7's
# tree run (AdamW, bf16 params, f32 moments and masters)
TREE_MAIN = {"tree_update_kernel<bf16, bf16, KIND=1, SR=1>",
             "tree_update_kernel<bf16, f32, KIND=2, SR=0>"}


def phase_registers(logs, ln_main, scan_main):
    """Each kernel's registers and spills from the build logs. A
    tensor-core kernel ("_tc_kernel"), a LayerNorm kernel of the main
    paths (ln_main), a selective-scan kernel of theirs (scan_main) or a
    tree-update variant of theirs (TREE_MAIN) that spills fails the run;
    the other LayerNorm layouts are summed up on one line."""
    seen, ln_other = set(), {}
    for lib, log in sorted(logs.items()):
        label, quiet = None, False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                label = kernel_label(line)
                seen.add(label)
                quiet = label.startswith("ln_") and label not in ln_main
                if not quiet:
                    print(f"    {lib}: {label}")
            elif "registers" in line or "spill" in line or "wgmma" in line:
                if quiet:
                    ln_other.setdefault(label, []).append(line)
                else:
                    print("     ", line.strip())
                # the tensor-core kernels keep every accumulator in
                # registers, the LayerNorm kernels a row, the scan its
                # tokens' terms: a spill would put them in local memory
                check(("_tc_kernel" not in (label or "")
                       and label not in ln_main | scan_main | TREE_MAIN)
                      or "spill" not in line
                      or " 0 bytes spill stores, 0 bytes spill loads"
                      in line, f"{label} spills: {line.strip()}")
    check(ln_main <= seen, f"LayerNorm kernels not built: {ln_main - seen}")
    check(scan_main <= seen, f"scan kernels not built: {scan_main - seen}")
    check(TREE_MAIN <= seen, f"tree kernels not built: {TREE_MAIN - seen}")
    regs = [int(m.group(1)) for lines in ln_other.values() for line in lines
            if (m := re.search(r"Used (\d+) registers", line))]
    spilling = sorted(k for k, lines in ln_other.items()
                      if any("spill" in line and " 0 bytes spill stores, 0 "
                             "bytes spill loads" not in line
                             for line in lines))
    print(f"    layer_norm: {len(ln_other)} other layouts (no main path "
          f"launches them): {min(regs, default=0)}-{max(regs, default=0)} "
          f"registers; spilling: {spilling or 'none'}")


def cuda_ms(torch, fn, iters, flush, clean=False, spin=2_000_000,
            warmup=2):
    """Mean device time of fn() in ms over iters calls (after `warmup`
    untimed ones), by CUDA events.
    Before each call the L2 is flushed (flush.zero_(), which leaves it
    full of dirty lines that fn's misses write back; with clean=True by
    reading the buffer instead) and the card is parked on a spin of
    `spin` cycles (~1 ms by default; longer for a wrapper with more host
    work a call), so the host has enqueued the whole call before the
    start event fires: the time excludes the host's launch cost, except
    where fn itself waits on the device (the plain twin reads bounds to
    the host) or enqueues for longer than the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if clean:
            flush.view(torch.int32).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def host_us(torch, fn, n=200):
    """Host time of one fn() call in microseconds, with the card parked
    on a long spin so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound(q, k_pages, token_seq, bounds):
    """(ms, "bytes"|"operations"): the least time for this call. Bytes:
    q of live tokens, the K and V pages their bounds reach (each page of
    each row once), the table entries, token_seq and bounds read, out
    and work written. Operations: 4 * D per (token, head, visible key)
    (the score and the value products), at the inputs' dtype peak."""
    T, Hq, Dh = q.shape
    _, Pg, KVH, _ = k_pages.shape
    it = q.element_size()
    seq = token_seq.cpu().numpy()
    bd = bounds.cpu().numpy().astype(np.int64)
    live = bd > 0
    reach = {}
    for r, b in zip(seq[live], bd[live]):
        reach[r] = max(reach.get(r, 0), b)
    pages = sum(-(-b // Pg) for b in reach.values())
    n_bytes = (2 * pages * Pg * KVH * Dh * it + live.sum() * Hq * Dh * it
               + T * Hq * Dh * it + 4 * (pages + 3 * T))
    ops = 4 * Dh * Hq * int(bd[live].sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(q.dtype)]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_call(torch, q, k_pages, v_pages, page_table, token_seq, bounds):
    """One PyTorch call computing the same attention: SDPA over the
    rows' K/V copied densely (outside the timing) with a boolean mask
    that encodes each token's row and bound."""
    T, Hq, Dh = q.shape
    _, Pg, KVH, _ = k_pages.shape
    seq, bd = token_seq.long(), bounds.long()
    ks, vs, owner, pos = [], [], [], []
    for r in sorted(set(seq[bd > 0].tolist())):
        n = int(bd[seq == r].max())
        pages = page_table[r, :-(-n // Pg)].long()
        ks.append(k_pages[pages].reshape(-1, KVH, Dh)[:n])
        vs.append(v_pages[pages].reshape(-1, KVH, Dh)[:n])
        owner.append(torch.full((n,), r, device=q.device))
        pos.append(torch.arange(n, device=q.device))
    fold = Hq // KVH
    K = torch.cat(ks).repeat_interleave(fold, dim=1).permute(1, 0, 2)[None]
    V = torch.cat(vs).repeat_interleave(fold, dim=1).permute(1, 0, 2)[None]
    mask = (torch.cat(owner)[None, :] == seq[:, None]) \
        & (torch.cat(pos)[None, :] < bd[:, None])
    Q = q.permute(1, 0, 2)[None].contiguous()
    K, V = K.contiguous(), V.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        Q, K, V, attn_mask=mask[None, None])


def hold(torch, pa, args, flush, label, iters=20):
    """Kernel vs twin on args: errors, work, pads, times. The wrapper
    builds its schedule from the inputs on the first call; the timed
    calls take it shipped, as a serving step does (no device-to-host
    read). Returns a dict of the measurements."""
    q, k_pages, v_pages, page_table, token_seq, bounds = args
    out, work = pa.ragged_paged_attention(*args, return_work=True)
    sched = schedule_of(torch, pa, args)
    sched.dev = sched.on(q.device)
    shipped = pa.ragged_paged_attention(*args, schedule=sched)
    cap = schedule_of(torch, pa, args, capacity=True)
    cap.dev = cap.on(q.device)
    padded, cap_work = pa.ragged_paged_attention(*args, schedule=cap,
                                                 return_work=True)
    torch.cuda.synchronize()
    check(torch.equal(out, shipped), f"{label}: a shipped schedule gives "
                                     "other bits")
    check(torch.equal(out, padded) and torch.equal(work, cap_work),
          f"{label}: the capacity table gives other bits or work than the "
          f"exact one")
    want, want_work = pa.ragged_paged_attention_reference(
        *args, return_work=True)
    err = (out.float() - want.float()).abs().max().item()
    dtype = str(q.dtype)
    check(err <= TOL[dtype], f"{label}: max |kernel - twin| {err} > "
                             f"{TOL[dtype]}")
    check(torch.equal(work, want_work), f"{label}: work counters differ")
    check(work.tolist() == pa.ragged_work_plan(
        bounds.cpu().numpy(), k_pages.shape[1]).tolist(),
        f"{label}: work != ceil(bound / P)")
    check(bool((out[bounds == 0] == 0).all()), f"{label}: pad rows not 0")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
    ms = cuda_ms(torch, lambda: pa.ragged_paged_attention(
        *args, schedule=cap), iters, flush)
    exact_ms = cuda_ms(torch, lambda: pa.ragged_paged_attention(
        *args, schedule=sched), iters, flush)
    plain_ms = cuda_ms(torch, lambda: pa.ragged_paged_attention_reference(
        *args), 3, flush)
    library_ms = cuda_ms(torch, sdpa_call(torch, *args), 10, flush)
    bound_ms, bound_by = bound(q, k_pages, token_seq, bounds)
    splits = sched.n_parts
    res = dict(label=label, dtype=dtype, tokens=int(q.shape[0]),
               live=int((bounds > 0).sum()),
               rows=len(set(token_seq[bounds > 0].tolist())),
               max_abs_err=err, ms=ms, exact_ms=exact_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               launches_per_call=sched.launches,
               split_units=sched.n_split_units,
               splits=splits)
    print(f"  {label:28s} {dtype[6:]:8s} T={res['tokens']:4d} "
          f"live={res['live']:4d} rows={res['rows']} D={q.shape[2]} "
          f"err={err:.3g} kernel={ms:.4f}ms (capacity table; exact table "
          f"{exact_ms:.4f}ms, bit-equal) plain={plain_ms:.4f}ms "
          f"sdpa={library_ms:.4f}ms bound={bound_ms:.4f}ms ({bound_by}) "
          f"bound/kernel={bound_ms / ms:.3f}; CUDA launches/call "
          f"{sched.launches} (tensor-core units {sched.n_tc}, CUDA-core "
          f"blocks {sched.n_cc}, split units {sched.n_split_units} in "
          f"{splits} splits, pads {sched.n_pad}; capacity {cap.n_tc} / "
          f"{cap.n_cc} / {cap.n_pad}, {cap.launches} launches)", flush=True)
    return res


def schedule_of(torch, pa, args, capacity=False):
    """The work units the wrapper builds for args (kernel #1's host
    planner, as the CUDA path runs it without a shipped schedule); with
    `capacity`, in the table padded to the capacity of args' (tokens,
    rows, width) signature, as a captured serving step ships it."""
    q, k_pages, _, page_table, token_seq, bounds = args
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    fold, kvh = q.shape[1] // k_pages.shape[2], k_pages.shape[2]
    tensor_cores = q.dtype == torch.bfloat16
    cap = pa.ragged_capacity(q.shape[0], *page_table.shape, fold, kvh,
                             tensor_cores, n_sms) if capacity else None
    return pa.ragged_schedule(
        token_seq.cpu().numpy(), bounds.cpu().numpy(), k_pages.shape[1],
        page_table.shape[1], fold, kvh, tensor_cores,
        n_rows=page_table.shape[0], n_sms=n_sms, capacity=cap)


def synthetic(torch, rows, pad_to, fold, dtype, rng, d=D):
    """Kernel inputs for rows [(history, new tokens)] at head_dim d: each
    row's pages are distinct random pages (0 is the pad page), T padded
    with bound-0 tokens."""
    seq, bd = [], []
    for r, (hist, n) in enumerate(rows):
        seq += [r] * n
        bd += [hist + k + 1 for k in range(n)]
    seq += [0] * (pad_to - len(seq))
    bd += [0] * (pad_to - len(bd))
    need = [-(-(hist + n) // P) for hist, n in rows]
    W = 1 << (max(need) - 1).bit_length()
    perm = 1 + rng.permutation(sum(need))
    pt = np.zeros((len(rows), W), np.int32)
    off = 0
    for r, n in enumerate(need):
        pt[r, :n] = perm[off:off + n]
        off += n
    n_pages = sum(need) + 1
    kvh = H // fold
    dev = torch.device("cuda")
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return [draw(pad_to, H, d), draw(n_pages, P, kvh, d),
            draw(n_pages, P, kvh, d)] + [
        torch.from_numpy(np.asarray(a, np.int32)).to(dev)
        for a in (pt, seq, bd)]


def phase_kernel(torch, pa, flush):
    rng = np.random.default_rng(SEED)
    hist = [63, 191, 299, 447, 511, 639, 699, 703]
    cases = [
        ("decode, 8 rows", [(h, 1) for h in hist], 8, 1),
        ("chunk 128 + 7 decode rows", [(256, 128)]
         + [(h, 1) for h in hist[:7]], 256, 1),
        ("3 decode rows + 5 pads", [(99, 1), (399, 1), (649, 1)], 8, 1),
        ("gqa fold 4, chunk + decode", [(128, 64), (80, 1), (300, 1),
                                        (600, 1)], 128, 4),
        ("lone 1023-token decode row", [(1022, 1)], 8, 1),
        ("D128 chunk 128 + 7 decode", [(256, 128)]
         + [(h, 1) for h in hist[:7]], 256, 1, 128),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, rows, pad_to, fold, *d in cases:
            args = synthetic(torch, rows, pad_to, fold, dtype, rng, *d)
            hold(torch, pa, args, flush, label)


def numpy_state(model, seed):
    """The reference's GPT init, drawn with numpy: Normal(0,
    initializer_range) weights and embeddings, zero biases, LayerNorm
    weight 1 and bias 0."""
    rng = np.random.default_rng(seed)
    std = np.float32(model.cfg.initializer_range)
    state = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        owner, leaf = name.split(".")[-2:]
        if owner.startswith("ln_"):
            state[name] = (np.ones if leaf == "weight" else np.zeros)(
                shape, np.float32)
        elif leaf == "bias":
            state[name] = np.zeros(shape, np.float32)
        else:
            state[name] = rng.standard_normal(shape, dtype=np.float32) * std
    return state


class Background:
    """fn() on a thread of its own; result() waits for it and re-raises
    its error."""

    def __init__(self, fn):
        import threading
        self._out = self._err = None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out = fn()
        except BaseException as e:  # re-raised in result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def card_state(torch, model, seed):
    """The reference's GPT init as numpy_state draws it (Normal(0,
    initializer_range) weights and embeddings, zero biases, LayerNorm
    weight 1 and bias 0), drawn on the card in float32 from a seeded CUDA
    generator: GPT-1.3B's 1.3e9 numpy draws took ~20 s of the host. The
    card-vs-CPU slices copy their layers from it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    std = float(model.cfg.initializer_range)
    state = {}
    for name, p in model.named_parameters():
        owner, leaf = name.split(".")[-2:]
        if owner.startswith("ln_"):
            fill = torch.ones if leaf == "weight" else torch.zeros
            state[name] = fill(p.shape, dtype=torch.float32, device="cuda")
        elif leaf == "bias":
            state[name] = torch.zeros(p.shape, dtype=torch.float32,
                                      device="cuda")
        else:
            state[name] = torch.empty(p.shape, dtype=torch.float32,
                                      device="cuda").normal_(
                0.0, std, generator=gen)
    return state


def make_prompts(vocab):
    """8 prompts, 64-640 tokens; the first two share a 128-token
    prefix."""
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(0, vocab, 128)
    first = np.concatenate([prefix, rng.integers(0, vocab, 64)])
    sharer = np.concatenate([prefix, rng.integers(0, vocab, 100)])
    return [first, sharer] + [rng.integers(0, vocab, n)
                              for n in (64, 160, 320, 448, 576, 640)]


def serve(GenerationEngine, model, prompts, engine_kw=SERVE, sampling=None):
    """The traffic on a new engine: the first prompt alone (on a paged
    cache it registers its prefix on finishing), then the other seven at
    once. Returns (engine, handles, streams, seconds of the second wave,
    seconds of both)."""
    eng = GenerationEngine(model, **engine_kw)
    try:
        handles, streams, wave_s, all_s = traffic(eng, prompts, sampling)
    finally:
        eng.shutdown()
    return eng, handles, streams, wave_s, all_s


def traffic(eng, prompts, sampling=None):
    """The first prompt alone, then the other seven at once, on a running
    engine; `sampling` a SamplingParams (or None: greedy) a prompt.
    Returns (handles, streams, seconds of the seven, seconds of both)."""
    sampling = sampling or [None] * len(prompts)
    t_all = time.perf_counter()
    h0 = eng.submit(prompts[0], sampling=sampling[0])
    streams = [h0.result(timeout=900).tolist()]
    t0 = time.perf_counter()
    hs = [eng.submit(p, sampling=sp)
          for p, sp in zip(prompts[1:], sampling[1:])]
    streams += [h.result(timeout=900).tolist() for h in hs]
    return ([h0] + hs, streams, time.perf_counter() - t0,
            time.perf_counter() - t_all)


def wave_sampling(n, sampled=(1, 3, 5, 7), seed=0):
    """SamplingParams(SAMPLED, seed=seed + i) for the requests i in
    `sampled`, None (greedy) for the others."""
    from paddle_tpu_torch.inference import SamplingParams
    return [SamplingParams(**SAMPLED, seed=seed + i) if i in sampled
            else None for i in range(n)]


def sort_kernels(by_name):
    """The profiled device kernels whose names say they sort."""
    return sorted(k for k in by_name if "sort" in k.lower())


def head_ms(torch, step, n=20):
    """Device ms of one replay of a captured step's greedy and sampled
    per-row heads (the LM head's product and the sampler), from a
    profile of n replays of each head graph alone (the layers' hidden
    states stay those of the step's last replay). Returns {sampled:
    ms}."""
    out = {}
    for sampled in (False, True):
        graph = step.heads[(False, sampled)][0]
        graph.replay()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                graph.replay()
            torch.cuda.synchronize()
        total = sum(device_us_by_name(prof).values())
        out[sampled] = total / n / 1e3 if total else None
    return out


def same_shape_prompts(prompts, seed, vocab):
    """Prompts of the lengths of `prompts` with new tokens, the second
    again sharing the first's 128-token prefix: the same traffic for the
    engine's shapes, none of it in the prefix registry yet."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 128)
    return [np.concatenate([prefix, rng.integers(0, vocab, p.size - 128)])
            for p in prompts[:2]] + [rng.integers(0, vocab, p.size)
                                     for p in prompts[2:]]


def graph_stats(torch, cache):
    """(captured steps, their capture ms summed, bytes of the memory pool
    the cache's graphs share) of an engine's cache."""
    state = cache._ragged_graphs
    steps = [st for st in state.steps.values() if st is not None]
    pool = tuple(state.pool)
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == pool)
    return len(steps), sum(st.capture_ms for st in steps), pool_bytes


def serve_graphs(torch, km, GenerationEngine, model, prompts, engine_kw,
                 kernel, device_kernel, label):
    """A model served through replayed CUDA graphs on one engine: wave A
    (untimed: each new signature captured inline), then wave B, the main
    path (counts set to 0 just before, read just after; timed), then
    wave C under the profiler; B and C with prompts of A's lengths and
    new tokens; `kernel` names the path's wrapper, `device_kernel` the
    part of its CUDA kernels' names the profile sums. Returns (the
    running engine, wave B's kernel launches {name: n})."""
    vocab = model.cfg.vocab_size
    layers = model.cfg.num_layers
    eng = GenerationEngine(model, **engine_kw)
    hA, sA, _, all_a = traffic(eng, prompts)
    caps, cap_ms, _ = graph_stats(torch, eng.cache)
    ttft = [h.t_first - h.t_submit for h in hA[1:]]
    print(f"  wave A (untimed): {eng.steps} steps, {caps} signatures "
          f"captured inline in {cap_ms:.1f}ms ({cap_ms / max(caps, 1):.1f}ms "
          f"each; retraces {eng.retraces}), TTFT mean "
          f"{np.mean(ttft) * 1e3:.1f}ms max {np.max(ttft) * 1e3:.1f}ms, "
          f"{all_a:.3f}s")
    check(caps == eng.retraces, f"{caps} captures, retraces {eng.retraces}")
    before = eng.steps, eng.retraces, eng.kernel_launches
    zero_counts(km)
    hB, sB, wave_s, all_s = traffic(
        eng, same_shape_prompts(prompts, SEED + 2, vocab))
    launches = counts(km)
    steps = eng.steps - before[0]
    retraces = eng.retraces - before[1]
    n = launches[kernel]
    check(all(len(st) == NEW_TOKENS for st in sA + sB),
          f"stream lengths {[len(st) for st in sA + sB]}")
    check(all(0 <= t < vocab for st in sA + sB for t in st),
          "token id out of range")
    # a replay launches the kernel once a layer, and so does the eager
    # run before each capture of a signature new in this wave
    check(n > 0 and n == (steps + retraces) * layers
          and eng.kernel_launches - before[2] == n,
          f"{kernel} launches {n} (engine {eng.kernel_launches - before[2]}) "
          f"!= (replays {steps} + captures {retraces}) x {layers}")
    ttft = [h.t_first - h.t_submit for h in hB[1:]]
    print(f"  wave B (main path, timed): {steps} steps = {steps} graph "
          f"replays, retraces {retraces}, {kernel} launches {n} = "
          f"(replays + captures) x {layers}")
    print(f"  wave of 7: {7 * NEW_TOKENS / wave_s:.1f} output tokens/s "
          f"({wave_s:.3f}s, prefill included); TTFT mean "
          f"{np.mean(ttft) * 1e3:.1f}ms max {np.max(ttft) * 1e3:.1f}ms; "
          f"wall {all_s / steps * 1e3:.2f}ms a step")
    s_c = eng.steps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        traffic(eng, same_shape_prompts(prompts, SEED + 3, vocab))
    by_name = where_the_time_goes(prof, eng.steps - s_c, all_s / steps,
                                  device_kernel, label)
    # every request greedy: each step replays the greedy head, no sort
    check(by_name and not sort_kernels(by_name),
          f"wave C (all greedy) ran sort kernels {sort_kernels(by_name)}")
    print("  wave C (profiled, all greedy): no sort kernel ran (the greedy "
          "heads)")
    sampled_wave(torch, eng, prompts, device_kernel, label)
    caps, cap_ms, pool_bytes = graph_stats(torch, eng.cache)
    print(f"  graphs: {caps} captured in {cap_ms:.1f}ms over the run; their "
          f"memory pool {pool_bytes / 2**20:.1f} MiB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return eng, launches


def sampled_wave(torch, eng, prompts, device_kernel, label):
    """Wave D on the running engine: wave B's prompt lengths with new
    tokens, the odd-numbered requests sampled (SAMPLED, seed = their
    index), the others greedy; timed, then the same again profiled (how
    many streams equal the first run's is printed: the second run finds
    the prompts in the prefix registry, so its prefill steps differ, and
    a bf16 near-tie can fall the other way); then one seeded request
    alone, twice: bit-equal streams.
    No signature is captured: wave A took both heads of each. Prints
    tokens/s, wall and device ms a step and retraces."""
    vocab = eng.model.cfg.vocab_size
    prompts_d = same_shape_prompts(prompts, SEED + 5, vocab)
    samp = wave_sampling(len(prompts_d))
    before = eng.steps, eng.retraces
    _, s_d, wave_s, all_s = traffic(eng, prompts_d, samp)
    steps, retraces = eng.steps - before[0], eng.retraces - before[1]
    check(retraces == 0, f"wave D captured {retraces} signatures: a "
                         f"sampled step needed a graph wave A did not take")
    check(all(len(st) == NEW_TOKENS and all(0 <= t < vocab for t in st)
              for st in s_d), "wave D: stream lengths or token ids")
    print(f"  wave D (half sampled: {SAMPLED}, seeds 1, 3, 5, 7): {steps} "
          f"steps = replays, retraces {retraces}; wave of 7: "
          f"{7 * NEW_TOKENS / wave_s:.1f} output tokens/s ({wave_s:.3f}s); "
          f"wall {all_s / steps * 1e3:.2f}ms a step")
    s0 = eng.steps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, s_d2, _, _ = traffic(eng, prompts_d, samp)
    by_name = where_the_time_goes(prof, eng.steps - s0, all_s / steps,
                                  device_kernel, label)
    check(sort_kernels(by_name), "wave D ran no sort kernel: the sampled "
                                 "heads did not run")
    same = sum(a == b for a, b in zip(s_d, s_d2))
    alone = [eng.submit(prompts_d[1], sampling=samp[1]).result(
        timeout=900).tolist() for _ in range(2)]
    check(alone[0] == alone[1], "a seeded request run twice alone gave two "
                                "streams")
    distinct = len({t for i, st in enumerate(s_d) if samp[i] for t in st})
    print(f"  wave D again (profiled): {same}/{len(s_d)} streams bit-equal "
          f"to the first run's; a seeded request alone twice: bit-equal; sort "
          f"kernels in the profile: {len(sort_kernels(by_name))}; distinct "
          f"tokens in the sampled streams: {distinct}")


# histories of the decode rows the replay checks build (PERF.md: served
# decode steps of phase 4 reach ~700 tokens)
CHECK_HIST = [63, 191, 299, 447, 511, 639, 699]


def shadow_cache(cache, pools):
    """A copy of `cache` over `pools` (in the model's _ragged_pools
    order): the eager body writes these instead of the cache's."""
    shadow = copy.copy(cache)
    it = iter(pools)
    if hasattr(cache, "k"):
        n = len(cache.k)
        shadow.k = [next(it) for _ in range(n)]
        shadow.v = [next(it) for _ in range(n)]
    else:
        n = len(cache.conv)
        shadow.conv = [next(it) for _ in range(n)]
        shadow.ssm = [next(it) for _ in range(n)]
    return shadow


def step_sampling(B, seed):
    """A step's per-row sampling arrays over B rows: the odd rows sampled
    (SAMPLED, keys of seed + row), the even ones greedy."""
    from paddle_tpu_torch.ops.threefry import sampling_key_data
    odd = np.arange(B) % 2 == 1
    return (np.where(odd, SAMPLED["temperature"], 0).astype(np.float32),
            np.where(odd, SAMPLED["top_k"], 0).astype(np.int32),
            np.where(odd, SAMPLED["top_p"], 1).astype(np.float32),
            np.stack([sampling_key_data(seed + r) for r in range(B)]))


def replay_vs_eager(torch, model, cache, rows, n_tokens, width_of, record,
                    sampling=None, per_token=False):
    """One step of `rows` through the engine's path (a replay of its
    signature's graphs: the layers and the head of the step's sampling
    and `per_token`) against the same step's layers and head run eagerly
    on a copy of the pools taken before it, with the plan the replay
    copied in: logits, next tokens (per token too) and every pool
    bit-equal. `record(shadow)` is a context manager around the eager run
    (it keeps layer 0's kernel inputs). Returns (T, B, W, pool pages /
    slots the step wrote, the CapturedStep)."""
    before = [t.clone() for t in model._ragged_pools(cache)]
    B = 8
    out = model.paged_ragged_step(cache, rows, pad_to_tokens=n_tokens,
                                  pad_to_rows=B, sampling=sampling,
                                  return_per_token=per_token)
    after = model._ragged_pools(cache)
    written = sum(int((a != b).flatten(1).any(dim=1).sum())
                  for a, b in zip(after, before))
    W = width_of([s for s, _ in rows])
    step = model.ragged_graph(cache, n_tokens, B, W)
    check(step is not None and step.replays > 0,
          f"signature {(n_tokens, B, W)} was not replayed")
    variant = (sampling is not None and bool(np.any(sampling[0] > 0)),
               per_token)
    check(step.variant == variant, f"the step replayed the head "
                                   f"{step.variant}, not {variant}")
    host = step.host.copy()
    shadow = shadow_cache(cache, before)
    with record(shadow):
        eager = model.run_ragged_body(shadow, host, n_tokens, B, W,
                                      *variant)
    torch.cuda.synchronize()
    n = len(rows)
    check(torch.equal(out[0], eager[0][:n])
          and torch.equal(out[1], eager[1][:n])
          and (not per_token or torch.equal(out[2], eager[2])),
          f"replayed step (T={n_tokens}, W={W}, head {variant}): logits or "
          f"tokens differ from the eager body's")
    pools = model._ragged_pools(shadow)
    bad = [i for i, (a, b) in enumerate(zip(after, pools))
           if not torch.equal(a, b)]
    check(not bad, f"replayed step (T={n_tokens}, W={W}): pools {bad} "
                   f"differ from the eager body's")
    return n_tokens, B, W, written, step


def hold_replays(torch, model, cache, width_of, record):
    """A mixed step (a 128-token chunk and 7 decode rows, histories
    CHECK_HIST) and a pure decode step of 8 rows, each replayed and held
    against its eager body (`replay_vs_eager`); the histories are
    prefilled first, 128 tokens a step. Runs on the engine's cache while
    the engine is idle; frees its sequences after."""
    rng = np.random.default_rng(SEED + 4)
    vocab = model.cfg.vocab_size
    sids = [f"check{i}" for i in range(8)]
    with cache.lock:
        for sid in sids:
            cache.add_sequence(sid)
    try:
        for sid, hist in zip(sids[1:], CHECK_HIST):
            for done in range(0, hist, 128):
                k = min(128, hist - done)
                model.paged_ragged_step(
                    cache, [(sid, rng.integers(0, vocab, k))],
                    pad_to_tokens=max(1 << (k - 1).bit_length(), 8),
                    pad_to_rows=1)
        one = lambda: rng.integers(0, vocab, 1)  # noqa: E731
        for kind, rows, T, samp in (
                ("mixed", [(sids[0], rng.integers(0, vocab, 128))]
                 + [(sid, one()) for sid in sids[1:]], 256, None),
                ("decode", [(sid, one()) for sid in sids], 8, None),
                ("sampled mixed", [(sids[0], rng.integers(0, vocab, 128))]
                 + [(sid, one()) for sid in sids[1:]], 256,
                 step_sampling(8, SEED + 6))):
            T, B, W, written, step = replay_vs_eager(
                torch, model, cache, rows, T, width_of, record(kind), samp)
            print(f"  replayed {kind} step (T={T}, B={B}, W={W}) against "
                  f"its eager layers and {'sampled' if samp else 'greedy'} "
                  f"head on a copy of the pools: logits, tokens "
                  f"and every pool bit-equal ({written} pool pages/slots "
                  f"written)")
        ms = head_ms(torch, step)
        sampler = None if None in ms.values() else ms[True] - ms[False]
        print(f"  heads of that step's graph (8 rows, vocab {vocab}), "
              f"profiled replays: sampled {ms[True]} ms, greedy {ms[False]} "
              f"ms: the sampler's device time {sampler} ms a sampled step")
    finally:
        with cache.lock:
            for sid in sids:
                cache.free_sequence(sid)


def phase_serve(torch, pa, flush, km, mods):
    """GPT-medium bf16 served through replayed CUDA graphs (wave B the
    main path, `serve_graphs`), the host planner timed in wave B; then a
    replayed mixed and decode step against their eager bodies, whose
    layer-0 kernel inputs the paged kernel is held against its twin on
    (and the capacity table against the exact one)."""
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, gpt_mod = mods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    t = time.perf_counter()
    state = numpy_state(model, SEED)
    load_state(model, state)
    torch.cuda.synchronize()
    print(f"  weights drawn and loaded in {time.perf_counter() - t:.1f}s "
          f"({sum(a.size for a in state.values())} parameters)")
    prompts = make_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    # the host planner's time (the cache's step plan and kernel #1's
    # schedule, both numpy) summed over the run's steps
    planner = {"plan_ragged": 0.0, "step_schedule": 0.0}
    cache_cls = gpt_mod.PagedKVCache
    real_plan, real_sched = cache_cls.plan_ragged, gpt_mod.step_schedule

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                planner[name] += time.perf_counter() - t
        return call

    cache_cls.plan_ragged = timed("plan_ragged", real_plan)
    gpt_mod.step_schedule = timed("step_schedule", real_sched)
    try:
        eng, launches = serve_graphs(
            torch, km, GenerationEngine, model, prompts, SERVE,
            "ragged_paged_attention", "paged_", "attention kernel")
    finally:
        cache_cls.plan_ragged = real_plan
        gpt_mod.step_schedule = real_sched
    try:
        n = launches.pop("ragged_paged_attention")
        check(not any(launches.values()),
              f"other kernels ran while serving GPT: {launches}")
        hits = eng.cache.prefix_stats()["prefix_hit_tokens"]
        check(hits >= 128, f"prefix cache served {hits} tokens, want >= 128")
        print(f"  prefix-cache tokens {hits}; host planner per step over the "
              f"run: PagedKVCache.plan_ragged "
              f"{planner['plan_ragged'] / eng.steps * 1e6:.1f}us + kernel "
              f"#1's schedule {planner['step_schedule'] / eng.steps * 1e6:.1f}"
              f"us (both numpy, once a step for all {cfg.num_layers} layers)")

        best = {}
        real = gpt_mod.ragged_paged_attention

        def record(kind):
            """Around the eager body of the `kind` step: keep layer 0's
            kernel inputs (its pools are the shadow's first)."""
            @contextlib.contextmanager
            def around(shadow):
                def call(q, k_pages, v_pages, page_table, token_seq, bounds,
                         **kw):
                    if k_pages is shadow.k[0]:
                        best[kind] = [t.clone() for t in (
                            q, k_pages, v_pages, page_table, token_seq,
                            bounds)]
                    return real(q, k_pages, v_pages, page_table, token_seq,
                                bounds, **kw)
                gpt_mod.ragged_paged_attention = call
                try:
                    yield
                finally:
                    gpt_mod.ragged_paged_attention = real
            return around

        def width_of(sids):
            pages = max(len(eng.cache._tables[s]) for s in sids)
            return 1 << (pages - 1).bit_length()

        hold_replays(torch, model, eng.cache, width_of, record)
    finally:
        eng.shutdown()
    held = {kind: hold(torch, pa, best[kind], flush,
                       f"served {kind} step, layer 0")
            for kind in ("decode", "mixed")}
    args = best["decode"]
    sched = schedule_of(torch, pa, args, capacity=True)
    sched.dev = sched.on(args[0].device)
    us = host_us(torch, lambda: pa.ragged_paged_attention(
        *args, schedule=sched))
    print(f"  wrapper host time per call (served decode step, schedule "
          f"shipped), eager: {us:.1f}us; a replay skips it")
    return n, held, prompts, state, model


def device_events(prof):
    """[(name, start µs, duration µs)] of the device operations in a
    profiled window (kernels, copies, memsets, and the device-side spans
    of record_function ranges), read from the profiler's Kineto events:
    the events `prof.events()` builds its FunctionEvents from, without
    the CPU operator tree it also builds (the smoke's slowest host work
    before)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_us_by_name(prof):
    """{kernel name: device microseconds} over a profiled window."""
    by_name = {}
    for name, _, us in device_events(prof):
        # the epilogue's record_function range also shows on the device
        # as an annotation spanning its kernels: not a kernel
        if name != EPILOGUE:
            by_name[name] = by_name.get(name, 0.0) + us
    return by_name


def where_the_time_goes(prof, steps, wall_s_per_step,
                        kernel="paged_", label="attention kernel"):
    """Device kernel time per step by kernel, from the profiled replay,
    against the unprofiled run's wall time per step; `kernel` names the
    path's own kernel, whose share is printed as `label`. Returns the
    device microseconds by kernel name (empty when the profiler saw no
    device events)."""
    by_name = device_us_by_name(prof)
    total_us = sum(by_name.values())
    if not total_us:
        print("  device time per step: not measured (the profiler saw no "
              "device events)")
        return by_name
    dev_ms = total_us / steps / 1e3
    wall_ms = wall_s_per_step * 1e3
    own = sum(v for k, v in by_name.items() if kernel in k) / steps / 1e3
    print(f"  per step: wall {wall_ms:.2f}ms (unprofiled run), device "
          f"kernels {dev_ms:.2f}ms (profiled replay), idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}; {label} "
          f"{own:.3f}ms = {own / dev_ms:.3f} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / steps / 1e3:8.3f}ms/step  {name[:90]}")
    return by_name


def first_layers(state, n):
    """The state dict of the model cut to its first n blocks."""
    return {k: v for k, v in state.items()
            if not k.startswith("gpt.h.") or int(k.split(".")[2]) < n}


def top2_gap(torch, model, tokens):
    """CPU top-2 logit gap of the next token after `tokens`."""
    cache = model.make_paged_cache(n_pages=2 + len(tokens) // P,
                                   page_size=P)
    cache.add_sequence("s")
    last, _ = model.paged_ragged_step(cache, [("s", tokens)])
    top = torch.topk(last[0].float(), 2).values
    return float(top[0] - top[1])


def sampler_view(torch, logits, sp, pos):
    """What a sampled request's draw sees after the next-token logits [V]
    (float32): (v, cut), v = logits / temperature plus the request's
    gumbel noise at position `pos` (the context's last token), and cut
    the least logit the sampler's top-k and nucleus filters keep
    (models/gpt.py `sample_token_rows`); the draw is the argmax of v over
    the logits >= cut."""
    from paddle_tpu_torch.ops import threefry as tf
    V = logits.shape[-1]
    scale = 1.0 / max(sp.temperature, 1e-6)
    arr = logits * scale
    srt = torch.sort(arr, descending=True).values
    kth = srt[min(sp.top_k or V, V) - 1]
    srt = torch.where(srt < kth, -1e30, srt)
    p = torch.softmax(srt, -1)
    before = torch.cumsum(p, -1) - p
    top_p = 1.0 if sp.top_p is None else sp.top_p
    thresh = torch.where(before < top_p, srt, float("inf")).min()
    key = tf.key_words(sp.key_data()[None]).to(arr.device)
    noise = tf.gumbel(tf.fold_in(key, torch.tensor([pos], device=arr.device)),
                      V)[0]
    return arr + noise, float(torch.maximum(kth, thresh)) / scale


def gap_rule(limit):
    """The top-2 gap of the decision at a mismatch (of the logits, or of
    the perturbed values the draw takes the argmax of) at most `limit`."""
    def rule(torch, logits, sp, pos, a, b):
        if sp is None:
            vals = logits
        else:
            v, cut = sampler_view(torch, logits, sp, pos)
            vals = torch.where(logits >= cut, v, -1e30)
        top = torch.topk(vals, 2).values
        gap = float(top[0] - top[1])
        return gap <= limit, (f"{'greedy' if sp is None else 'perturbed'} "
                              f"top-2 gap {gap:.3g} (limit {limit:.3g})")
    return rule


def bf16_rule(torch, logits, sp, pos, a, b):
    """Both tokens of a mismatch are possible outcomes when every logit of
    either path may lie within tol = BF16_ULPS bf16 ulps of the largest
    |logit| of `logits` (the decision recomputed on its own path): greedy,
    both within 2 tol of the largest logit (the tier-1 bf16 tests' top-2
    gap rule, for the two tokens emitted); sampled, both in the filters'
    reach (a logit >= the cut - 2 tol) with a perturbed value within
    2 tol / temperature of the best among the logits surely kept (>= the
    cut + 2 tol, and the argmax)."""
    big = float(logits.abs().max())
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7)
    if sp is None:
        top = float(logits.max())
        ok = min(float(logits[a]), float(logits[b])) >= top - 2 * tol
        return ok, (f"greedy: logits {float(logits[a]):.4g} / "
                    f"{float(logits[b]):.4g}, largest {top:.4g}, tol {tol:.3g}")
    v, cut = sampler_view(torch, logits, sp, pos)
    sure = logits >= cut + 2 * tol
    sure[int(torch.argmax(logits))] = True
    best = float(torch.where(sure, v, -1e30).max())
    slack = 2 * tol / sp.temperature

    def possible(x):
        return float(logits[x]) >= cut - 2 * tol and float(v[x]) >= best - slack

    return possible(a) and possible(b), (
        f"sampled: logits {float(logits[a]):.4g} / {float(logits[b]):.4g}, "
        f"filter cut {cut:.4g}, perturbed {float(v[a]):.4g} / "
        f"{float(v[b]):.4g}, best surely kept {best:.4g}, tol {tol:.3g}")


def next_logits(torch, model, tokens):
    """The model's next-token logits [V] after `tokens`, one prefill row
    on a cache of its own (on the model's device)."""
    cache = model.make_paged_cache(n_pages=2 + len(tokens) // P,
                                   page_size=P)
    cache.add_sequence("s")
    last, _ = model.paged_ragged_step(cache, [("s", tokens)])
    return last[0]


def first_mismatches(torch, model, prompts, got, want, sampling, label,
                     rule):
    """Each stream of `got` against `want`: equal, or at the first
    mismatch the decision excused by `rule` (`gap_rule`, `bf16_rule`),
    judged on `model`'s logits there, its own computation (printed).
    Returns the count of equal streams."""
    equal = 0
    for r, (a, b) in enumerate(zip(got, want)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            check(len(a) == len(b), f"{label}: request {r}: lengths "
                                    f"{len(a)} and {len(b)}")
            equal += 1
            continue
        ctx = np.concatenate([prompts[r], np.asarray(b[:i])])
        logits = next_logits(torch, model, ctx).float()
        ok, why = rule(torch, logits, sampling[r], len(ctx) - 1, a[i], b[i])
        print(f"  {label}: request {r}: first mismatch at generated token "
              f"{i} ({a[i]} against {b[i]}), {why}")
        check(ok, f"{label}: request {r} diverges at token {i}: {why}")
    return equal


def hold_verify(torch, model, cache, width_of):
    """A verify-shaped step on a speculative engine's target cache: 8
    rows of an anchor and SPEC_K proposals (40 tokens, padded to 64),
    histories of CHECK_HIST, the odd rows sampled, through the per-token
    sampled head; replayed and held against its eager layers and head
    (`replay_vs_eager`). Frees its sequences after."""
    rng = np.random.default_rng(SEED + 9)
    vocab = model.cfg.vocab_size
    sids = [f"verify{i}" for i in range(8)]
    with cache.lock:
        for sid in sids:
            cache.add_sequence(sid)
    try:
        for sid, hist in zip(sids, [31] + CHECK_HIST):
            for done in range(0, hist, 128):
                k = min(128, hist - done)
                model.paged_ragged_step(
                    cache, [(sid, rng.integers(0, vocab, k))],
                    pad_to_tokens=max(1 << (k - 1).bit_length(), 8),
                    pad_to_rows=1)
        rows = [(sid, rng.integers(0, vocab, SPEC_K + 1)) for sid in sids]
        T, B, W, written, _ = replay_vs_eager(
            torch, model, cache, rows, 64, width_of,
            lambda shadow: contextlib.nullcontext(),
            step_sampling(8, SEED + 10), per_token=True)
        print(f"  replayed verify step (T={T}, B={B}, W={W}: 8 rows of "
              f"{SPEC_K + 1} tokens, per-token sampled head) against its "
              f"eager layers and head on a copy of the pools: logits, row "
              f"and per-token tokens and every pool bit-equal ({written} "
              f"pool pages written)")
    finally:
        with cache.lock:
            for sid in sids:
                cache.free_sequence(sid)


def phase_speculative(torch, pa, mods, model, state, prompts):
    """Speculative decoding on GPT-medium bf16 (phase 4's model, the
    target) with a layer-truncated self-draft (its first DRAFT_LAYERS
    blocks, embeddings and final LayerNorm by name), k = SPEC_K: a greedy
    wave and a sampled wave on one engine, the sampled wave again with
    the draft's temperature at DRAFT_TEMPERATURE on another. Streams
    against a non-speculative engine's on the same prompts and seeds
    under the bf16 gap rule; acceptances and rejections both seen;
    kernel #1's launches over the speculative runs exactly (target
    replays + captures) x 24 + (draft replays + captures) x
    DRAFT_LAYERS; then a replayed verify step against its eager body."""
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    from paddle_tpu_torch.inference import SpeculativeConfig
    cfg = gpt_medium()
    cfg.num_layers = DRAFT_LAYERS
    draft = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(draft, first_layers(state, DRAFT_LAYERS))
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    waves = {"greedy": (same_shape_prompts(prompts, SEED + 7, vocab),
                        [None] * len(prompts)),
             "sampled": (same_shape_prompts(prompts, SEED + 8, vocab),
                         wave_sampling(len(prompts), range(len(prompts)),
                                       seed=100))}
    plain = GenerationEngine(model, **SERVE)
    try:
        want = {name: traffic(plain, p, sp)[1]
                for name, (p, sp) in waves.items()}
    finally:
        plain.shutdown()
    pa.ragged_paged_attention.launches = 0
    traces = model._ragged_traces, draft._ragged_traces
    totals = dict(steps=0, draft_steps=0, proposed=0, accepted=0)
    engines, streams = [], []
    for run, draft_temp, names in (("k=4", None, ("greedy", "sampled")),
                                   (f"k=4, draft temperature "
                                    f"{DRAFT_TEMPERATURE}", DRAFT_TEMPERATURE,
                                    ("sampled",))):
        eng = GenerationEngine(model, speculative=SpeculativeConfig(
            draft, k=SPEC_K, draft_temperature=draft_temp), **SERVE)
        engines.append(eng)
        try:
            # untimed, as wave A: the new caches' signatures captured
            warm = traffic(eng, same_shape_prompts(prompts, SEED + 11, vocab),
                           wave_sampling(len(prompts)))[1]
            check(all(len(st) == NEW_TOKENS for st in warm),
                  f"{run}: warm-up stream lengths")
            for k in totals:
                totals[k] += getattr(eng, {"proposed": "_spec_proposed",
                                           "accepted": "_spec_accepted"}
                                     .get(k, k))
            print(f"  {run}: warm-up wave (untimed): {eng.steps} target "
                  f"steps, {eng.draft_steps} draft steps, retraces "
                  f"{eng.retraces}")
            for name in names:
                prompts_w, samp = waves[name]
                before = (eng.steps, eng.draft_steps, eng._spec_proposed,
                          eng._spec_accepted)
                _, got, wave_s, all_s = traffic(eng, prompts_w, samp)
                steps, dsteps, prop, acc = (
                    a - b for a, b in zip((eng.steps, eng.draft_steps,
                                           eng._spec_proposed,
                                           eng._spec_accepted), before))
                streams.append((f"{run}, {name} wave", prompts_w, got,
                                want[name], samp))
                equal = sum(a == b for a, b in zip(got, want[name]))
                print(f"  {run}, {name} wave: accept rate "
                      f"{acc / max(prop, 1):.3f} ({acc} of {prop} proposed), "
                      f"{7 * NEW_TOKENS / wave_s:.1f} output tokens/s (wave "
                      f"of 7, {wave_s:.3f}s), {steps} target steps, {dsteps} "
                      f"draft steps, wall {all_s / steps * 1e3:.2f}ms a "
                      f"target step (its draft steps included); streams "
                      f"bit-equal to the non-speculative engine's: "
                      f"{equal}/{len(got)}")
                for k, v in zip(("steps", "draft_steps", "proposed",
                                 "accepted"), (steps, dsteps, prop, acc)):
                    totals[k] += v
        finally:
            eng.shutdown()
    launches = pa.ragged_paged_attention.launches
    t_caps = model._ragged_traces - traces[0]
    d_caps = draft._ragged_traces - traces[1]
    want_n = (totals["steps"] + t_caps) * layers \
        + (totals["draft_steps"] + d_caps) * DRAFT_LAYERS
    check(launches == want_n, f"ragged_paged_attention launches {launches} "
                              f"!= (target replays {totals['steps']} + "
                              f"captures {t_caps}) x {layers} + (draft "
                              f"replays {totals['draft_steps']} + captures "
                              f"{d_caps}) x {DRAFT_LAYERS} = {want_n}")
    rejected = totals["proposed"] - totals["accepted"]
    check(totals["accepted"] > 0 and rejected > 0,
          f"accepted {totals['accepted']}, rejected {rejected}: want both")
    print(f"  over the phase: {totals['accepted']} accepted and {rejected} "
          f"rejected of {totals['proposed']} proposed (accept rate "
          f"{totals['accepted'] / totals['proposed']:.3f}); "
          f"ragged_paged_attention launches {launches} = (target replays "
          f"{totals['steps']} + captures {t_caps}) x {layers} + (draft "
          f"replays {totals['draft_steps']} + captures {d_caps}) x "
          f"{DRAFT_LAYERS}")
    # the mismatches' own steps (`next_logits`) come after the count
    for label, prompts_w, got, want_w, samp in streams:
        equal = first_mismatches(torch, model, prompts_w, got, want_w, samp,
                                 label, bf16_rule)
        print(f"  {label}: {equal}/{len(got)} streams bit-equal, every "
              f"other one excused at its first mismatch by the bf16 rule")
    cache = engines[0].cache

    def width_of(sids):
        pages = max(len(cache._tables[s]) for s in sids)
        return 1 << (pages - 1).bit_length()

    hold_verify(torch, model, cache, width_of)
    del draft, engines
    torch.cuda.empty_cache()


AGREE_LAYERS = 2  # the card-vs-CPU slices' depth


def agreement_cpu_half(torch, pa, mods):
    """Phase 5's CPU half (run beside the build; it needs no card): the
    2-layer float32 GPT-medium on the CPU (twins) from numpy_state drawn
    on the 2-layer model itself, which is phase 4's state cut to its first
    2 blocks (numpy_state draws in named_parameters order, wte, wpe and
    the first blocks first; phase 5 holds the equality), serving phase 4's
    prompts greedy and sampled, no kernel launched. Returns (the prompts,
    the 2-layer state, (model, greedy streams, sampled streams))."""
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    cfg = gpt_medium()
    cfg.num_layers = AGREE_LAYERS
    prompts = make_prompts(cfg.vocab_size)
    model = GPTForCausalLM(cfg, device="cpu")
    small = numpy_state(model, SEED)
    load_state(model, small)
    before = pa.ragged_paged_attention.launches
    streams = serve(GenerationEngine, model, prompts)[2]
    samp = wave_sampling(len(prompts), range(len(prompts)), seed=200)
    sampled = serve(GenerationEngine, model, prompts, sampling=samp)[2]
    check(pa.ragged_paged_attention.launches == before,
          f"cpu: {pa.ragged_paged_attention.launches - before} launches")
    return prompts, small, (model, streams, sampled)


def phase_agreement(torch, pa, mods, prompts, state, cpu_half):
    """The 2-layer float32 GPT-medium served on the card (kernels)
    against `cpu_half` (agreement_cpu_half, run beside the build) on the
    same weights: its weights phase 4's first 2 blocks exactly, its
    prompts phase 4's; greedy streams equal or the CPU's top-2 gap at the
    first mismatch within GAP_LIMIT, sampled streams by the same rule."""
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt_medium()
    cfg.num_layers = AGREE_LAYERS
    small = first_layers(state, cfg.num_layers)
    cpu_prompts, cpu_small, cpu_run = cpu_half
    check(cpu_small.keys() == small.keys() and all(
        np.array_equal(cpu_small[k], small[k]) for k in small),
        "5: the CPU half's weights are not phase 4's first blocks")
    check(len(cpu_prompts) == len(prompts) and all(
        np.array_equal(a, b) for a, b in zip(cpu_prompts, prompts)),
        "5: the CPU half's prompts are not phase 4's")
    runs = {"cpu": cpu_run}
    samp = wave_sampling(len(prompts), range(len(prompts)), seed=200)
    model = GPTForCausalLM(cfg, device="cuda")
    load_state(model, small)
    pa.ragged_paged_attention.launches = 0
    eng, _, streams, _, _ = serve(GenerationEngine, model, prompts)
    # a launch a layer for each replay and for the eager run before each
    # capture
    want = (eng.steps + eng.retraces) * cfg.num_layers
    check(pa.ragged_paged_attention.launches == want,
          f"cuda: {pa.ragged_paged_attention.launches} launches, want {want}")
    sampled = serve(GenerationEngine, model, prompts, sampling=samp)[2]
    runs["cuda"] = (model, streams, sampled)
    cpu_model, cpu, cpu_sampled = runs["cpu"]
    equal = first_mismatches(torch, cpu_model, prompts, runs["cuda"][2],
                             cpu_sampled, samp, "sampled (seeds 200-207)",
                             gap_rule(GAP_LIMIT))
    print(f"  2-layer float32 sampled streams ({SAMPLED}) equal on card and "
          f"CPU: {equal}/{len(cpu_sampled)} requests")
    gpu = runs["cuda"][1]
    equal = 0
    for r, (a, b) in enumerate(zip(gpu, cpu)):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            equal += 1
            continue
        ctx = np.concatenate([prompts[r], np.asarray(b[:i])])
        gap = top2_gap(torch, cpu_model, ctx)
        print(f"  request {r}: first mismatch at generated token {i} "
              f"(cuda {a[i]}, cpu {b[i]}), cpu top-2 logit gap {gap:.3g}")
        check(gap <= GAP_LIMIT, f"request {r} diverges at token {i} with a "
                                f"top-2 gap {gap} > {GAP_LIMIT}")
    print(f"  2-layer float32 greedy streams equal on card and CPU: "
          f"{equal}/{len(gpu)} requests")


# -- training: flash attention kernels and the GPT-medium train step --------

FLASH_KERNELS = (
    ("flash_attention_fwd", "paddle_tpu/ops/pallas/flash_attention.py:34"),
    ("flash_attention_dq", "paddle_tpu/ops/pallas/flash_attention.py:70"),
    ("flash_attention_dkv", "paddle_tpu/ops/pallas/flash_attention.py:111"),
)
# largest |kernel - twin| over the largest |twin|: float32 sums in another
# order; bfloat16 adds one output rounding (2^-8) on each side, float16
# one of 2^-11 (and P, dS rounded to float16 before their products)
FLASH_REL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2,
             "torch.float16": 5e-3}
TRAIN = dict(batch=8, seq=1024, lr=1e-4, warmup=3, timed=10)
# GPT-1.3B's step: bench.py's batch (4 x 1024) and learning rate
TRAIN_1P3B = dict(batch=4, seq=1024, lr=1e-4, warmup=2, timed=5)
# phase 7's fifth run (K2's path): short, its per-leaf code is host-bound
TRAIN_K2 = dict(batch=8, seq=1024, lr=1e-4, warmup=1, timed=3)
# phase 7c: bench.py's GPT-1.3B headline (bench.py:667-714): its 2 warm-up
# and 8 timed steps under remat "dots"; True and "names" for their ms and
# peak; the chunked loss's chunk (bench.py:693)
BENCH_1P3B = dict(batch=4, seq=1024, lr=1e-4, warmup=2, timed=8)
BENCH_1P3B_OTHER = dict(BENCH_1P3B, warmup=1, timed=3)
BENCH_CHUNK = 2048
# phase 7c's launches a step, worked out from the code for GPT-1.3B (24
# blocks) under every remat policy: each block's recompute runs its
# forward again up to fc_out's product, so the flash forward (#2) and
# ln_1 / ln_2 (#5) run twice a block; ln_f (outside the blocks) and every
# backward once; #7 and #8 once a chunk (4 x 1024 tokens / 2048); the
# tree update once (292 leaves, one group)
BENCH_1P3B_LAUNCHES = {"flash_attention_fwd": 48, "flash_attention_dq": 24,
                       "flash_attention_dkv": 24, "layer_norm_fwd": 97,
                       "layer_norm_bwd": 49, "softmax_xent_fwd": 2,
                       "softmax_xent_bwd": 2, "tree_update": 1,
                       "fused_pass1": 0, "fused_pass2": 0,
                       "stochastic_round": 0}
BENCH_LOSS_RTOL = 1e-3  # 7c's step-1 loss against 7b's bench-optimizer run
GPT_1P3B_PARAMS = 1_313_722_368  # vocab 50304, 1024 positions, tied head
# GPT-1.3B's loss at its last timed step as recorded before the LayerNorm kernels' row
# layouts, from numpy-drawn weights (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# section 5): printed beside each run's (now from card-drawn weights of the
# same distribution), not held
GPT_1P3B_RECORDED_LAST_LOSS = 6.7104
EPILOGUE = "TrainStep.epilogue"  # TrainStep's record_function range
AGREE = dict(layers=2, batch=2, seq=256, steps=3, rtol=1e-3)


def flash_ops(kind, q, k, causal):
    """Operations of one flash call: 2*D per (row, visible key) per
    product: 2 products forward (q.k, p.v), 3 for dQ (q.k, dO.v, ds.k),
    4 for dK/dV (q.k, dO.v, p^T.dO, ds^T.q); visible keys counted
    exactly (causal: row >= col)."""
    B, Tq, Hh, Dh = q.shape
    Tk = k.shape[1]
    pairs = sum(min(r + 1, Tk) for r in range(Tq)) if causal else Tq * Tk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    return 2 * Dh * products * pairs * B * Hh


def flash_bound(kind, q, k, causal):
    """(ms, "bytes"|"operations") for one flash call on these inputs:
    its operations (flash_ops) at the dtype's peak, or its bytes, each
    input read once and each output written once: forward q, k, v ->
    out, lse; dQ q, k, v, dO, lse, delta -> dq; dK/dV the same inputs ->
    dk, dv."""
    B, Tq, Hh, Dh = q.shape
    Tk = k.shape[1]
    ops = flash_ops(kind, q, k, causal)
    it = q.element_size()
    row_q, row_k, vec = B * Tq * Hh * Dh * it, B * Tk * Hh * Dh * it, \
        B * Hh * Tq * 4
    n_bytes = {"fwd": row_q + 2 * row_k + row_q + vec,
               "dq": 2 * row_q + 2 * row_k + 2 * vec + row_q,
               "dkv": 2 * row_q + 2 * row_k + 2 * vec + 2 * row_k}[kind]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(q.dtype)]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_train_calls(torch, q, k, v, do, causal):
    """(forward, backward) of one PyTorch call computing the same
    attention: scaled_dot_product_attention on [B, H, T, D] copies made
    outside the timing; the backward computes dq, dk and dv together."""
    Q, K, V = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in (q, k, v))
    dO = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(Q, K, V, is_causal=causal)
    return (lambda: sdpa(Q, K, V, is_causal=causal),
            lambda: torch.autograd.grad(out, (Q, K, V), dO,
                                        retain_graph=True))


def hold_flash(torch, fa, flush, label, B, tq, tk, d, causal, dtype, rng,
               heads=H, spin=2_000_000):
    """The three flash kernels against their twins on one shape
    [B, T, heads, d], q/k/v strided views of one fused [B, T, 3, heads,
    d] tensor as GPT makes them; the backward kernels and twins take the
    twin's lse and delta. Then each kernel's, twin's and library call's
    time and the bound (each call timed after a spin of `spin` cycles,
    which a loaded host needs longer to cover). Returns {kernel name:
    measurements}."""
    dev = torch.device("cuda")
    qkv = torch.from_numpy(rng.standard_normal(
        (B, max(tq, tk), 3, heads, d), dtype=np.float32)).to(dev, dtype)
    q, k, v = qkv.unbind(dim=2)
    q, k, v = q[:, :tq], k[:, :tk], v[:, :tk]
    do = torch.from_numpy(rng.standard_normal(
        (B, tq, heads, d), dtype=np.float32)).to(dev, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal)
    delta = (want.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, want_lse, delta)
    dq = fa.flash_attention_dq(*bwd, causal=causal)
    dk, dv = fa.flash_attention_dkv(*bwd, causal=causal)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_dq_reference(*bwd, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*bwd, causal)
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= 1e-4, f"{label}: lse differs by {lse_err}")
    errs = {}
    for name, got, ref in (("out", out, want), ("dq", dq, want_dq),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: {name} not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        check(rel <= FLASH_REL[str(dtype)],
              f"{label}: {name} max |kernel - twin| / max |twin| = {rel} > "
              f"{FLASH_REL[str(dtype)]}")
        errs[name] = err
    res = {"flash_attention_fwd": dict(max_abs_err=max(errs["out"],
                                                       lse_err)),
           "flash_attention_dq": dict(max_abs_err=errs["dq"]),
           "flash_attention_dkv": dict(max_abs_err=max(errs["dk"],
                                                       errs["dv"]))}
    print(f"  {label:40s} {str(dtype)[6:]:8s} err out {errs['out']:.3g} "
          f"lse {lse_err:.3g} dq {errs['dq']:.3g} dk {errs['dk']:.3g} "
          f"dv {errs['dv']:.3g}", flush=True)
    lib_fwd, lib_bwd = sdpa_train_calls(torch, q, k, v, do, causal)
    lib = {"fwd": cuda_ms(torch, lib_fwd, 10, flush, spin=spin),
           "bwd": cuda_ms(torch, lib_bwd, 10, flush, spin=spin)}
    calls = {
        "flash_attention_fwd": ("fwd", lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal), lambda: fa.flash_attention_fwd_reference(
                q, k, v, causal), lib["fwd"]),
        "flash_attention_dq": ("dq", lambda: fa.flash_attention_dq(
            *bwd, causal=causal), lambda: fa.flash_attention_dq_reference(
                *bwd, causal), lib["bwd"]),
        "flash_attention_dkv": ("dkv", lambda: fa.flash_attention_dkv(
            *bwd, causal=causal), lambda: fa.flash_attention_dkv_reference(
                *bwd, causal), lib["bwd"]),
    }
    for name, (kind, kernel, twin, library_ms) in calls.items():
        bound_ms, bound_by = flash_bound(kind, q, k, causal)
        ms = cuda_ms(torch, kernel, 10, flush, spin=spin)
        plain_ms = cuda_ms(torch, twin, 3, flush, spin=spin)
        res[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        tflops = flash_ops(kind, q, k, causal) / ms / 1e9
        print(f"    {name:20s} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
              f"sdpa {'fwd' if kind == 'fwd' else 'bwd'}={library_ms:.4f}ms"
              f" bound={bound_ms:.4f}ms ({bound_by}) "
              f"bound/kernel={bound_ms / ms:.3f} {tflops:.1f} TFLOP/s",
              flush=True)
    pair = res["flash_attention_dq"]["ms"] + res["flash_attention_dkv"]["ms"]
    print(f"    dQ + dK/dV = {pair:.4f}ms against sdpa bwd "
          f"{lib['bwd']:.4f}ms (x{pair / lib['bwd']:.2f})", flush=True)
    return res


def phase_flash(torch, fa, flush):
    """Each flash kernel against its twin, bf16 and f32: at head_dim 64
    GPT-medium's training shape causal and full, a ragged T, Tq != Tk;
    at head_dim 128 GPT-1.3B's training shape causal and full. Returns
    {head_dim: the bf16 causal training shape's measurements with the
    largest error of every case at that head_dim}."""
    rng = np.random.default_rng(SEED + 2)
    T = TRAIN["seq"]
    B64, B128 = TRAIN["batch"], TRAIN_1P3B["batch"]
    cases = [("training shape, causal", B64, T, T, 64, True),
             ("training shape, full", B64, T, T, 64, False),
             ("ragged T=1000, causal", B64, 1000, 1000, 64, True),
             ("Tq=256, Tk=1024, full", B64, 256, 1024, 64, False),
             ("GPT-1.3B training shape, causal", B128, T, T, 128, True),
             ("GPT-1.3B training shape, full", B128, T, T, 128, False)]
    main = {}
    worst = {d: {name: 0.0 for name, _ in FLASH_KERNELS} for d in (64, 128)}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, tq, tk, d, causal in cases:
            res = hold_flash(torch, fa, flush, f"{label} [{B}, {tq}, {H}, "
                             f"{d}]", B, tq, tk, d, causal, dtype, rng)
            for name in worst[d]:
                worst[d][name] = max(worst[d][name],
                                     res[name]["max_abs_err"])
            main.setdefault(d, res)
    for d, res in main.items():
        for name in worst[d]:
            res[name]["max_abs_err"] = worst[d][name]
    return main


@contextlib.contextmanager
def capture_flash_bwd(fa, into):
    """While active, each flash_attention_dq call's inputs replace
    into["args"]: after a backward pass, layer 0's (the last layer the
    backward reaches). The call itself goes on to the kernel. The
    wrapper counts its launch on the module's `flash_attention_dq`, the
    spy while it is installed, so the spy carries the count and hands it
    back."""
    real = fa.flash_attention_dq

    def spy(q, k, v, dout, lse, delta, causal=False, scale=None):
        into["args"] = (q, k, v, dout, lse, delta)
        into["kw"] = dict(causal=causal, scale=scale)
        into["calls"] = into.get("calls", 0) + 1
        return real(q, k, v, dout, lse, delta, causal, scale)

    spy.launches = real.launches
    fa.flash_attention_dq = spy
    try:
        yield
    finally:
        fa.flash_attention_dq = real
        real.launches = spy.launches


def park_captured(torch, into):
    """Moves the captured (q, k, v, dO, lse, delta) to the host, q/k/v as
    one fused [B, T, 3, H, D] tensor, so the training run that follows
    holds no extra device memory. Without grad: a copy with a grad_fn
    would keep the step's autograd graph, and through it the parameters'
    buckets, alive."""
    q, k, v, do, lse, delta = into.pop("args")
    check(q.stride(1) == 3 * q.shape[2] * q.shape[3]
          and k.data_ptr() - q.data_ptr() == q.shape[2] * q.shape[3]
          * q.element_size(),
          "the captured q, k, v are not unbind views of a fused projection")
    with torch.no_grad():
        into["host"] = (torch.stack((q, k, v), dim=2).cpu(), do.cpu(),
                        lse.cpu(), delta.cpu())


def hold_flash_captured(torch, fa, captured, n_layers):
    """The forward, dQ and dK/dV against their twins on layer 0's inputs
    of a real training step (q, k, v unbind views of the fused
    projection, the forward kernel's lse, the backward's dO and delta):
    dO there is ~1e-6, which random N(0, 1) inputs never show. Returns
    each kernel's largest absolute error."""
    check(captured.get("calls") == n_layers,
          f"captured {captured.get('calls')} dQ calls in one step, want "
          f"{n_layers}")
    qkv, do, lse, delta = (t.cuda() for t in captured["host"])
    q, k, v = qkv.unbind(dim=2)
    kw = captured["kw"]
    args = (q, k, v, do, lse, delta)
    out, out_lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq = fa.flash_attention_dq(*args, **kw)
    dk, dv = fa.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    want_dq = fa.flash_attention_dq_reference(*args, **kw)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*args, **kw)
    lse_err = max((out_lse - want_lse).abs().max().item(),
                  (lse - want_lse).abs().max().item())
    check(lse_err <= 1e-4, f"captured layer 0: lse differs by {lse_err}")
    errs, tol, msg = {}, FLASH_REL[str(q.dtype)], [f"lse err {lse_err:.3g}"]
    for name, got, ref in (("out", out, want), ("dq", dq, want_dq),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        check(bool(torch.isfinite(got.float()).all()),
              f"captured layer 0: {name} not finite")
        err = (got.float() - ref.float()).abs().max().item()
        big = ref.float().abs().max().item()
        check(err <= tol * big, f"captured layer 0: {name} max |kernel - "
                                f"twin| / max |twin| = {err / big} > {tol}")
        errs[name] = err
        msg.append(f"{name} err {err:.3g} of max {big:.3g} "
                   f"({err / big:.2e})")
    print(f"  layer 0 of a training step, {tuple(q.shape)} "
          f"{str(q.dtype)[6:]} {kw}, max |dO| "
          f"{do.float().abs().max().item():.3g}: " + ", ".join(msg),
          flush=True)
    return {"flash_attention_fwd": max(errs["out"], lse_err),
            "flash_attention_dq": errs["dq"],
            "flash_attention_dkv": max(errs["dk"], errs["dv"])}


def lm_loss(F, poison=None):
    """Cross-entropy of logits [B, T, V] against labels [B, T]. With
    `poison` (a 0-dim tensor) the logits are multiplied by it first: a
    poison of inf makes the loss and every grad non-finite."""
    def loss_fn(logits, labels):
        V = logits.shape[-1]
        if poison is not None:
            logits = logits * poison
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))
    return loss_fn


FUSED_KERNELS = (
    ("fused_pass1", "paddle_tpu/ops/pallas/fused_update.py:502"),
    ("fused_pass2", "paddle_tpu/ops/pallas/fused_update.py:525"),
)


NORM_KERNELS = (
    ("layer_norm_fwd", "paddle_tpu/ops/pallas/layer_norm.py:20"),
    ("layer_norm_bwd", "paddle_tpu/ops/pallas/layer_norm.py:33"),
)
XENT_KERNELS = (
    ("softmax_xent_fwd", "paddle_tpu/ops/pallas/softmax_xent.py:28"),
    ("softmax_xent_bwd", "paddle_tpu/ops/pallas/softmax_xent.py:60"),
)
# K2 replaces no Pallas kernel: it computes the reference tree update's
# stochastic-rounding downcast, `down()`, which XLA fuses there; since the
# tree update's kernel (below) took the four fused kinds, the other six
# optimizers' per-leaf code launches it
SR_KERNEL = ("stochastic_round", "paddle_tpu/optimizer/optimizer.py:303")
# nor does the tree update's kernel: it computes the reference tree
# update's `upd()` with its `down()` for SGD, Momentum, Adam and AdamW
TREE_KERNEL = ("tree_update", "paddle_tpu/optimizer/optimizer.py:317")
SWITCHES = ("PADDLE_TPU_PALLAS_LN", "PADDLE_TPU_PALLAS_XENT")


@contextlib.contextmanager
def switches(on):
    """PADDLE_TPU_PALLAS_LN and PADDLE_TPU_PALLAS_XENT set to "1" (on)
    or unset, restored on the way out."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    try:
        for k in SWITCHES:
            if on:
                os.environ[k] = "1"
            else:
                os.environ.pop(k, None)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wrappers(km):
    """[(kernel name, its wrapper)] of every kernel but the paged one."""
    fa, _, fk, lk, xk, sk, srk, tk = km
    return ([(n, getattr(fa, n)) for n, _ in FLASH_KERNELS]
            + [(n, getattr(fk, n)) for n, _ in FUSED_KERNELS]
            + [(n, getattr(lk, n)) for n, _ in NORM_KERNELS]
            + [(n, getattr(xk, n)) for n, _ in XENT_KERNELS]
            + [(SCAN_KERNEL[0], sk.ssm_scan),
               (SR_KERNEL[0], srk.stochastic_round),
               (TREE_KERNEL[0], tk.tree_update)])


def counts(km):
    """Every kernel wrapper's launch count."""
    out = {name: fn.launches for name, fn in wrappers(km)}
    out["ragged_paged_attention"] = km[1].ragged_paged_attention.launches
    return out


def zero_counts(km):
    for _, fn in wrappers(km):
        fn.launches = 0
    km[1].ragged_paged_attention.launches = 0


def n_groups(step):
    """Launch groups of a fused TrainStep's epilogue (one launch of each
    pass per group a step)."""
    return len(step._fused.bucket_set(step._grad_store, step._params_store,
                                      step._opt_store).groups)


def tree_launches(torch, tk, step):
    """(tree-update launches, standalone rounding launches) that a step
    of `step` (a TrainStep) makes: on the tree path one launch a leaf
    group (tk.leaf_groups) for SGD, Momentum, Adam and AdamW; for the
    other six optimizers under stochastic rounding one rounding launch a
    bf16 parameter without a master and one a bf16 state leaf; else
    none."""
    if step._fused is not None:
        return 0, 0
    opt = step.optimizer
    names = sorted(step.params)
    params = [step.params[k] for k in names]
    trees = [step._opt_store[k] for k in names]
    inners = [t["state"] if isinstance(t, dict) else t for t in trees]
    masters = [t["master"] if isinstance(t, dict) else None for t in trees]
    if opt._fused_kind() is not None:
        return len(tk.leaf_groups(params, inners, masters)), 0
    if not opt._stochastic_rounding:
        return 0, 0
    bf16 = torch.bfloat16
    return 0, sum(int(p.dtype == bf16 and m is None)
                  + sum(t.dtype == bf16 for t in inner)
                  for p, inner, m in zip(params, inners, masters))


def one_tree_launch(run):
    """A tree run of one launch group (all leaves bf16 with one state
    dtype and masters on all or none, as PERF.md counts it): one
    tree-update launch a step and no standalone rounding launch."""
    check((run["tree_per_step"], run["k2_per_step"]) == (1, 0),
          f"{run['label']}: {run['tree_per_step']} tree-update and "
          f"{run['k2_per_step']} rounding launches a step, want 1 and 0")


def fused_loss_net(torch, lm, chunk):
    """bench.py's `_FusedLossWrapper` (bench.py:687-693): forward(ids,
    labels) is lm.fused_loss(ids, labels, chunk), the chunked vocab
    loss, for TrainStep(model_returns_loss=True). Every parameter name
    gains the prefix "lm."."""
    class FusedLossWrapper(torch.nn.Module):
        # the model rides the instance only: a class made here is freed by
        # the garbage collector, not when the step is deleted
        def __init__(self, lm):
            super().__init__()
            self.lm = lm

        def forward(self, ids, labels):
            return self.lm.fused_loss(ids, labels, chunk=self.chunk)
    net = FusedLossWrapper(lm)
    net.chunk = chunk
    return net


def train_run(torch, km, tmods, state, fused, switched=False,
              capture=None, cfg=None, run=TRAIN, name="", opt=None,
              remat=False, chunk=None):
    """A GPT (GPT-medium, or `cfg`) at full width in bf16, AdamW(lr=1e-4,
    multi_precision) with f32 masters (or `opt(parameters)`'s optimizer;
    a scheduler as its lr is stepped after each step),
    TrainStep(monitor_health=True) on
    bench.py's batch (`run`: batch x seq, ids from RandomState(0),
    labels = ids): run["warmup"] warm-up steps, run["timed"] timed, 1
    profiled. fused=True passes no fused_update argument (the default
    path, which must be the fused epilogue, unless the optimizer has no
    fused mapping: then the tree path); fused=False passes
    fused_update=False. switched sets PADDLE_TPU_PALLAS_LN=1 and
    PADDLE_TPU_PALLAS_XENT=1 for the run (the LayerNorm and xent
    kernels), else both are unset. On the tree path the tree update must
    launch once a leaf group a step for SGD, Momentum, Adam and AdamW, and
    the standalone rounding kernel once a bf16 target a step for the
    other six under stochastic rounding (tree_launches); neither
    otherwise. The launch counts are set to 0 just
    before the run. With `capture` (a dict), the first warm-up step's
    flash backward inputs of layer 0 are kept there, on the host
    (capture_flash_bwd). `name` prefixes the printed label. With `remat`
    the config's scan_remat is set to it; with `chunk` the step is
    bench.py's: TrainStep(fused_loss_net(model, chunk), None, ...,
    model_returns_loss=True), the chunked vocab loss on kernels #7-#8
    whatever the switches say. Returns the run's measurements."""
    cfg = copy.copy(cfg or tmods[1]())
    cfg.scan_remat = remat
    with switches(switched):
        return _train_run(torch, km, tmods, state, fused, switched, capture,
                          cfg, run, name, opt, chunk)


def _train_run(torch, km, tmods, state, fused, switched, capture, cfg, run,
               name, make_opt, chunk):
    from paddle_tpu_torch.ops.chunked_xent import _pick_chunk
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    from paddle_tpu_torch.optimizer.lr import LRScheduler
    GPTForCausalLM, _, load_state, TrainStep, AdamW, F = tmods
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    n_params = sum(p.numel() for p in model.parameters())
    B, T = run["batch"], run["seq"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2**30
    label = name + ("fused + LN/xent kernels (switched)" if switched
                    else "fused (default)" if fused
                    else "tree (fused_update=False)")

    zero_counts(km)
    optimizer = make_opt(model.parameters()) if make_opt else AdamW(
        learning_rate=run["lr"], parameters=model.parameters(),
        multi_precision=True)
    sched = optimizer._learning_rate if isinstance(
        optimizer._learning_rate, LRScheduler) else None
    kw = {} if fused else {"fused_update": False}
    if chunk:
        step = TrainStep(fused_loss_net(torch, model, chunk), None,
                         optimizer, model_returns_loss=True,
                         monitor_health=True, **kw)
    else:
        step = TrainStep(model, lm_loss(F), optimizer, monitor_health=True,
                         **kw)
    want_fused = fused and optimizer.fused_spec() is not None
    check((step._fused is not None) == want_fused,
          f"{label}: TrainStep took the {'fused' if step._fused else 'tree'}"
          " epilogue")
    groups = n_groups(step) if want_fused else 0
    tree_per_step, k2_per_step = tree_launches(torch, km[7], step)
    n_leaves = len(step.params)
    losses = []

    def steps(n):
        for _ in range(n):
            losses.append(step(ids, ids))
            if sched is not None:
                sched.step()

    t = time.perf_counter()
    if capture is not None:
        # an eager step: the hook sees a run's values, and the first call
        # after it captures the step's program without the hook
        with capture_flash_bwd(km[0], capture):
            losses.append(step._eager_call(ids, ids))
            if sched is not None:
                sched.step()
        park_captured(torch, capture)
        steps(run["warmup"] - 1)
    else:
        steps(run["warmup"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    steps(run["timed"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / run["timed"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        steps(1)
        torch.cuda.synchronize()
    launches = counts(km)
    n_steps = run["warmup"] + run["timed"] + 1
    health = step.flush_health()
    vals = torch.stack(losses).tolist()
    hv = np.array([[h[k] for k in HEALTH_KEYS] for h in step.health_log])
    check(len(hv) == n_steps, f"{label}: {len(hv)} health vectors for "
                              f"{n_steps} steps")
    check(np.isfinite(vals).all() and np.isfinite(hv).all(),
          f"{label}: non-finite loss or health: {vals} / {hv}")
    check((hv[:, 4] == 0).all(), f"{label}: found_inf set: {hv[:, 4]}")
    first, last = vals[0], vals[run["warmup"] + run["timed"] - 1]
    check(last < first, f"{label}: loss did not fall: {first} -> {last}")
    # under remat each block's recompute runs its forward again up to its
    # last saved tensor (fc_out's product): the flash forward and ln_1 /
    # ln_2 twice a layer, their backwards once; ln_f is outside the blocks
    again = 2 if cfg.scan_remat else 1
    L = cfg.num_layers
    n_ln = 2 * L + 1  # ln_1 and ln_2 of each block, ln_f
    per_step = {"flash_attention_fwd": L * again, "flash_attention_dq": L,
                "flash_attention_dkv": L,
                "layer_norm_fwd": (2 * L * again + 1) * switched,
                "layer_norm_bwd": n_ln * switched}
    n_chunks = B * T // _pick_chunk(B * T, chunk) if chunk \
        else int(switched)
    per_step.update({n: n_chunks for n, _ in XENT_KERNELS})
    per_step.update({n: groups for n, _ in FUSED_KERNELS})
    for name, want in per_step.items():
        check(launches[name] == n_steps * want,
              f"{label}: {name}: {launches[name]} launches, want "
              f"{n_steps} steps x {want} (switched {switched}, remat "
              f"{cfg.scan_remat!r}, chunk {chunk})")
    check(launches["ragged_paged_attention"] == 0
          and launches["ssm_scan"] == 0,
          f"{label}: a serving kernel ran in training")
    for name, per_step in ((TREE_KERNEL[0], tree_per_step),
                           (SR_KERNEL[0], k2_per_step)):
        check(launches[name] == n_steps * per_step,
              f"{label}: {name}: {launches[name]} launches, want "
              f"{n_steps} steps x {per_step}")
    check(all(p.dtype == torch.bfloat16 for p in step.params.values()),
          f"{label}: a parameter left bfloat16")
    tokens = B * T
    flop = 6 * n_params * tokens + 6 * cfg.num_layers * B * T * T \
        * cfg.hidden_size
    peak = torch.cuda.max_memory_allocated() / 2**30
    ops = [e for e in device_events(prof) if e[0] != EPILOGUE]
    n_kernels = sum(1 for e in ops
                    if not e[0].startswith(("Memcpy", "Memset")))
    epi_us, epi_how = epilogue_us(prof, ops)
    res = dict(label=label, ms=step_s * 1e3, tokens_s=tokens / step_s,
               mfu=flop / step_s / 989e12, peak_gib=peak,
               kernels=n_kernels, device_ops=len(ops),
               epilogue_ms=epi_us / 1e3 if epi_us else None,
               launches=launches, groups=groups, first=first, last=last,
               leaves=n_leaves, tree_per_step=tree_per_step,
               k2_per_step=k2_per_step, n_steps=n_steps, losses=vals)
    print(f"  {label}: {n_params} parameters; {n_steps} steps, loss "
          f"{first:.4f} -> {last:.4f} (last health {health})")
    print(f"  {label}: {res['ms']:.1f} ms/step over {run['timed']} steps "
          f"(warm-up {warm_s:.1f}s for {run['warmup']}), "
          f"{res['tokens_s']:.0f} tokens/s, MFU {res['mfu']:.4f} "
          f"({flop:.4g} FLOP/step over 989 TFLOP/s); peak memory "
          f"{peak:.2f} GiB ({start_gib:.2f} GiB allocated at the start, "
          f"the model's weights included)")
    print(f"  {label}: launches per kernel {launches} ({n_steps} steps x "
          f"{per_step} a step; tree update x {tree_per_step}, standalone "
          f"stochastic rounding x {k2_per_step}; {n_leaves} leaves)")
    print(f"  {label}: profiled step: {n_kernels} CUDA kernel launches "
          f"({len(ops)} device operations with copies and memsets); "
          f"epilogue device time "
          + (f"{res['epilogue_ms']:.2f}ms ({epi_how})" if epi_us
             else "not measured"))
    res["device_ms"], res["idle"], res["other_ms"], res["parts_ms"] = \
        train_time_goes(prof, step_s)
    del step, model
    torch.cuda.empty_cache()
    return res


def epilogue_us(prof, ops):
    """(device microseconds of the kernels that ran inside TrainStep's
    epilogue range, how it was found). The range's device-side
    annotation spans its kernels, whether torch ops launched them or the
    port's ctypes wrappers did; without one, the CPU range's
    device_time_total counts the kernels of the torch ops inside it."""
    from torch.autograd import DeviceType
    spans = [(t, t + us) for name, t, us in device_events(prof)
             if name == EPILOGUE]
    if spans:
        return sum(us for _, t, us in ops
                   if any(a <= t < b for a, b in spans)), \
            "device operations inside the range's device-side span"
    return sum(getattr(e, "device_time_total", 0) for e in prof.events()
               if e.name == EPILOGUE and e.device_type == DeviceType.CPU), \
        "torch ops inside the CPU range; ctypes launches not linked"


def train_time_goes(prof, wall_s):
    """Device time of the profiled step by kernel: the flash kernels,
    the fused epilogue, the LayerNorm and xent kernels, cuBLAS products,
    the rest; idle share against the timed steps' wall time. Returns
    (device ms, idle share, ms of the rest, {kernel family: ms}), or
    Nones and {} when the profiler saw no device events."""
    by_name = device_us_by_name(prof)
    total = sum(by_name.values()) / 1e3
    if not total:
        print("  device time per step: not measured (the profiler saw no "
              "device events)")
        return None, None, None, {}
    parts = {k: sum(v for n, v in by_name.items() if k in n) / 1e3
             for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_pass",
                       "fused_finalize", "ln_fwd", "ln_bwd", "ln_finalize",
                       "xent_fwd", "xent_bwd", "stochastic_round",
                       "tree_update")}
    gemm = sum(v for n, v in by_name.items()
               if any(s in n.lower() for s in ("gemm", "xmma", "cutlass",
                                                "nvjet", "sm90"))) / 1e3
    wall = wall_s * 1e3
    idle = max(0.0, 1 - total / wall)
    print(f"  per step: wall {wall:.2f}ms (timed steps), device kernels "
          f"{total:.2f}ms (profiled step), idle share {idle:.3f}")
    other = total - gemm - sum(parts.values())
    print("  " + ", ".join(f"{k} {v:.2f}ms ({v / total:.3f})"
                           for k, v in parts.items())
          + f"; cuBLAS products {gemm:.2f}ms ({gemm / total:.3f}); other "
          f"{other:.2f}ms")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3:8.3f}ms  {name[:90]}")
    return total, idle, other, parts


# step-13 losses with the CUDA-core flash forward and the tensor-core
# backward (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5), against
# which each run's is held: the tensor-core forward rounds P to bf16 too
CUDA_CORE_FWD_LAST_LOSS = {"fused": 6.7733, "tree": 6.7733,
                           "switched": 6.7726}
LAST_LOSS_TOL = 0.01


def adamax_sr_bf16(torch):
    """Phase 7's fifth run's optimizer: Adamax(1e-4) with stochastic
    rounding and bf16 moments, no masters (the tree path's per-leaf code
    and the standalone rounding kernel: params and both moments)."""
    from paddle_tpu_torch.optimizer import Adamax

    def make(parameters):
        opt = Adamax(learning_rate=1e-4, parameters=parameters)
        opt._stochastic_rounding = True
        opt._state_dtype = torch.bfloat16
        return opt
    return make


def scheduled_bf16_adamw(torch, AdamW):
    """The fourth GPT-medium run's optimizer: AdamW with f32 masters,
    bf16 moments (`_state_dtype`, kernel #10's bf16 variant) and a
    warm-up into a cosine decay, stepped after each step."""
    from paddle_tpu_torch.optimizer import lr

    def make(parameters):
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=14),
                                warmup_steps=4, start_lr=0.0, end_lr=1e-4)
        opt = AdamW(learning_rate=sched, parameters=parameters,
                    multi_precision=True)
        opt._state_dtype = torch.bfloat16
        return opt
    return make


def phase_train(torch, km, tmods, state, capture):
    """The main path of slice 2 (the default, fused epilogue), the tree
    path, then the port's fastest route (the default epilogue with the
    LayerNorm and xent kernels switched on), from the same weights; the
    first run's first step captures layer 0's flash backward inputs into
    `capture`. Then the switched route again with a scheduled AdamW whose
    moments are bf16 (PR 13's main path for kernel #10's bf16 variant).
    Then a short run of the switched route with Adamax, stochastic
    rounding and bf16 moments: an optimizer without a fused mapping, whose
    per-leaf code rounds with the standalone kernel (K2's main path since
    the four fused kinds took the tree update). Returns the five runs'
    measurements."""
    main = train_run(torch, km, tmods, state, fused=True, capture=capture)
    tree = train_run(torch, km, tmods, state, fused=False)
    one_tree_launch(tree)
    ln_xent = train_run(torch, km, tmods, state, fused=True, switched=True)
    bf16_state = train_run(torch, km, tmods, state, fused=True,
                           switched=True, name="bf16 state, scheduled, ",
                           opt=scheduled_bf16_adamw(torch, tmods[4]))
    adamax_sr = train_run(torch, km, tmods, state, fused=True, switched=True,
                          name="Adamax + SR + bf16 state, ", run=TRAIN_K2,
                          opt=adamax_sr_bf16(torch))
    check(adamax_sr["k2_per_step"] == 3 * adamax_sr["leaves"],
          f"Adamax + SR: {adamax_sr['k2_per_step']} rounding launches a "
          f"step, want 3 x {adamax_sr['leaves']} leaves")
    rel = abs(ln_xent["first"] - main["first"]) / abs(main["first"])
    print(f"  step-1 loss: switched {ln_xent['first']:.6f}, default "
          f"{main['first']:.6f}, relative difference {rel:.3g} (limit "
          f"1e-3)")
    check(rel <= 1e-3, f"the switched run's step-1 loss differs from the "
                       f"default run's by {rel}")
    runs = {"fused": main, "tree": tree, "switched": ln_xent}
    print("  step-13 loss: " + ", ".join(
        f"{name} {r['last']:.4f} (CUDA-core forward: "
        f"{CUDA_CORE_FWD_LAST_LOSS[name]:.4f})"
        for name, r in runs.items()))
    for name, r in runs.items():
        check(abs(r["last"] - CUDA_CORE_FWD_LAST_LOSS[name]) <= LAST_LOSS_TOL,
              f"{name}: step-13 loss {r['last']} is more than "
              f"{LAST_LOSS_TOL} from {CUDA_CORE_FWD_LAST_LOSS[name]}")
    runs["bf16-state"] = bf16_state
    runs["adamax-sr"] = adamax_sr
    for key in ("ms", "tokens_s", "mfu", "device_ms", "idle", "peak_gib",
                "epilogue_ms", "kernels", "other_ms"):
        print(f"  {key:12s} " + "  ".join(
            f"{name} {r[key] if r[key] is None else round(r[key], 4)}"
            for name, r in runs.items()))
    print(f"  bf16 state against f32 state (both switched): epilogue "
          f"{bf16_state['epilogue_ms']} ms vs {ln_xent['epilogue_ms']} ms, "
          f"fused_pass {bf16_state['parts_ms'].get('fused_pass')} ms vs "
          f"{ln_xent['parts_ms'].get('fused_pass')} ms, device "
          f"{bf16_state['device_ms']} ms vs {ln_xent['device_ms']} ms, peak "
          f"{bf16_state['peak_gib']:.2f} GiB vs {ln_xent['peak_gib']:.2f} "
          f"GiB; loss {bf16_state['first']:.4f} -> {bf16_state['last']:.4f}")
    return main, tree, ln_xent, bf16_state, adamax_sr


def phase_train_flavors(torch, km, tmods, state):
    """Phase 7's switched route (GPT-medium bf16, the fused epilogue,
    AdamW with f32 masters, both switches) from the phase-4 weights:
    `run_steps(4)` against four calls from the same state (restored by
    `snapshot_state` / `set_tree_state`, `_step_i` reset as a checkpoint
    restore sets it): losses and every parameter bit-equal; then
    `accumulate(2)` on two [4, 1024] microbatches against one call on
    the [8, 1024] batch from the same state: losses within 1e-3
    relative, one epilogue (each fused pass launched once a group) and
    the forward kernels twice."""
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    B, T = TRAIN["batch"], TRAIN["seq"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).cuda()
    step = TrainStep(model, lm_loss(F), AdamW(
        learning_rate=TRAIN["lr"], parameters=model.parameters(),
        multi_precision=True), monitor_health=True)
    check(step._fused is not None, "flavors: not the fused epilogue")
    groups = n_groups(step)
    with switches(True):
        snap, start = step.snapshot_state(), step._step_i
        t = time.perf_counter()
        scanned = step.run_steps(4, ids, ids)
        after = {k: p.clone() for k, p in step.params.items()}
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        step.set_tree_state(snap["params"], snap["opt_state"])
        step._step_i = start
        t = time.perf_counter()
        calls = torch.stack([step(ids, ids) for _ in range(4)])
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t
        same = [k for k, p in step.params.items() if torch.equal(p, after[k])]
        print(f"  run_steps(4) {scanned.tolist()} in {run_s * 1e3:.1f} ms; "
              f"4 calls {calls.tolist()} in {call_s * 1e3:.1f} ms; "
              f"{len(same)} of {len(after)} parameters bit-equal")
        check(torch.equal(scanned, calls) and len(same) == len(after),
              "flavors: run_steps(4) differs from 4 calls")
        step.set_tree_state(snap["params"], snap["opt_state"])
        step._step_i = start
        zero_counts(km)
        acc = step.accumulate(2, ids.reshape(2, B // 2, T),
                              ids.reshape(2, B // 2, T))
        torch.cuda.synchronize()
        got = counts(km)
        step.set_tree_state(snap["params"], snap["opt_state"])
        step._step_i = start
        whole = step(ids, ids)
    L = cfg.num_layers
    want = {"fused_pass1": groups, "fused_pass2": groups,
            "flash_attention_fwd": 2 * L, "flash_attention_dq": 2 * L,
            "flash_attention_dkv": 2 * L, "layer_norm_fwd": 2 * (2 * L + 1),
            "layer_norm_bwd": 2 * (2 * L + 1), "softmax_xent_fwd": 2,
            "softmax_xent_bwd": 2, "tree_update": 0, "stochastic_round": 0}
    rel = abs(float(acc) - float(whole)) / abs(float(whole))
    print(f"  accumulate(2) on 2 x [4, 1024]: loss {float(acc):.6f}; one "
          f"step on [8, 1024]: {float(whole):.6f}; relative difference "
          f"{rel:.3g} (limit 1e-3); launches {got}")
    check(rel <= 1e-3, f"flavors: accumulate(2) loss {float(acc)} is {rel} "
                       f"from the whole batch's {float(whole)}")
    check({n: got[n] for n in want} == want,
          f"flavors: accumulate(2) launches {got}, want {want}")
    step.flush_health()
    check(len(step.health_log) == 10 and np.isfinite(
        [h["loss"] for h in step.health_log]).all(),
        f"flavors: {len(step.health_log)} health vectors for 10 updates")
    del step, model, snap
    torch.cuda.empty_cache()


def phase_flavor_agreement(torch, km, tmods, state):
    """GPT-medium width, 2 layers, float32, on the card and on the CPU
    from the same weights: remat "dots", fused_loss(chunk=2048) behind
    bench.py's wrapper (512 tokens: one chunk), TrainStep(
    model_returns_loss=True) on the fused epilogue (AdamW), 3
    accumulate(2) steps on [2, 2, 256] microbatches. Losses and health
    vectors within rtol 1e-3; on the card the flash forward twice a
    layer a microbatch (the recompute), #7-#8 once a microbatch, each
    fused pass once a step."""
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = copy.copy(gpt_medium())
    cfg.num_layers = AGREE["layers"]
    cfg.scan_remat = "dots"
    small = first_layers(state, cfg.num_layers)
    ids = np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(2, AGREE["batch"], AGREE["seq"]))
    runs = {}
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=device)
        load_state(model, small)
        step = TrainStep(fused_loss_net(torch, model, BENCH_CHUNK), None,
                         AdamW(learning_rate=TRAIN["lr"],
                               parameters=model.parameters()),
                         model_returns_loss=True, monitor_health=True)
        x = torch.from_numpy(ids).to(model.device)
        before = counts(km)
        for _ in range(AGREE["steps"]):
            step.accumulate(2, x, x)
        step.flush_health()
        after = counts(km)
        on = AGREE["steps"] * (device == "cuda")
        L = cfg.num_layers
        want = {"flash_attention_fwd": on * 2 * 2 * L,
                "flash_attention_dq": on * 2 * L,
                "flash_attention_dkv": on * 2 * L,
                "softmax_xent_fwd": on * 2, "softmax_xent_bwd": on * 2,
                "fused_pass1": on * n_groups(step),
                "fused_pass2": on * n_groups(step),
                "layer_norm_fwd": 0, "layer_norm_bwd": 0}
        got = {n: after[n] - before[n] for n in want}
        check(got == want, f"remat + fused_loss + accumulate, {device}: "
                           f"launches {got}, want {want}")
        runs[device] = np.array([[h[k] for k in HEALTH_KEYS]
                                 for h in step.health_log])
    g, c = runs["cuda"], runs["cpu"]
    rel = np.abs(g - c) / np.maximum(np.abs(c), 1e-6)
    print(f"  remat \"dots\" + fused_loss + accumulate(2): losses card "
          f"{g[:, 0].tolist()} cpu {c[:, 0].tolist()}; health largest "
          f"relative difference {rel.max():.3g} (limit {AGREE['rtol']})")
    check(np.allclose(g, c, rtol=AGREE["rtol"], atol=1e-6),
          f"remat + fused_loss + accumulate: card and CPU disagree: {g} vs "
          f"{c}")


ALL_ROUTES = ((True, False), (False, False), (True, True))


def phase_train_agreement(torch, km, tmods, state, cfg=None,
                          routes=ALL_ROUTES):
    """GPT-medium width (or `cfg`'s), 2 layers, float32, batch 2 x 256, 3
    AdamW steps from the same weights, on the card (kernels) for each
    (fused, switched) of `routes`: each epilogue, and the fused one with
    the LayerNorm and xent switches set (512 x 50304 logits: the xent
    route applies), each against the CPU's run (plain twins). The routes
    compute one function (AdamW on the same weights and batch; the
    switched kernels' twins are the compositions they replace), so the
    CPU runs it once, on the first route, and that run is every card
    route's reference. TF32 is off, so the card's float32 products are
    float32. Losses and health vectors agree to rtol 1e-3 (float32 sums
    in other orders, amplified where Adam divides small moments)."""
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = copy.copy(cfg or gpt_medium())
    cfg.num_layers = AGREE["layers"]
    small = first_layers(state, cfg.num_layers)
    ids = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(AGREE["batch"], AGREE["seq"]))
    print(f"  TF32 off: the card's float32 products run in float32; hidden "
          f"{cfg.hidden_size}, head_dim {cfg.hidden_size // cfg.num_heads}")
    n_ln = 2 * cfg.num_layers + 1
    runs = {}
    for r, (fused, switched) in enumerate(routes):
        for device in ("cuda", "cpu") if r == 0 else ("cuda",):
            model = GPTForCausalLM(cfg, device=device)
            load_state(model, small)
            step = TrainStep(model, lm_loss(F),
                             AdamW(learning_rate=TRAIN["lr"],
                                   parameters=model.parameters()),
                             monitor_health=True, fused_update=fused)
            x = torch.from_numpy(ids).to(model.device)
            before = counts(km)
            with switches(switched):
                for _ in range(AGREE["steps"]):
                    step(x, x)
            step.flush_health()
            after = counts(km)
            hv = [[h[k] for k in HEALTH_KEYS] for h in step.health_log]
            on_card = device == "cuda"
            want = {name: AGREE["steps"] * cfg.num_layers * on_card
                    for name, _ in FLASH_KERNELS}
            groups = n_groups(step) if fused else 0
            want.update({name: AGREE["steps"] * groups * on_card
                         for name, _ in FUSED_KERNELS})
            want.update({name: AGREE["steps"] * n_ln * on_card * switched
                         for name, _ in NORM_KERNELS})
            want.update({name: AGREE["steps"] * on_card * switched
                         for name, _ in XENT_KERNELS})
            got = {n: after[n] - before[n] for n in want}
            check(got == want, f"{device}, fused={fused}, switched="
                               f"{switched}: launches {got}, want {want}")
            runs[device] = (np.stack(hv), {k: p.float().cpu() for k, p
                                           in step.params.items()})
        (gh, gp), (ch, cp) = runs["cuda"], runs["cpu"]
        rel = np.abs(gh - ch) / np.maximum(np.abs(ch), 1e-6)
        name = ("fused + LN/xent kernels" if switched
                else "fused" if fused else "tree")
        print(f"  {name}: losses card {gh[:, 0].tolist()} cpu "
              f"{ch[:, 0].tolist()}")
        print(f"  {name}: health [loss, grad_norm, param_norm, "
              f"update_ratio, found_inf] largest relative difference "
              f"{rel.max():.3g} (limit {AGREE['rtol']})")
        dmax = max((gp[k] - cp[k]).abs().max().item() for k in gp)
        print(f"  {name}: largest parameter difference after "
              f"{AGREE['steps']} steps: {dmax:.3g}")
        check(np.allclose(gh, ch, rtol=AGREE["rtol"], atol=1e-6),
              f"{name}: card and CPU training disagree: {gh} vs {ch}")


def eager_losses(torch, F, model, opt, ids, steps, poison=None):
    """The eager loop: loss, backward, opt.step(), clear_grad, and the
    scheduler's step when the lr is one. Returns the losses."""
    from paddle_tpu_torch.optimizer.lr import LRScheduler
    out = []
    for _ in range(steps):
        loss = lm_loss(F, poison)(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if isinstance(opt._learning_rate, LRScheduler):
            opt._learning_rate.step()
        out.append(float(loss.detach()))
    return out


def phase_optimizer_agreement(torch, km, tmods, state):
    """PR 13's paths, GPT-medium width, 2 layers, float32, batch 2 x 256,
    3 steps from the same weights on the card and on the CPU: the eager
    loop with L2Decay, ClipGradByNorm and a step-decay scheduler, once
    on AdamW (whose eager step, as the reference's, takes a non-float
    weight_decay as its decoupled 0.01 and adds no coupled term) and
    once on Adam (which adds the L2Decay term to the grads), Lamb on
    TrainStep's tree path, and AdamW on the fused epilogue with bf16
    moments. TF32 off. Losses (and the train steps' health vectors)
    agree to rtol 1e-3."""
    from paddle_tpu_torch.jit.api import HEALTH_KEYS
    from paddle_tpu_torch.nn import ClipGradByNorm
    from paddle_tpu_torch.optimizer import Adam, Lamb, lr
    from paddle_tpu_torch.regularizer import L2Decay
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = copy.copy(gpt_medium())
    cfg.num_layers = AGREE["layers"]
    small = first_layers(state, cfg.num_layers)
    ids = np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(AGREE["batch"], AGREE["seq"]))

    def eager(kind):
        def make(params):
            return kind(lr.StepDecay(1e-3, step_size=1, gamma=0.5),
                        parameters=params, weight_decay=L2Decay(1e-2),
                        grad_clip=ClipGradByNorm(0.5))
        return make

    def lamb(params):
        return Lamb(1e-3, parameters=params)

    def bf16_state(params):
        opt = AdamW(learning_rate=1e-3, parameters=params)
        opt._state_dtype = torch.bfloat16
        return opt

    for name, make, path in (("eager AdamW + L2Decay + ClipGradByNorm + "
                              "scheduler", eager(AdamW), "eager"),
                             ("eager Adam + L2Decay + ClipGradByNorm + "
                              "scheduler", eager(Adam), "eager"),
                             ("Lamb, TrainStep tree path", lamb, "tree"),
                             ("AdamW fused, bf16 moments", bf16_state,
                              "fused")):
        runs = {}
        for device in ("cuda", "cpu"):
            model = GPTForCausalLM(cfg, device=device)
            load_state(model, small)
            opt = make(model.parameters())
            x = torch.from_numpy(ids).to(model.device)
            before = counts(km)
            if path == "eager":
                vals = np.array(eager_losses(torch, F, model, opt, x,
                                             AGREE["steps"]))[:, None]
            else:
                step = TrainStep(model, lm_loss(F), opt, monitor_health=True)
                check((step._fused is not None) == (path == "fused"),
                      f"{name}: the {path} path was not taken")
                for _ in range(AGREE["steps"]):
                    step(x, x)
                step.flush_health()
                vals = np.array([[h[k] for k in HEALTH_KEYS]
                                 for h in step.health_log])
                if path == "fused":
                    check(all(m.dtype == torch.bfloat16
                              for ms in step._opt_store["moments"]
                              for m in ms.values()),
                          f"{name}: the moments are not bf16")
            after = counts(km)
            on_card = device == "cuda"
            got = {n: after[n] - before[n] for n, _ in FLASH_KERNELS
                   + FUSED_KERNELS}
            want = {n: AGREE["steps"] * cfg.num_layers * on_card
                    for n, _ in FLASH_KERNELS}
            want.update({n: AGREE["steps"] * on_card * (path == "fused")
                         for n, _ in FUSED_KERNELS})
            check(got == want, f"{name}, {device}: launches {got}, want "
                               f"{want}")
            runs[device] = vals
        g, c = runs["cuda"], runs["cpu"]
        rel = np.abs(g - c) / np.maximum(np.abs(c), 1e-6)
        print(f"  {name}: losses card {g[:, 0].tolist()} cpu "
              f"{c[:, 0].tolist()}; largest relative difference "
              f"{rel.max():.3g} (limit {AGREE['rtol']})")
        check(np.allclose(g, c, rtol=AGREE["rtol"], atol=1e-6),
              f"{name}: card and CPU disagree: {g} vs {c}")


def phase_eager_scaler(torch, tmods, state):
    """The eager GradScaler on the card (2 layers, float32): a good step,
    a step whose grads are not finite (the logits times inf) that
    `scaler.step` must skip while `update` halves the scale, and a good
    step that updates."""
    from paddle_tpu_torch.amp import GradScaler
    GPTForCausalLM, gpt_medium, load_state, _, AdamW, F = tmods
    cfg = gpt_medium()
    cfg.num_layers = 2
    model = GPTForCausalLM(cfg)
    load_state(model, first_layers(state, cfg.num_layers))
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 256))).cuda()
    opt = AdamW(learning_rate=TRAIN["lr"], parameters=model.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                        decr_every_n_nan_or_inf=1)
    poison = torch.ones((), device="cuda")

    def one():
        scaler.scale(lm_loss(F, poison)(model(ids), ids)).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()

    def snapshot():
        return [p.detach().clone() for p in model.parameters()]

    one()
    before, scale0 = snapshot(), scaler.get_loss_scaling()
    poison.fill_(float("inf"))
    one()
    poison.fill_(1.0)
    check(scaler._found_inf and all(torch.equal(a, b) for a, b in zip(
        snapshot(), before)), "eager: the non-finite step changed params")
    check(scaler.get_loss_scaling() == scale0 / 2,
          f"eager: scale {scaler.get_loss_scaling()}, want {scale0 / 2}")
    one()
    check(not scaler._found_inf and not all(
        torch.equal(a, b) for a, b in zip(snapshot(), before)),
        "eager: the good step after the bad one updated nothing")
    check(opt._step_count == 2, f"eager: {opt._step_count} optimizer steps, "
                                "want 2 (the bad one skipped)")
    print(f"  eager: non-finite step skipped (optimizer steps "
          f"{opt._step_count} of 3), scale {scale0:g} -> "
          f"{scaler.get_loss_scaling():g}, the next step updated")


def phase_train_1p3b(torch, km, tmods, gpt_1p3b):
    """GPT-1.3B (gpt_1p3b(), head_dim 128) at full width and depth in
    bf16, with max_position_embeddings 1024 as bench.py sets it: the
    reference's init drawn on the card (card_state), then the port's
    fastest route
    (the default fused TrainStep with PADDLE_TPU_PALLAS_LN=1 and
    PADDLE_TPU_PALLAS_XENT=1) on bench.py's batch 4 x 1024: 2 warm-up,
    5 timed and 1 profiled step, the launch counts set to 0 just before
    and read just after (train_run). Then the first 2 layers of the same
    weights in float32, 3 steps on the card (the CUDA-core flash kernels
    at head_dim 128) and on the CPU (twins), on the same route. Returns
    the run's measurements."""
    GPTForCausalLM = tmods[0]
    cfg = gpt_1p3b()
    cfg.max_position_embeddings = TRAIN_1P3B["seq"]
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == GPT_1P3B_PARAMS,
          f"GPT-1.3B has {n_params} parameters, want {GPT_1P3B_PARAMS}")
    t = time.perf_counter()
    state = card_state(torch, model, SEED)
    torch.cuda.synchronize()
    print(f"  {n_params} parameters (vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads, head_dim {cfg.hidden_size // cfg.num_heads}, tied head); "
          f"weights drawn on the card in {time.perf_counter() - t:.1f}s",
          flush=True)
    del model
    torch.cuda.empty_cache()
    res = train_run(torch, km, tmods, state, fused=True, switched=True,
                    cfg=cfg, run=TRAIN_1P3B, name="GPT-1.3B, ")
    print("  GPT-1.3B flash device ms in the profiled step: " + ", ".join(
        f"{k} {res['parts_ms'].get(k, 0.0):.2f}"
        for k in ("flash_fwd", "flash_dq", "flash_dkv")))
    print(f"  GPT-1.3B loss at the last timed step {res['last']:.4f} "
          f"(recorded: {GPT_1P3B_RECORDED_LAST_LOSS:.4f})")
    # bench.py's own 1.3B optimizer (bench.py:683-688): Momentum, a bf16
    # velocity, stochastic rounding, no masters: the tree path (one
    # tree-update launch a step), from the same weights (the AdamW run's
    # state is freed)
    sr = train_run(torch, km, tmods, state, fused=True, switched=True,
                   cfg=cfg, run=TRAIN_1P3B,
                   name="GPT-1.3B, bench.py's Momentum + SR + bf16 state, ",
                   opt=bench_momentum(torch))
    one_tree_launch(sr)
    print(f"  GPT-1.3B bench optimizer: {sr['ms']:.1f} ms/step (AdamW fused: "
          f"{res['ms']:.1f}), device {sr['device_ms']} ms (AdamW "
          f"{res['device_ms']}), the tree update "
          f"{sr['parts_ms'].get('tree_update')} ms and the tree "
          f"epilogue {sr['epilogue_ms']} ms in the profiled step "
          f"({sr['kernels']} CUDA kernel launches), peak "
          f"{sr['peak_gib']:.2f} GiB (AdamW {res['peak_gib']:.2f}); loss "
          f"{sr['first']:.4f} -> {sr['last']:.4f}")
    small = first_layers(state, AGREE["layers"])
    phase_train_agreement(torch, km, tmods, small, cfg=cfg,
                          routes=((True, True),))
    print("[7c] bench.py's GPT-1.3B headline as bench.py writes it: remat "
          "\"dots\", fused_loss(chunk=2048) behind a wrapper, "
          "TrainStep(model_returns_loss=True), bench.py's Momentum; then "
          "remat True and \"names\"", flush=True)
    bench = phase_bench_1p3b(torch, km, tmods, state, cfg, sr)
    return res, sr, bench, state, cfg


def phase_bench_1p3b(torch, km, tmods, state, cfg, sr):
    """bench.py's GPT-1.3B headline (bench.py:667-714) on phase 7b's
    weights and batch: scan_remat "dots", dropout 0, fused_loss(chunk=
    2048) behind bench.py's wrapper, TrainStep(model_returns_loss=True)
    with no fused_update argument and no health vector, as bench.py (the
    tree path: Momentum, stochastic rounding, a bf16 velocity), both
    switches set: 2 warm-up, 8 timed, 1 profiled step, replays after the
    first. Then remat True and "names", 1 warm-up, 3 timed and 1
    profiled step each (bench_policy, which also holds the replays
    against the eager body). Holds: finite, falling returned losses; the
    launches of #2-#10, the tree update and K2
    equal to BENCH_1P3B_LAUNCHES a step; the "dots" run's step-1 loss
    within 1e-3 relative of `sr`'s (7b's bench-optimizer run: the same
    weights, batch and function, unchunked and without remat); the three
    policies' step-1 losses bit-equal (the forward's kernels and cuBLAS
    are deterministic); the peak under True below `sr`'s. Returns the
    three runs' measurements."""
    runs = {}
    print("  7c sets PADDLE_TPU_PALLAS_LN=1 and PADDLE_TPU_PALLAS_XENT=1 "
          "(bench.py sets neither) until ROADMAP A.2 makes both routes the "
          "CUDA default")
    for remat, run in (("dots", BENCH_1P3B), (True, BENCH_1P3B_OTHER),
                       ("names", BENCH_1P3B_OTHER)):
        with switches(True):
            r = runs[remat] = bench_policy(torch, km, tmods, state, cfg,
                                           remat, run)
        one_tree_launch(r)
        for name, per_step in BENCH_1P3B_LAUNCHES.items():
            check(r["launches"][name] == r["n_steps"] * per_step,
                  f"7c, remat {remat!r}: {name}: {r['launches'][name]} "
                  f"launches, want {r['n_steps']} steps x {per_step}")
    dots = runs["dots"]
    rel = abs(dots["first"] - sr["first"]) / abs(sr["first"])
    print(f"  step-1 loss: remat \"dots\" + chunked loss "
          f"{dots['first']:.6f}, 7b's bench-optimizer run (no remat, "
          f"unchunked) {sr['first']:.6f}, relative difference {rel:.3g} "
          f"(limit {BENCH_LOSS_RTOL})")
    check(rel <= BENCH_LOSS_RTOL, f"7c: the step-1 loss {dots['first']} is "
                                  f"{rel} from 7b's {sr['first']}")
    firsts = {k: r["first"] for k, r in runs.items()}
    print(f"  step-1 losses by policy: {firsts} (must be bit-equal)")
    check(len(set(firsts.values())) == 1,
          f"7c: the remat policies' step-1 losses differ: {firsts}")
    check(runs[True]["peak_gib"] < sr["peak_gib"],
          f"7c: the peak under full remat, {runs[True]['peak_gib']:.3f} "
          f"GiB, is not below 7b's no-remat peak {sr['peak_gib']:.3f} GiB")
    print("  (MFU counts 6·N·tokens + 6·L·B·T²·hidden a step, the "
          "recomputed forward not counted)")
    print(f"  {'run':22s} {'wall ms':>8s} {'device ms':>9s} {'tokens/s':>9s} "
          f"{'MFU':>7s} {'idle':>6s} {'peak GiB':>8s}  loss first -> last")
    for label, r in [("7b, no remat", sr)] + [
            (f"7c, remat {k!r}", v) for k, v in runs.items()]:
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.2f}"
        idle = "n/m" if r["idle"] is None else f"{r['idle']:.3f}"
        print(f"  {label:22s} {r['ms']:8.2f} {dev:>9s} "
              f"{r['tokens_s']:9.0f} {r['mfu']:7.4f} {idle:>6s} "
              f"{r['peak_gib']:8.2f}  {r['first']:.4f} -> {r['last']:.4f}")
    for k, r in runs.items():
        print(f"  remat {k!r}: launches " + ", ".join(
            f"{n} {r['launches'][n]}" for n in BENCH_1P3B_LAUNCHES)
            + f" over {r['n_steps']} steps; device ms by family "
            + ", ".join(f"{n} {v:.2f}" for n, v in r["parts_ms"].items()))
    print(f"  {'eager vs replayed':22s} {'wall ms':>15s} {'device ms':>15s} "
          f"{'idle':>13s} {'capture ms':>10s} {'pool MiB':>8s}")
    for k, r in runs.items():
        h = r["held"]
        print(f"  {'7c, remat ' + repr(k):22s} {h['eager_ms']:7.2f} / "
              f"{h['replay_ms']:6.2f} {h['eager_device_ms']:7.2f} / "
              f"{h['replay_device_ms']:6.2f} {h['eager_idle']:6.3f} / "
              f"{h['replay_idle']:5.3f} {h['capture_ms']:10.0f} "
              f"{h['pool_mib']:8.1f}  (captures {r['captures']})")
    return runs


# -- captured train steps: replays against the eager body ----------------------

# steps held a run (from one snapshot: one call that captures, then HELD
# replays and HELD eager calls), and steps timed eager against replayed
CAPTURED_HELD = 6
CAPTURED_TIMED = 4


def state_copies(step):
    """Copies of every tensor of a step's state, in a fixed order:
    params, optimizer state (moments, masters), the GradScaler's, then
    the model's buffers (BatchNorm's running statistics)."""
    out = []

    def walk(t):
        if hasattr(t, "data_ptr"):
            out.append(t.detach().clone())
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
    walk(step.tree_state())
    return out + model_buffers(step)


def model_buffers(step):
    return [b.detach().clone() for b in step.model.buffers()]


def profiled_device_ms(torch, fn, steps=1):
    """Device milliseconds of the kernels that `fn` runs (a profiled
    window around one call, synchronized), over `steps` steps."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(device_us_by_name(prof).values()) / 1e3 / steps


def hold_replayed(torch, step, call, eager, label, steps=1, sched=None,
                  held=CAPTURED_HELD, timed=CAPTURED_TIMED):
    """One flavor's replays against its eager body, from one
    `snapshot_state` (and the scheduler's state, the model's buffers
    and the default CUDA generator's state, which Dropout draws from):
    `call` once (the capture, unless an earlier call made it; its eager
    run is that call's step), back to the snapshot, `held` replayed
    calls, back again, `held` eager ones; losses and
    every parameter, moment, master, the GradScaler's state and every
    buffer must be bit-equal. Then wall ms a step over `timed` calls of each (the
    state runs on from there) and device ms a step of one profiled call
    of each. `steps`: optimizer steps a call. Returns the measurements."""
    def mark():
        return (step.snapshot_state(), step._step_i,
                sched.state_dict() if sched is not None else None,
                model_buffers(step), torch.cuda.get_rng_state())

    def back(m):
        snap, i, sd, bufs, gen = m
        step.set_tree_state(snap["params"], snap["opt_state"])
        step.scaler_state = snap["scaler_state"]
        step._step_i = i
        if sd is not None:
            sched.set_state_dict(sd)
        with torch.no_grad():
            for b, v in zip(step.model.buffers(), bufs):
                b.copy_(v)
        torch.cuda.set_rng_state(gen)

    def run(fn, n):
        out = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            out.append(fn().reshape(-1))
            if sched is not None:
                sched.step()
        torch.cuda.synchronize()
        return torch.cat(out), (time.perf_counter() - t) / (n * steps)

    m = mark()
    before = step.retraces
    t = time.perf_counter()
    run(call, 1)
    first_s = time.perf_counter() - t
    progs = [p for c in step._graphs.values() for p in c.values()]
    prog = max(progs, key=lambda p: p.replays == 0)
    check(step.retraces - before in (0, 1) and prog.graph is not None,
          f"{label}: {step.retraces - before} captures, want at most 1")
    replays = prog.replays
    back(m)
    got, _ = run(call, held)
    got_state = state_copies(step)
    check(prog.replays == replays + held, f"{label}: {prog.replays - replays}"
                                          f" replays of {held} calls")
    back(m)
    want, _ = run(eager, held)
    want_state = state_copies(step)
    same = sum(torch.equal(a, b) for a, b in zip(got_state, want_state))
    print(f"  {label}: {held} replayed calls against {held} eager ones from "
          f"one snapshot: losses {'bit-equal' if torch.equal(got, want) else 'DIFFER'} "
          f"({got.tolist()[:4]}...), {same} of {len(got_state)} state "
          f"tensors bit-equal", flush=True)
    check(torch.equal(got, want) and same == len(got_state),
          f"{label}: a replay differs from the eager body: {got.tolist()} "
          f"vs {want.tolist()}; {same} of {len(got_state)} state tensors")
    check(torch.isfinite(got.float()).all(), f"{label}: non-finite losses")
    del got_state, want_state, m
    _, replay_ms = run(call, timed)
    _, eager_ms = run(eager, timed)
    dev_replay = profiled_device_ms(torch, call, steps)
    dev_eager = profiled_device_ms(torch, eager, steps)
    res = dict(label=label, replay_ms=replay_ms * 1e3,
               eager_ms=eager_ms * 1e3, replay_device_ms=dev_replay,
               eager_device_ms=dev_eager,
               replay_idle=max(0.0, 1 - dev_replay / (replay_ms * 1e3)),
               eager_idle=max(0.0, 1 - dev_eager / (eager_ms * 1e3)),
               capture_ms=prog.info["compile_s"] * 1e3,
               warm_ms=prog.info["warm_s"] * 1e3,
               pool_mib=prog.info["pool_bytes"] / 2**20,
               first_call_ms=first_s * 1e3, replays=prog.replays,
               captures=step.retraces)
    print(f"  {label}: wall ms a step eager {res['eager_ms']:.2f} / replayed "
          f"{res['replay_ms']:.2f}; device ms eager {dev_eager:.2f} / "
          f"replayed {dev_replay:.2f}; idle eager {res['eager_idle']:.3f} / "
          f"replayed {res['replay_idle']:.3f}; capture {res['capture_ms']:.0f}"
          f" ms (its eager run {res['warm_ms']:.0f}), pool "
          f"{res['pool_mib']:.1f} MiB", flush=True)
    return res


def phase_captured(torch, km, tmods, state):
    """Captured train steps on GPT-medium bf16 (the phase-4 weights, 8 x
    1024, both switches unset): the default fused AdamW (f32 masters)
    under LinearWarmup(CosineAnnealingDecay(1e-4, 14), 4, 0, 1e-4),
    stepped between steps, with a GradScaler (2^10, doubled every 2
    good steps) and the health vector; `run_steps(4)` replayed against 4
    eager calls; `accumulate(2)` on 2 x [4, 1024] against its eager body;
    Adamax + SR + bf16 moments (the tree path's per-leaf code and K2)
    against its eager body; bench.py's Momentum + SR + bf16 velocity
    (the tree update) as `run_steps(4)` against 4 eager calls. Each held
    bit for bit from one snapshot (hold_replayed). Returns the default
    step's measurements."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import lr as lr_mod
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    cfg = gpt_medium()
    B, T = TRAIN["batch"], TRAIN["seq"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).cuda()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(1e-4, T_max=14),
                                warmup_steps=4, start_lr=0.0, end_lr=1e-4)
    step = TrainStep(model, lm_loss(F), AdamW(
        learning_rate=sched, parameters=model.parameters(),
        multi_precision=True), scaler=GradScaler(
            init_loss_scaling=2.0 ** 10, incr_every_n_steps=2),
        monitor_health=True)
    check(step._fused is not None, "captured: not the fused epilogue")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main = hold_replayed(
        torch, step, lambda: step(ids, ids), lambda: step._eager_call(
            ids, ids), "GPT-medium, AdamW fused + scheduler + GradScaler",
        sched=sched)
    main["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    step.flush_health()
    check(np.isfinite([h["loss"] for h in step.health_log]).all(),
          "captured: non-finite health")
    print(f"  the scaler's scale after the run: "
          f"{float(step.scaler_state['scale']):g} (from 1024, doubled every "
          f"2 good steps); peak {main['peak_gib']:.2f} GiB")

    def four_calls():
        return torch.stack([step._eager_call(ids, ids) for _ in range(4)])
    hold_replayed(torch, step, lambda: step.run_steps(4, ids, ids),
                  four_calls, "GPT-medium, run_steps(4) against 4 eager "
                  "calls", steps=4, sched=sched, held=1, timed=1)
    acc = ids.reshape(2, B // 2, T)
    hold_replayed(torch, step, lambda: step.accumulate(2, acc, acc),
                  lambda: step._eager_accumulate(2, acc, acc),
                  "GPT-medium, accumulate(2)", sched=sched, held=2,
                  timed=2)
    print(f"  captures {step.retraces} (step, run_steps(4), accumulate(2)); "
          + "; ".join(f"{p.kind}{'' if p.count is None else p.count}: "
                      f"{p.info['compile_s'] * 1e3:.0f} ms, pool "
                      f"{p.info['pool_bytes'] / 2**20:.1f} MiB, "
                      f"{p.replays} replays"
                      for c in step._graphs.values() for p in c.values()))
    print(step.compiled_text(ids, ids).rstrip())
    del step, model
    torch.cuda.empty_cache()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    x = ids[:2]
    with switches(True):
        step = TrainStep(model, lm_loss(F), adamax_sr_bf16(torch)(
            model.parameters()))
        check(step._fused is None, "captured: Adamax took the fused path")
        hold_replayed(torch, step, lambda: step(x, x),
                      lambda: step._eager_call(x, x),
                      "GPT-medium, Adamax + SR + bf16 moments (2 x 1024)",
                      held=1, timed=1)
    del step, model
    torch.cuda.empty_cache()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    step = TrainStep(model, lm_loss(F), bench_momentum(torch)(
        model.parameters()))
    check(step._fused is None, "captured: Momentum + SR took the fused path")

    def four_tree_calls():
        return torch.stack([step._eager_call(ids, ids) for _ in range(4)])
    hold_replayed(torch, step, lambda: step.run_steps(4, ids, ids),
                  four_tree_calls, "GPT-medium, Momentum + SR + bf16 "
                  "velocity (the tree update), run_steps(4) against 4 eager "
                  "calls", steps=4, held=1, timed=1)
    del step, model
    torch.cuda.empty_cache()
    return main


def bench_policy(torch, km, tmods, state, cfg, remat, run):
    """One 7c run: bench.py's step (as phase_bench_1p3b says) under
    `remat`, monitor_health off as bench.py has it: run["warmup"] +
    run["timed"] replayed steps (the first captures) and 1 profiled, the
    launch counts set to 0 just before and read just after; then its
    replays held against the eager body (hold_replayed); for "dots" the
    same step with the health vector on (one more capture), timed."""
    label = f"GPT-1.3B, bench.py's headline, remat {remat!r}"
    model, step = bench_step(torch, tmods, state, cfg, remat)
    cfg = model.cfg
    check(step._fused is None, f"{label}: not the tree path")
    n_params = sum(p.numel() for p in model.parameters())
    B, T = run["batch"], run["seq"]
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(km)
    losses = []
    for _ in range(run["warmup"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(run["timed"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / run["timed"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        losses.append(step(ids, ids))
        torch.cuda.synchronize()
    launches = counts(km)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps = run["warmup"] + run["timed"] + 1
    vals = torch.stack(losses).tolist()
    check(np.isfinite(vals).all(), f"{label}: non-finite losses {vals}")
    check(vals[-1] < vals[0], f"{label}: loss did not fall: {vals}")
    tokens = B * T
    flop = 6 * n_params * tokens + 6 * cfg.num_layers * B * T * T \
        * cfg.hidden_size
    res = dict(label=label, ms=step_s * 1e3, tokens_s=tokens / step_s,
               mfu=flop / step_s / 989e12, peak_gib=peak,
               launches=launches, n_steps=n_steps, first=vals[0],
               last=vals[-2], losses=vals, tree_per_step=1, k2_per_step=0)
    res["tree_per_step"], res["k2_per_step"] = tree_launches(torch, km[7],
                                                             step)
    print(f"  {label} (replayed; monitor_health off, as bench.py): "
          f"{run['timed']} timed steps {res['ms']:.1f} ms a step, "
          f"{res['tokens_s']:.0f} tokens/s, MFU {res['mfu']:.4f}, peak "
          f"{peak:.2f} GiB; loss {vals[0]:.4f} -> {vals[-2]:.4f}", flush=True)
    res["device_ms"], res["idle"], res["other_ms"], res["parts_ms"] = \
        train_time_goes(prof, step_s)
    held = hold_replayed(torch, step, lambda: step(ids, ids),
                         lambda: step._eager_call(ids, ids), label,
                         held=3, timed=3)
    res["held"] = held
    if remat == "dots":
        step.monitor_health = True
        step(ids, ids)  # a new signature: the health vector's program
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            step(ids, ids)
        torch.cuda.synchronize()
        res["health_ms"] = (time.perf_counter() - t) / 3 * 1e3
        health = step.flush_health()
        hv = [h[k] for h in step.health_log for k in h if k != "step"]
        check(len(step.health_log) == 4 and np.isfinite(hv).all(),
              f"{label}: health {step.health_log}")
        print(f"  {label}, the health vector on (the grad norm's cost): "
              f"{res['health_ms']:.1f} ms a replayed step against "
              f"{held['replay_ms']:.1f} without; last {health}")
    res["captures"] = step.retraces
    del step, model
    torch.cuda.empty_cache()
    return res


def bench_step(torch, tmods, state, cfg, remat):
    """(model, step) of bench.py's GPT-1.3B headline (bench.py:667-714):
    the weights `state` in bf16, scan_remat `remat`, fused_loss(chunk=
    2048) behind bench.py's wrapper, TrainStep(model_returns_loss=True)
    with bench.py's Momentum and no fused_update argument (the tree
    path)."""
    GPTForCausalLM, _, load_state, TrainStep, _, _ = tmods
    cfg = copy.copy(cfg)
    cfg.scan_remat = remat
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    step = TrainStep(fused_loss_net(torch, model, BENCH_CHUNK), None,
                     bench_momentum(torch)(model.parameters()),
                     model_returns_loss=True)
    return model, step


def bench_momentum(torch):
    """bench.py's GPT-1.3B optimizer: Momentum(1e-4, 0.9) with
    stochastic rounding and a bf16 velocity, no master weights."""
    from paddle_tpu_torch.optimizer import Momentum

    def make(parameters):
        opt = Momentum(learning_rate=1e-4, momentum=0.9,
                       parameters=parameters)
        opt._stochastic_rounding = True
        opt._state_dtype = torch.bfloat16
        return opt
    return make


# -- the fused epilogue's kernels against their twins -----------------------

# f32 sums of up to 3.5e8 positive terms in two orders: the kernel adds
# runs of ~1.3e3 terms a thread, so its rounding error is at most about
# 1.3e3 * 2^-24 ~ 8e-5 relative; the twin's pairwise sums add less
FUSED_SUM_RTOL = 1e-4
FUSED_LR = 1e-4


def fused_stores(torch, fu, named, dtype, master, opt, meta=None,
                 chunk=None, inf=False):
    """(epilogue, [grads, params, opt store]) on the card for the leaves
    `named` [(name, shape)] in `dtype`: params ~ N(0, 0.02), grads ~
    N(0, 1e-3), m ~ N(0, 1e-3), v = (N(0, 1e-3))^2, masters the f32
    params (the bf16 params their rounding), drawn from a seeded
    generator on the card. inf puts one inf into the first grad bucket."""
    layout = fu.BucketLayout([(k, s, dtype) for k, s in named], chunk=chunk,
                             meta=meta)
    epi = fu.FusedEpilogue(layout, opt.fused_spec())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def draw(n, std):
        return torch.randn(n, generator=gen, device="cuda") * std

    p32 = {key: draw(b.total, 0.02) for key, b in layout.buckets.items()}
    params = {key: t.to(dtype) for key, t in p32.items()}
    masters = {key: t for key, t in p32.items()} \
        if master and dtype != torch.float32 else {}
    # in the optimizer's state dtype (float32, or bf16 for kernel #10's
    # bf16 variant)
    moments = tuple({key: (draw(b.total, 1e-3) ** (j + 1)).to(
        epi.state_dtype) for key, b in layout.buckets.items()}
                    for j in range(epi.spec["n_moments"]))
    grads = {key: draw(b.total, 1e-3).to(dtype)
             for key, b in layout.buckets.items()}
    if inf:
        first = next(iter(grads))
        grads[first][12345 % grads[first].numel()] = float("inf")
    return epi, [grads, params, {"moments": moments, "masters": masters}]


def clone_stores(stores):
    grads, params, opt = stores
    c = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return [c(grads), c(params), {"moments": tuple(c(m) for m in
                                                   opt["moments"]),
                                  "masters": c(opt["masters"])}]


def store_buffers(stores, grads=True):
    """[(label, tensor)] of every buffer the passes write."""
    g, params, opt = stores
    out = [("grad " + k, v) for k, v in g.items()] if grads else []
    out += [("param " + k, v) for k, v in params.items()]
    for j, m in enumerate(opt["moments"]):
        out += [(f"moment{j} " + k, v) for k, v in m.items()]
    return out + [("master " + k, v) for k, v in opt["masters"].items()]


def pass_args(epi, clip, scaled, out1):
    # kernel #10's rates [lr, lr_t] as float32 on the card, as the train
    # step's scalars block holds them
    return dict(spec=epi.spec, rates=epi.device_rates(FUSED_LR, 3, "cuda"),
                clip_norm=1.0 if clip == "global" else None,
                clip_value=(-1e-3, 1e-3) if clip == "value" else None,
                sumsq=out1[0], found=out1[1] if scaled else None,
                with_stats=True)


def hold_fused(torch, fk, label, epi, stores, scaled=False, clip=None,
               skip=False):
    """Both passes by the kernels on `stores` and by the twins on a copy;
    pass 2 on both sides takes the kernel's pass-1 sums, so both clip
    and skip alike. Written buffers must be bit-equal, sums within
    FUSED_SUM_RTOL; with skip (an inf grad under a live scaler), params,
    moments and masters must keep their inputs bit for bit. Returns
    (largest |kernel - twin| over written buffers, largest sum relative
    difference)."""
    twin = clone_stores(stores)
    first = clone_stores(stores) if skip else None
    scale = torch.tensor(2.0 ** 15, device="cuda") if scaled else None
    bs, bt = epi.bucket_set(*stores), epi.bucket_set(*twin)
    out1 = fk.fused_pass1(bs, scale=scale)
    ref1 = fk.fused_pass1_reference(bt, scale=scale)
    kw = pass_args(epi, clip, scaled, out1)
    out2 = fk.fused_pass2(bs, **kw)
    ref2 = fk.fused_pass2_reference(bt, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for (name, got), (_, want) in zip(store_buffers(stores),
                                      store_buffers(twin)):
        check(torch.equal(got, want), f"{label}: {name} differs from the "
                                      "twin")
        err = max(err, (got.float() - want.float()).abs().max().item())
    check(float(out1[1]) == float(ref1[1]) == float(skip),
          f"{label}: found {float(out1[1])} / twin {float(ref1[1])}")
    sums = torch.stack([out1[0], out2[0], out2[1]])
    want = torch.stack([ref1[0], ref2[0], ref2[1]])
    # equal sums (an inf sumsq under found_inf included) differ by 0
    rel = torch.where(sums == want, torch.zeros_like(sums), (
        sums - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    check(rel <= FUSED_SUM_RTOL, f"{label}: sums {sums.tolist()} vs twin "
                                 f"{want.tolist()} (rel {rel})")
    if skip:
        for (name, got), (_, was) in zip(store_buffers(stores, False),
                                         store_buffers(first, False)):
            check(torch.equal(got, was), f"{label}: {name} changed under "
                                         "found_inf")
    print(f"  {label:44s} found {float(out1[1]):.0f}  sumsq "
          f"{float(out1[0]):.6g}  param_sumsq {float(out2[0]):.6g}  "
          f"update_sumsq {float(out2[1]):.6g}  bit-equal  sums rel "
          f"{rel:.2g}", flush=True)
    del twin, first
    return err, rel


def time_fused(torch, fk, epi, stores, flush):
    """The main path's passes (no scaler, no clip, stats on) on the
    GPT-medium layout: kernel, twin and library times and byte bounds
    (the library's only for AdamW with float32 moments: the one PyTorch
    call that computes that update). Returns {kernel name:
    measurements}."""
    twin = clone_stores(stores)
    bs, bt = epi.bucket_set(*stores), epi.bucket_set(*twin)
    grads, params, opt = stores
    p2 = dict(spec=epi.spec, with_stats=True,
              rates=epi.device_rates(FUSED_LR, 3, "cuda"))
    g_bytes = sum(t.numel() * t.element_size() for t in grads.values())
    n = sum(t.numel() for t in params.values())
    m_size = torch.empty((), dtype=epi.state_dtype).element_size()
    p2_bytes = n * (3 * params[next(iter(params))].element_size()
                    + 2 * m_size * epi.spec["n_moments"]
                    + 2 * 4 * bool(opt["masters"]))
    model_bytes = epi.bytes_per_step(False, True, set(opt["masters"]))
    check(model_bytes == g_bytes + p2_bytes,
          f"bytes_per_step {model_bytes} != pass 1 {g_bytes} + pass 2 "
          f"{p2_bytes}")
    lib_g = list(grads.values())
    one = torch.ones((), device="cuda")
    ms1 = cuda_ms(torch, lambda: fk.fused_pass1(bs), 20, flush)
    ms1u = cuda_ms(torch, lambda: fk.fused_pass1(bs, scale=one), 20, flush)
    plain1 = cuda_ms(torch, lambda: fk.fused_pass1_reference(bt), 3, flush)
    lib1 = cuda_ms(torch, lambda: torch._foreach_norm(lib_g), 20, flush)
    ms2 = cuda_ms(torch, lambda: fk.fused_pass2(bs, **p2), 20, flush)
    plain2 = cuda_ms(torch, lambda: fk.fused_pass2_reference(bt, **p2), 3,
                     flush)
    # the yardstick updates the twin's f32 masters from f32 copies of its
    # grads (a tensor list per bucket), as a master-weight AdamW would
    lib2, gs = None, None
    if epi.spec["kind"] == "adamw" and epi.state_dtype == torch.float32:
        _, tp, topt = twin
        keys = list(topt["masters"]) or list(tp)
        ws = [topt["masters"][k] if topt["masters"] else tp[k]
              for k in keys]
        gs = [twin[0][k].float() for k in keys]
        ms_, vs = ([topt["moments"][j][k] for k in keys] for j in (0, 1))
        steps = [torch.zeros((), device="cuda") for _ in keys]
        lib2 = cuda_ms(torch, lambda: torch._fused_adamw_(
            ws, gs, ms_, vs, [], steps, lr=FUSED_LR, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), 20,
            flush)
    b1 = g_bytes / HBM_BYTES_PER_S * 1e3
    b2 = p2_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  pass 1 (#9): kernel {ms1:.4f}ms (with write_u {ms1u:.4f}ms, "
          f"bound {2 * b1:.4f}) plain {plain1:.4f}ms "
          f"library torch._foreach_norm {lib1:.4f}ms bound {b1:.4f}ms "
          f"(bytes: {g_bytes / 1e9:.3f} GB of grads) bound/kernel "
          f"{b1 / ms1:.3f}")
    lib_text = f"{lib2:.4f}ms" if lib2 is not None else "none"
    print(f"  pass 2 (#10, {epi.spec['kind']}, moments "
          f"{str(epi.state_dtype)[6:]}): kernel {ms2:.4f}ms plain "
          f"{plain2:.4f}ms library torch._fused_adamw_ (f32 masters) "
          f"{lib_text} bound {b2:.4f}ms (bytes: {p2_bytes / 1e9:.3f} GB, "
          f"{p2_bytes / n:.0f} B/param) bound/kernel {b2 / ms2:.3f}; "
          f"bytes_per_step {model_bytes / 1e9:.3f} GB = pass 1 + pass 2",
          flush=True)
    del twin, gs
    return {"fused_pass1": dict(ms=ms1, plain_ms=plain1, library_ms=lib1,
                                bound_ms=b1, bound_by="bytes"),
            "fused_pass2": dict(ms=ms2, plain_ms=plain2, library_ms=lib2,
                                bound_ms=b2, bound_by="bytes")}


def phase_fused(torch, fk, fu, omods, tmods, flush):
    """Kernels #9 and #10 against their twins: GPT-medium's layout in
    every configuration the ported epilogue takes (bf16 moments too),
    then a small ragged layout with mixed metadata. Returns the kernels
    line's fields ("fused_pass2_bf16_state": #10 with bf16 moments)."""
    GPTForCausalLM, gpt_medium = tmods[0], tmods[1]
    SGD, Momentum, AdamW = omods
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    named = [(k, tuple(p.shape)) for k, p in model.named_parameters()]
    del model
    torch.cuda.empty_cache()
    adamw = AdamW(learning_rate=FUSED_LR, multi_precision=True)
    bf16 = torch.bfloat16
    lay = fu.BucketLayout([(k, s, bf16) for k, s in named])
    n = sum(b.total for b in lay.buckets.values())
    print(f"  GPT-medium layout: {len(lay.buckets)} buckets, {n} "
          f"parameters")
    check(len(lay.buckets) == 16 and n == 354_871_296,
          f"layout {len(lay.buckets)} buckets / {n} parameters")
    cases = [
        ("AdamW bf16+masters, GradScaler (write_u)", bf16, True, adamw,
         dict(scaled=True)),
        ("AdamW bf16+masters, found_inf = 1", bf16, True, adamw,
         dict(scaled=True, skip=True)),
        ("AdamW bf16+masters, ClipGradByGlobalNorm", bf16, True, adamw,
         dict(clip="global")),
        ("AdamW bf16+masters, ClipGradByValue", bf16, True, adamw,
         dict(clip="value")),
        ("Momentum-Nesterov bf16+masters", bf16, True,
         Momentum(FUSED_LR, momentum=0.9, use_nesterov=True,
                  multi_precision=True), {}),
        ("SGD bf16+masters", bf16, True,
         SGD(FUSED_LR, multi_precision=True), {}),
        ("AdamW float32, no masters", torch.float32, False, adamw, {}),
    ]
    worst, worst_rel = 0.0, 0.0
    epi, stores = fused_stores(torch, fu, named, bf16, True, adamw)
    e, r = hold_fused(torch, fk, "AdamW bf16+masters, no scaler (main path)",
                      epi, stores)
    worst, worst_rel = max(worst, e), max(worst_rel, r)
    times = time_fused(torch, fk, epi, stores, flush)
    del epi, stores
    # kernel #10's bf16-moment variant (the optimizer's `_state_dtype`):
    # AdamW with f32 masters (22 B a parameter), the main path of phase
    # 7's fourth run, and Momentum without masters (10 B)
    adamw_bf16 = AdamW(learning_rate=FUSED_LR, multi_precision=True)
    adamw_bf16._state_dtype = bf16
    mom_bf16 = Momentum(FUSED_LR, momentum=0.9)
    mom_bf16._state_dtype = bf16
    for label, opt, master, key in (
            ("AdamW bf16+masters, bf16 moments (K1)", adamw_bf16, True,
             "fused_pass2_bf16_state"),
            ("Momentum bf16, bf16 velocity, no masters (K1)", mom_bf16,
             False, None)):
        epi, stores = fused_stores(torch, fu, named, bf16, master, opt)
        check(all(t.dtype == bf16 for m in stores[2]["moments"]
                  for t in m.values()), f"{label}: moments not bf16")
        e, r = hold_fused(torch, fk, label, epi, stores)
        worst, worst_rel = max(worst, e), max(worst_rel, r)
        e, r = hold_fused(torch, fk, label + ", GradScaler", epi, stores,
                          scaled=True, clip="global")
        worst, worst_rel = max(worst, e), max(worst_rel, r)
        t2 = time_fused(torch, fk, epi, stores, flush)["fused_pass2"]
        if key is not None:
            times[key] = t2
        del epi, stores
        torch.cuda.empty_cache()
    for label, dtype, master, opt, kw in cases:
        epi, stores = fused_stores(torch, fu, named, dtype, master, opt,
                                   inf=kw.get("skip", False))
        e, r = hold_fused(torch, fk, label, epi, stores, **kw)
        worst, worst_rel = max(worst, e), max(worst_rel, r)
        del epi, stores
        torch.cuda.empty_cache()
    ragged = [("h.0.w", (33, 7)), ("h.1.w", (33, 7)), ("b", (130,)),
              ("nc", (5, 9)), ("nd", (17,)), ("ls", (300,))]
    meta = {"nc": {"need_clip": False}, "nd": {"decay": False},
            "ls": {"lr_scale": 0.5}}
    for dtype, master in ((bf16, True), (torch.float32, False)):
        epi, stores = fused_stores(torch, fu, ragged, dtype, master, adamw,
                                   meta=meta, chunk=128)
        check(any(b.total % 128 for b in epi.layout.buckets.values()),
              "the ragged layout has no partial chunk")
        e, r = hold_fused(torch, fk, f"ragged layout {str(dtype)[6:]}, "
                          f"scaler + global clip", epi, stores, scaled=True,
                          clip="global")
        worst, worst_rel = max(worst, e), max(worst_rel, r)
    print(f"  every case bit-equal to its twin; largest sum relative "
          f"difference {worst_rel:.3g} (limit {FUSED_SUM_RTOL})")
    for name in times:
        times[name]["max_abs_err"] = worst
    return times


# -- the stochastic-rounding kernel (K2) against its twin --------------------

# one stochastically rounded element's 32-bit integer operations:
# threefry2x32's 20 rounds (an add, a rotate and a xor each) and its 12
# adds of the count and the 5 key injections (72), the xor of the two
# output words, the mask, the add and the truncation (4)
SR_OPS_PER_ELEMENT = 76
# the card's rate for them: 64 lanes an SM a clock on the integer pipe
# (shifts, logic, adds) and 64 on the multiply-add pipe (integer
# multiply-adds, which also add), 128 in all: the lanes of the float32
# rate of PEAK_FLOPS, whose FMA counts as two operations, so half of it
INT32_OPS_PER_S = PEAK_FLOPS["torch.float32"] / 2
# GPT-1.3B's leaves by size: wte (50304 x 2048, tied), an MLP weight
# (2048 x 8192), the qkv weight (2048 x 6144), a bias; and odd sizes
SR_SIZES = (103_022_592, 16_777_216, 12_582_912, 2048, 4099, 7, 1)
SR_KEYS = ((0, 0x5bd1e995), (2297781694, 1477100869))


def phase_stochastic_round(torch, srk, flush):
    """Kernel K2 against its twin at GPT-1.3B's leaf sizes and odd ones,
    over two keys: the bf16 bits equal. Times at GPT-1.3B's wte size (its
    largest leaf): kernel, twin, bound (6 bytes an
    element, or its SR_OPS_PER_ELEMENT integer operations at
    INT32_OPS_PER_S: the larger). No
    PyTorch call rounds stochastically: library none. Returns the
    kernels line's fields."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    held = 0
    for n in SR_SIZES:
        x = torch.randn(n, generator=gen, device="cuda") * 0.02
        for key in SR_KEYS:
            got = srk.stochastic_round(x, key)
            want = srk.stochastic_round_reference(x, key)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"stochastic_round n={n} key={key}: differs from the twin")
            held += 1
            del got, want
        if n == SR_SIZES[0]:
            # the key's words on the card, as the train step's scalars
            # block holds them
            key = torch.tensor(SR_KEYS[0], dtype=torch.int64,
                               device="cuda").to(torch.int32)
            ms = cuda_ms(torch, lambda: srk.stochastic_round(x, key), 20,
                         flush)
            plain = cuda_ms(torch, lambda: srk.stochastic_round_reference(
                x, SR_KEYS[0]), 3, flush)
            by_bytes = n * 6 / HBM_BYTES_PER_S * 1e3
            by_ops = n * SR_OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3
            bound = max(by_bytes, by_ops)
            bound_by = "bytes" if by_bytes >= by_ops else "operations"
            print(f"  n={n}: kernel {ms:.4f}ms plain {plain:.4f}ms bound "
                  f"{bound:.4f}ms ({bound_by}; bytes {by_bytes:.4f}, "
                  f"operations {by_ops:.4f}) bound/kernel {bound / ms:.3f}",
                  flush=True)
        del x
    print(f"  {held} calls bit-equal to the twin (sizes {SR_SIZES}, "
          f"{len(SR_KEYS)} keys)")
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=bound_by,
                library_ms=None, max_abs_err=0.0)


# -- the tree update against its twin -----------------------------------------

# float operations an element of each kind's update (decay included),
# beside SR_OPS_PER_ELEMENT integer operations for each threefry hash
TREE_FLOPS = {"sgd": 3, "momentum": 5, "adam": 13}
TREE_SUM_RTOL = 1e-4  # the health sums, as the fused passes'
TREE_SPIN = 40_000_000  # ~20 ms: the wrapper's host work a call (keys, table)


def tree_leaves(torch, named, opt, seed):
    """(params, grads, states, masters) lists in sorted name order for
    the leaves `named` [(name, shape)] in bf16 on the card under `opt`'s
    init_leaf_state: params ~ N(0, 0.02), grads ~ N(0, 1e-3), states
    ~ N(0, 1e-3) (the second squared), from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params, grads, states, masters = [], [], [], []
    for name, shape in sorted(named):
        p = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        tree = opt.init_leaf_state(p)
        inner = tree["state"] if isinstance(tree, dict) else tree
        for j, t in enumerate(inner):
            t.copy_(torch.randn(shape, generator=gen, device="cuda") * 1e-3)
            if j:
                t.square_()
        params.append(p)
        grads.append((torch.randn(shape, generator=gen, device="cuda")
                      * 1e-3).to(torch.bfloat16))
        states.append(tuple(inner))
        masters.append(tree["master"] if isinstance(tree, dict) else None)
    return params, grads, states, masters


def clone_leaves(leaves):
    params, grads, states, masters = leaves
    return ([t.clone() for t in params], grads,
            [tuple(t.clone() for t in inner) for inner in states],
            [None if m is None else m.clone() for m in masters])


def leaf_buffers(leaves):
    params, _, states, masters = leaves
    out = [(f"param {i}", t) for i, t in enumerate(params)]
    out += [(f"state{j} {i}", t) for i, inner in enumerate(states)
            for j, t in enumerate(inner)]
    return out + [(f"master {i}", t) for i, t in enumerate(masters)
                  if t is not None]


def tree_bound(tk, leaves, opt):
    """(bound ms, by, bytes ms, operations ms, bytes) of one tree update
    by `opt`: each param, state and master read and written once, each
    grad read once; or SR_OPS_PER_ELEMENT integer operations a
    stochastically rounded bf16 target at INT32_OPS_PER_S and the
    update's float operations at the float32 rate (the larger of the
    two: they issue to different lanes)."""
    params, grads, states, masters = leaves
    spec = tk.tree_spec(opt)
    nbytes = int_ops = flops = 0
    kind = "adam" if spec["kind"] == "adamw" else spec["kind"]
    for p, g, inner, m in zip(params, grads, states, masters):
        n = p.numel()
        nbytes += g.numel() * g.element_size() + 2 * sum(
            t.numel() * t.element_size() for t in (p, *inner, m)
            if t is not None)
        bf16 = [t for t in (p if m is None else None, *inner)
                if t is not None and str(t.dtype) == "torch.bfloat16"]
        hashes = len(bf16) if spec["sr"] else 0
        int_ops += n * hashes * SR_OPS_PER_ELEMENT
        flops += n * TREE_FLOPS[kind]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(int_ops / INT32_OPS_PER_S,
                 flops / PEAK_FLOPS["torch.float32"]) * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations", by_bytes, by_ops, nbytes)


def tree_scalars(tk, opt, lr, step, leaves):
    """The step's scalar rows of `leaves` on the card, as the train
    step's scalars block holds them."""
    return tk.scalars_tensor(tk.scalar_rows(
        opt, lr, step, len(leaves[0]),
        n_state=tk.tree_spec(opt)["n_moments"]), leaves[0][0].device)


def hold_tree(torch, tk, label, leaves, opt, lr, step, found=None):
    """The tree update by `opt` through the kernel on `leaves` and by the
    twin on a copy: written buffers bit-equal, the sums within TREE_SUM_RTOL; with
    found set, every buffer as it was. Returns the sums' relative
    difference."""
    twin = clone_leaves(leaves)
    was = clone_leaves(leaves) if found is not None else None
    flag = None if found is None else torch.tensor(found, device="cuda")
    rows = tree_scalars(tk, opt, lr, step, leaves)
    before = tk.tree_update.launches
    got = tk.tree_update(opt, *leaves, rows, flag, with_stats=True)
    launched = tk.tree_update.launches - before
    want = tk.tree_update_reference(opt, *twin, rows, flag, with_stats=True)
    torch.cuda.synchronize()
    groups = len(tk.leaf_groups(leaves[0], leaves[2], leaves[3]))
    check(launched == groups, f"{label}: {launched} launches, want {groups}")
    for (name, a), (_, b) in zip(leaf_buffers(leaves), leaf_buffers(twin)):
        check(torch.equal(a, b), f"{label}: {name} differs from the twin")
    if found:
        for (name, a), (_, b) in zip(leaf_buffers(leaves), leaf_buffers(was)):
            check(torch.equal(a, b), f"{label}: {name} changed under "
                                     "found_inf")
    rel = torch.where(got == want, torch.zeros_like(got), (
        got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    check(rel <= TREE_SUM_RTOL, f"{label}: sums {got.tolist()} vs twin "
                                f"{want.tolist()} (rel {rel})")
    print(f"  {label:58s} bit-equal; sums {got.tolist()} (rel {rel:.2g}); "
          f"{launched} launch(es)", flush=True)
    del twin, was
    return rel


def time_tree(torch, tk, label, leaves, opt, lr, flush, library=None):
    """Kernel, twin and library times (`library`: a callable, or None) of
    the tree update by `opt` at step 3, with its bound. Returns the
    kernels line's fields."""
    twin = clone_leaves(leaves)
    # a call builds and ships the leaf table only
    rows = tree_scalars(tk, opt, lr, 3, leaves)
    ms = cuda_ms(torch, lambda: tk.tree_update(opt, *leaves, rows,
                                               with_stats=True), 10, flush,
                 spin=TREE_SPIN)
    # the twin of the main path's stochastic rounding takes seconds a call
    # (~150 int64 torch kernels an element): one warm-up, one timed call
    plain = cuda_ms(torch, lambda: tk.tree_update_reference(
        opt, *twin, rows, with_stats=True), 1, flush, spin=TREE_SPIN,
        warmup=1)
    lib = None
    if library is not None:
        try:
            lib = cuda_ms(torch, library, 10, flush)
        except (RuntimeError, TypeError) as e:  # no usable library call
            print(f"  {label}: library call unavailable: {e}")
    bound, by, by_bytes, by_ops, nbytes = tree_bound(tk, leaves, opt)
    n = sum(p.numel() for p in leaves[0])
    print(f"  {label}: kernel {ms:.4f}ms plain {plain:.4f}ms library "
          f"{'none' if lib is None else f'{lib:.4f}ms'} bound {bound:.4f}ms "
          f"({by}; bytes {by_bytes:.4f}: {nbytes / 1e9:.3f} GB, "
          f"{nbytes / n:.1f} B/param; operations {by_ops:.4f}) "
          f"bound/kernel {bound / ms:.3f}", flush=True)
    del twin
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by, max_abs_err=0.0)


def sass_counts(path, label):
    """The SASS opcodes, in order, of the kernel `label` (a kernel_label)
    in the library at `path` (cuobjdump -sass), NOPs left out."""
    from paddle_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ops, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel_label(f"'{line.split(':', 1)[1].strip()}'") \
                == label
        elif inside and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                line)):
            if m.group(1) != "NOP":
                ops.append(m.group(1))
    return ops


def phase_tree_update(torch, tk, tmods, gpt_1p3b, flush):
    """The tree update against its twin at GPT-1.3B's full leaf list on
    bench.py's optimizer (Momentum, bf16 velocity, stochastic rounding;
    also under found_inf, at two steps) and with rounding to nearest (the
    library yardstick: torch._fused_sgd_ with momentum buffers), and at
    GPT-medium's leaf list on phase 7's tree run's optimizer (AdamW with
    f32 masters and moments; the yardstick torch._fused_adamw_ over f32
    masters and f32 copies of the grads). Times, bounds, and the SASS of
    the main variant. Returns the kernels line's fields (GPT-1.3B, bench
    optimizer)."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, Momentum
    GPTForCausalLM, gpt_medium = tmods[0], tmods[1]
    named = {}
    big = gpt_1p3b()
    big.max_position_embeddings = TRAIN_1P3B["seq"]
    for cfg_name, cfg in (("1.3B", big), ("medium", gpt_medium())):
        model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
        named[cfg_name] = [(k, tuple(p.shape))
                           for k, p in model.named_parameters()]
        del model
        torch.cuda.empty_cache()
    n13 = sum(int(np.prod(s)) for _, s in named["1.3B"])
    check(n13 == GPT_1P3B_PARAMS and len(named["1.3B"]) == 292,
          f"GPT-1.3B leaf list: {len(named['1.3B'])} leaves, {n13} "
          "parameters")
    lr = float(np.float32(1e-4))
    bench = Momentum(learning_rate=lr, momentum=0.9)
    bench._stochastic_rounding = True
    bench._state_dtype = torch.bfloat16
    leaves = tree_leaves(torch, named["1.3B"], bench, SEED + 13)
    label = "GPT-1.3B, Momentum + SR + bf16 velocity"
    hold_tree(torch, tk, label + ", step 1", leaves, bench, lr, 1)
    hold_tree(torch, tk, label + ", step 2", leaves, bench, lr, 2)
    hold_tree(torch, tk, label + ", found_inf", leaves, bench, lr, 3,
              found=True)
    main = time_tree(torch, tk, label + " (main path)", leaves, bench, lr,
                     flush)
    rne = Momentum(learning_rate=lr, momentum=0.9)
    rne._state_dtype = torch.bfloat16
    hold_tree(torch, tk, "GPT-1.3B, Momentum + bf16 velocity, nearest",
              leaves, rne, lr, 4)
    ps, gs, sts, _ = leaves
    bufs = [inner[0] for inner in sts]
    time_tree(torch, tk, "GPT-1.3B, Momentum + bf16 velocity, nearest",
              leaves, rne, lr, flush, library=lambda: torch._fused_sgd_(
                  ps, gs, bufs, weight_decay=0.0, momentum=0.9, lr=lr,
                  dampening=0.0, nesterov=False, maximize=False,
                  is_first_step=False))
    del leaves, ps, gs, sts, bufs
    torch.cuda.empty_cache()
    adamw = AdamW(learning_rate=lr, multi_precision=True)
    leaves = tree_leaves(torch, named["medium"], adamw, SEED + 14)
    hold_tree(torch, tk, "GPT-medium, AdamW + f32 masters (phase 7 tree)",
              leaves, adamw, lr, 1)
    ws = leaves[3]
    g32 = [g.float() for g in leaves[1]]
    ms_, vs = ([inner[j] for inner in leaves[2]] for j in (0, 1))
    steps = [torch.zeros((), device="cuda") for _ in ws]
    time_tree(torch, tk, "GPT-medium, AdamW + f32 masters", leaves, adamw,
              lr, flush, library=lambda: torch._fused_adamw_(
                  ws, g32, ms_, vs, [], steps, lr=lr, beta1=0.9, beta2=0.999,
                  weight_decay=0.01, eps=1e-8, amsgrad=False,
                  maximize=False))
    del leaves, ws, g32, ms_, vs
    torch.cuda.empty_cache()
    label = "tree_update_kernel<bf16, bf16, KIND=1, SR=1>"
    ops = sass_counts(_build.library_path("tree_update"), label)
    check(ops, f"no SASS found for {label}")
    # the arithmetic of a thread's tile lies between its first and last
    # rotation; loads, stores, the leaf search and the sums lie outside
    rot = [i for i, op in enumerate(ops) if op.startswith("SHF.L.W")]
    body = ops[rot[0]:rot[-1] + 1]
    per = tk.VEC * tk.VECS
    hist = {}
    for op in body:
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
    print(f"  SASS of {label}: {len(ops)} instructions in all; its "
          f"arithmetic (first to last rotation) {len(body)}, "
          f"{len(body) / per:.1f} an element ({per} a thread a tile, "
          f"{len(rot) // per} rotations an element): " + ", ".join(
              f"{k} {v}" for k, v in sorted(hist.items(),
                                            key=lambda kv: -kv[1])[:10]),
          flush=True)
    return main


def phase_scaler(torch, km, tmods, state):
    """2-layer float32 steps with GradScaler(init 2^10, halve after one
    bad step) on each epilogue: a good step, a step whose loss is not
    finite (the logits times inf), a good step."""
    from paddle_tpu_torch.amp import GradScaler
    GPTForCausalLM, gpt_medium, load_state, TrainStep, AdamW, F = tmods
    cfg = gpt_medium()
    cfg.num_layers = 2
    small = first_layers(state, cfg.num_layers)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 256))).cuda()

    def state_of(step):
        out = [p.clone() for p in step.params.values()]
        for leaf in step.opt_state.values():
            out += [t.clone() for t in (leaf["state"] if isinstance(
                leaf, dict) else leaf)]
        return out

    for fused in (True, False):
        name = "fused" if fused else "tree"
        model = GPTForCausalLM(cfg)
        load_state(model, small)
        poison = torch.ones((), device="cuda")
        scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                            decr_every_n_nan_or_inf=1)
        step = TrainStep(model, lm_loss(F, poison),
                         AdamW(learning_rate=TRAIN["lr"],
                               parameters=model.parameters()),
                         scaler=scaler, monitor_health=True,
                         fused_update=fused)
        check((step._fused is not None) == fused, f"{name}: wrong path")
        step(ids, ids)
        before = state_of(step)
        scale0 = float(step.scaler_state["scale"])
        poison.fill_(float("inf"))
        bad = step(ids, ids)
        poison.fill_(1.0)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(state_of(step), before)),
              f"{name}: the non-finite step changed params or moments")
        check(float(step.scaler_state["scale"]) == scale0 / 2,
              f"{name}: scale {float(step.scaler_state['scale'])}, want "
              f"{scale0 / 2}")
        good = step(ids, ids)
        after = state_of(step)
        check(not all(torch.equal(a, b) for a, b in zip(after, before)),
              f"{name}: the good step after the bad one updated nothing")
        step.flush_health()
        found = [h["found_inf"] for h in step.health_log]
        check(found == [0.0, 1.0, 0.0], f"{name}: found_inf {found}")
        check(np.isfinite(float(good)) and not np.isfinite(float(bad)),
              f"{name}: losses {float(bad)}, {float(good)}")
        step.sync_to_model()
        check(scaler.get_loss_scaling() == scale0 / 2,
              f"{name}: sync_to_model gave {scaler.get_loss_scaling()}")
        print(f"  {name}: non-finite step skipped bit-exactly, scale "
              f"{scale0:g} -> {scale0 / 2:g}, the next step updated; "
              f"found_inf {found}")
        del step, model


# -- LayerNorm (#5-#6) and softmax cross-entropy (#7-#8) against twins ------

# operations an element, counted at the float32 peak (67 TFLOP/s): LN
# forward sum, centred square, normalise and affine; backward xhat, w*dy,
# the two row sums, the dw/db sums and dx; xent forward max, shift, exp,
# sum; backward shift, exp, one-hot, scale. Bytes bound all four.
NORM_XENT_OPS = {"layer_norm_fwd": 8, "layer_norm_bwd": 14,
                 "softmax_xent_fwd": 4, "softmax_xent_bwd": 4}
# (kernel pair, rows, columns, dtype, timed): the training shapes first
# (GPT-medium's; GPT-1.3B's LayerNorm [4096, 2048] is timed too; xent at
# a chunk of phase 7c's chunked loss, [2048, 50304], and at GPT-medium's
# unchunked [8192, 50304]); phase 18 (a)'s switched route in float32:
# LayerNorm [4096, 512] and xent [4096, 32000]
NORM_XENT_CASES = [("ln", 8192, 1024, "bfloat16", True),
                   ("ln", 4096, 2048, "bfloat16", True),
                   ("ln", 8192, 1024, "float32", False),
                   ("ln", 4096, 512, "float32", False),
                   ("xent", 4096, 32000, "float32", False),
                   ("ln", 1000, 4096, "bfloat16", False),
                   ("ln", 8192, 1000, "bfloat16", False),
                   ("ln", 257, 1001, "float32", False),
                   ("ln", 64, 16384, "bfloat16", False),
                   ("xent", 2048, 50304, "bfloat16", True),
                   ("xent", 8192, 50304, "bfloat16", True),
                   ("xent", 8192, 50304, "float32", False),
                   ("xent", 1000, 50257, "bfloat16", False)]
# mean, rstd, loss and lse: |kernel - twin| <= STAT_TOL * max(1, |twin|)
STAT_TOL = 1e-5
# dw, db in float32: largest |kernel - twin| over largest |twin|
SUM_RTOL = 1e-4
# xent dx, per element against |twin| with no max(1, .) floor (a softmax
# entry over 50k columns is ~1e-6): one bf16 ulp in bfloat16, and in
# float32 |kernel - twin| <= DX_RTOL * |twin| + DX_ATOL
DX_RTOL, DX_ATOL = 1e-5, 1e-9


def within(got, want, tol):
    """Largest |got - want| if it is <= tol * max(1, |want|) everywhere,
    else None."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= tol * want.abs().clamp_min(1.0)).all())
    return diff.max().item() if ok else None


def bf16_ulps(torch, got, want):
    a, b = (t.view(torch.int16).long() for t in (got, want))
    a = torch.where(a < 0, -(a + (1 << 15)), a)
    b = torch.where(b < 0, -(b + (1 << 15)), b)
    return int((a - b).abs().max())


def norm_xent_bound(name, shape, it, it_w=None):
    """(ms, "bytes"|"operations"): each input read once and each output
    written once; the operations of NORM_XENT_OPS at the f32 peak."""
    R, C = shape
    n = R * C
    if name == "layer_norm_fwd":    # x, w, b -> y, mean, rstd
        n_bytes = 2 * n * it + 2 * C * it_w + 2 * R * 4
    elif name == "layer_norm_bwd":  # x, dy, w, mean, rstd -> dx, dw, db
        n_bytes = 3 * n * it + 3 * C * it_w + 2 * R * 4
    elif name == "softmax_xent_fwd":  # logits, labels -> loss, lse
        n_bytes = n * it + 3 * R * 4
    else:                           # logits, labels, lse, dloss -> dx
        n_bytes = 2 * n * it + 3 * R * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = NORM_XENT_OPS[name] * n / PEAK_FLOPS["torch.float32"]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_norm_xent(torch, flush, res, name, kernel, twin, library, shape,
                   it, it_w=None, clean_too=False):
    """Times of a kernel, its twin and the library call after the usual
    (dirty) flush; with clean_too the kernel's after a clean one as well
    (printed, not in the kernels line)."""
    bound_ms, bound_by = norm_xent_bound(name, shape, it, it_w)
    ms = cuda_ms(torch, kernel, 20, flush)
    plain_ms = cuda_ms(torch, twin, 3, flush)
    library_ms = cuda_ms(torch, library, 10, flush)
    res[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
    clean = ""
    if clean_too:
        k = cuda_ms(torch, kernel, 20, flush, clean=True)
        clean = (f"; clean flush: kernel={k:.4f}ms bound/kernel="
                 f"{bound_ms / k:.3f}")
    print(f"    {name:18s} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
          f"library={library_ms:.4f}ms bound={bound_ms:.4f}ms ({bound_by}) "
          f"bound/kernel={bound_ms / ms:.3f}{clean}", flush=True)


def hold_norm(torch, lk, flush, R, C, dtype, timed):
    """Both LayerNorm kernels against their twins on [R, C] (weight and
    bias in x's dtype); the backward kernel and twin take the twin's mean
    and rstd. Returns {kernel name: measurements}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + R + C)
    draw = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                  device="cuda")
    x = (2 * draw(R, C) + 0.5).to(dtype)
    w, b = (1 + 0.3 * draw(C)).to(dtype), (0.1 * draw(C)).to(dtype)
    dy = draw(R, C).to(dtype)
    label = f"LayerNorm [{R}, {C}] {str(dtype)[6:]}"
    y, mu, rstd = lk.layer_norm_fwd(x, w, b)
    want_y, want_mu, want_rstd = lk.layer_norm_fwd_reference(x, w, b)
    bwd = (x, w, want_mu, want_rstd, dy)
    dx, dw, db = lk.layer_norm_bwd(*bwd)
    torch.cuda.synchronize()
    want_dx, want_dw, want_db = lk.layer_norm_bwd_reference(*bwd)
    errs = {}
    for key, got, want, tol in (("y", y, want_y, TOL[str(dtype)]),
                                ("dx", dx, want_dx, TOL[str(dtype)]),
                                ("mean", mu, want_mu, STAT_TOL),
                                ("rstd", rstd, want_rstd, STAT_TOL)):
        errs[key] = within(got, want, tol)
        check(errs[key] is not None, f"{label}: {key} beyond "
                                     f"{tol} * max(1, |twin|)")
    for key, got, want in (("dw", dw, want_dw), ("db", db, want_db)):
        check(got.dtype == dtype, f"{label}: {key} is {got.dtype}")
        errs[key] = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            ulps = bf16_ulps(torch, got, want)
            check(ulps <= 1, f"{label}: {key} {ulps} bf16 ulps from the twin")
        else:
            rel = errs[key] / want.float().abs().max().item()
            check(rel <= SUM_RTOL, f"{label}: {key} relative error {rel}")
    print(f"  {label:34s} err y {errs['y']:.3g} mean {errs['mean']:.3g} "
          f"rstd {errs['rstd']:.3g} dx {errs['dx']:.3g} dw {errs['dw']:.3g} "
          f"db {errs['db']:.3g}", flush=True)
    res = {"layer_norm_fwd": dict(max_abs_err=max(
               errs["y"], errs["mean"], errs["rstd"])),
           "layer_norm_bwd": dict(max_abs_err=max(
               errs["dx"], errs["dw"], errs["db"]))}
    if timed:
        fl = torch.nn.functional.layer_norm
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        out = fl(xg, (C,), wg, bg, 1e-5)
        it = x.element_size()
        time_norm_xent(torch, flush, res, "layer_norm_fwd",
                       lambda: lk.layer_norm_fwd(x, w, b),
                       lambda: lk.layer_norm_fwd_reference(x, w, b),
                       lambda: fl(x, (C,), w, b, 1e-5), (R, C), it, it,
                       clean_too=True)
        time_norm_xent(torch, flush, res, "layer_norm_bwd",
                       lambda: lk.layer_norm_bwd(*bwd),
                       lambda: lk.layer_norm_bwd_reference(*bwd),
                       lambda: torch.autograd.grad(out, (xg, wg, bg), dy,
                                                   retain_graph=True),
                       (R, C), it, it, clean_too=True)
    return res


def hold_xent(torch, xk, flush, N, V, dtype, timed):
    """Both softmax-xent kernels against their twins on [N, V] logits,
    about 10 % of the labels -1 and some >= V; the backward kernel and
    twin take the twin's lse and dloss = 1 on rows with a label in
    [0, V), 0 elsewhere (the route's masking). Returns {kernel name:
    measurements}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + N + V)
    x = (3 * torch.randn(N, V, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(0, V, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[::10] = -1
    lab[1::97] = V + torch.arange(len(lab[1::97]), device="cuda",
                                  dtype=torch.int32)
    valid = (lab >= 0) & (lab < V)
    dloss = valid.float()
    label = f"xent [{N}, {V}] {str(dtype)[6:]}"
    loss, lse = xk.softmax_xent_fwd(x, lab)
    want_loss, want_lse = xk.softmax_xent_fwd_reference(x, lab)
    bwd = (x, lab, want_lse, dloss)
    dx = xk.softmax_xent_bwd(*bwd)
    torch.cuda.synchronize()
    want_dx = xk.softmax_xent_bwd_reference(*bwd)
    errs = {}
    for key, got, want in (("loss", loss, want_loss),
                           ("lse", lse, want_lse)):
        errs[key] = within(got, want, STAT_TOL)
        check(errs[key] is not None, f"{label}: {key} beyond "
                                     f"{STAT_TOL} * max(1, |twin|)")
    check(dx.dtype == dtype, f"{label}: dx is {dx.dtype}")
    diff = (dx.float() - want_dx.float()).abs()
    errs["dx"] = diff.max().item()
    dx_rel = errs["dx"] / want_dx.float().abs().max().item()
    if dtype == torch.bfloat16:
        ulps = bf16_ulps(torch, dx, want_dx)
        check(ulps <= 1, f"{label}: dx {ulps} bf16 ulps from the twin")
    else:
        over = diff > DX_RTOL * want_dx.float().abs() + DX_ATOL
        check(not bool(over.any()), f"{label}: dx beyond {DX_RTOL} * |twin| "
                                    f"+ {DX_ATOL} at {int(over.sum())} "
                                    f"elements")
    check(bool((loss[~valid] == lse[~valid]).all()),
          f"{label}: a label outside [0, V) picked a logit")
    print(f"  {label:34s} err loss {errs['loss']:.3g} lse {errs['lse']:.3g} "
          f"dx {errs['dx']:.3g} (max |dx - twin| / max |twin| "
          f"{dx_rel:.3g}; {int((~valid).sum())} labels outside [0, V))",
          flush=True)
    res = {"softmax_xent_fwd": dict(max_abs_err=max(errs["loss"],
                                                    errs["lse"])),
           "softmax_xent_bwd": dict(max_abs_err=errs["dx"])}
    if timed:
        ce = torch.nn.functional.cross_entropy
        lib_lab = torch.where(valid, lab, -100).long()
        xg = x.clone().requires_grad_()
        out = ce(xg, lib_lab, reduction="none")
        it = x.element_size()
        time_norm_xent(torch, flush, res, "softmax_xent_fwd",
                       lambda: xk.softmax_xent_fwd(x, lab),
                       lambda: xk.softmax_xent_fwd_reference(x, lab),
                       lambda: ce(x, lib_lab, reduction="none"), (N, V), it)
        time_norm_xent(torch, flush, res, "softmax_xent_bwd",
                       lambda: xk.softmax_xent_bwd(*bwd),
                       lambda: xk.softmax_xent_bwd_reference(*bwd),
                       lambda: torch.autograd.grad(out, xg, dloss,
                                                   retain_graph=True),
                       (N, V), it)
        del out, xg
    return res


def phase_norm_xent(torch, lk, xk, flush):
    """#5-#8 against their twins at every listed shape; times at the
    training shapes (LayerNorm [8192, 1024] and [4096, 2048] bf16, xent
    [8192, 50304] bf16). Returns the first training shape's measurements
    with the largest error of every case."""
    main = {}
    worst = {name: 0.0 for name, _ in NORM_KERNELS + XENT_KERNELS}
    for kind, rows, cols, dtype, timed in NORM_XENT_CASES:
        hold_fn, mod = (hold_norm, lk) if kind == "ln" else (hold_xent, xk)
        res = hold_fn(torch, mod, flush, rows, cols, getattr(torch, dtype),
                      timed)
        for name, m in res.items():
            worst[name] = max(worst[name], m["max_abs_err"])
            if timed and name not in main:
                main[name] = m
        torch.cuda.empty_cache()
    for name in worst:
        main[name]["max_abs_err"] = worst[name]
    return main


# the chunked loss against its twin at phase 7c's shapes: GPT-1.3B's
# hidden [4 x 1024, 2048] and tied head [50304, 2048] in bf16, chunk 2048;
# the loss by #7's bound (STAT_TOL * max(1, |twin|)), dh and dw by the
# bf16 flash bound (largest |diff| over largest |twin| <= 1e-2): bf16
# products of dlogits that #8 gives within one bf16 ulp of its twin
CHUNKED = dict(N=4096, H=2048, V=50304, chunk=2048)
CHUNKED_REL = 1e-2


@contextlib.contextmanager
def xent_twins(cx, xk):
    """ops/chunked_xent.py with kernels #7-#8 swapped for their plain
    twins (on CUDA tensors too), restored on the way out."""
    kept = cx.softmax_xent_fwd, cx.softmax_xent_bwd
    cx.softmax_xent_fwd = xk.softmax_xent_fwd_reference
    cx.softmax_xent_bwd = xk.softmax_xent_bwd_reference
    try:
        yield
    finally:
        cx.softmax_xent_fwd, cx.softmax_xent_bwd = kept


def phase_chunked_xent(torch, xk, flush):
    """`chunked_softmax_xent` on kernels #7-#8 against the same function
    on their twins: loss, dh and dw at CHUNKED's shapes (1 in 37 labels
    -100), #7 and #8 launched once a chunk and #7 not again in the
    backward; the forward + backward's time on the kernels, on the twins
    and of the unchunked loss (F.cross_entropy over h @ w^T, the library
    call for the same function)."""
    from paddle_tpu_torch.ops import chunked_xent as cx
    N, H, V, c = (CHUNKED[k] for k in ("N", "H", "V", "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    h = torch.randn(N, H, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, generator=gen, device="cuda")).to(
        torch.bfloat16)
    y = torch.randint(0, V, (N,), generator=gen, device="cuda")
    y[::37] = -100

    def chunked():
        hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
        loss = cx.chunked_softmax_xent(hg, wg, y, chunk=c)
        loss.backward()
        return loss.detach(), hg.grad, wg.grad

    def unchunked():
        hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
        torch.nn.functional.cross_entropy(hg @ wg.T, y,
                                          ignore_index=-100).backward()

    before = (xk.softmax_xent_fwd.launches, xk.softmax_xent_bwd.launches)
    got = chunked()
    torch.cuda.synchronize()
    launched = (xk.softmax_xent_fwd.launches - before[0],
                xk.softmax_xent_bwd.launches - before[1])
    check(launched == (N // c, N // c),
          f"chunked loss: launches (#7, #8) {launched}, want {N // c} each")
    with xent_twins(cx, xk):
        want = chunked()
        twin_ms = cuda_ms(torch, chunked, 3, flush)
    ms = cuda_ms(torch, chunked, 10, flush)
    library_ms = cuda_ms(torch, unchunked, 10, flush)
    err = within(got[0], want[0], STAT_TOL)
    check(err is not None, f"chunked loss: {float(got[0])} vs the twin's "
                           f"{float(want[0])} beyond {STAT_TOL}")
    rels = {}
    for key, a, b in (("dh", got[1], want[1]), ("dw", got[2], want[2])):
        check(a.dtype == torch.bfloat16, f"chunked loss: {key} is {a.dtype}")
        rels[key] = ((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
        check(rels[key] <= CHUNKED_REL,
              f"chunked loss: {key} {rels[key]} of its largest from the twin")
    print(f"  chunked loss [{N}, {H}] x [{V}, {H}] bf16, chunk {c}: loss "
          f"{float(got[0]):.6f} (twin {float(want[0]):.6f}, err {err:.3g}); "
          f"dh {rels['dh']:.3g}, dw {rels['dw']:.3g} of their largest "
          f"(dh {bf16_ulps(torch, got[1], want[1])}, dw "
          f"{bf16_ulps(torch, got[2], want[2])} bf16 ulps at most); #7, #8 "
          f"launches {launched}; forward + backward {ms:.3f} ms on the "
          f"kernels, {twin_ms:.3f} ms on the twins, {library_ms:.3f} ms "
          f"unchunked (F.cross_entropy over h @ w^T)", flush=True)


# -- the SSM family: selective scan (#11) and Mamba-130M-shaped serving ------

SCAN_KERNEL = ("ssm_scan", "paddle_tpu/ops/pallas/ssm_scan.py:62")
# Mamba-130M's published shape (state-spaces/mamba-130m: d_model 768,
# n_layer 24, d_state 16, d_conv 4, expand 2) in the repo's SSMConfig
MAMBA_130M = dict(vocab_size=50304, hidden_size=768, num_layers=24,
                  d_state=16, d_conv=4, expand=2)
SSM_PARAMS = 129_191_424
SSM_SERVE = dict(n_pages=65, page_size=16, max_batch=8, max_new_tokens=64,
                 prefill_chunk=128)
# the reference's kernel-against-oracle tolerance (tests/test_ssm_models.py)
SCAN_RTOL = SCAN_ATOL = 1e-5
# phase 14: weights whose greedy streams vary, and the card-vs-CPU bound
# on the pools after the run, relative to each pool's largest entry
SSM_AGREE_STD = 0.5
SSM_STATE_RTOL = 1e-3
SCAN_OPS = 7      # float32 operations per state element per token


def scan_bound(T, D, N, R):
    """(ms, "bytes"|"operations"): x, dt, y [T, D], B, C [T, N], A
    [D, N], h0 and h_out [R, D, N] and token_seq moved once each;
    SCAN_OPS per state element per token at the float32 peak."""
    n_bytes = 4 * (3 * T * D + 2 * T * N + D * N + 2 * R * D * N + T)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = SCAN_OPS * T * D * N / PEAK_FLOPS["torch.float32"]
    return float(max(t_bytes, t_ops) * 1e3), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hold_scan(torch, sk, flush, args, label, pad_rows=()):
    """Kernel #11 against its twin on args (x, dt, b, c, a, h0,
    token_seq): y and h_out within SCAN_RTOL/SCAN_ATOL, the absolute
    floor scaled down to the tensor's size where its largest entry is
    below 1 (served steps at the reference's init carry |y| ~ 1e-6,
    below a fixed 1e-5), the rows in pad_rows (only pads, or nothing,
    touch them) bit-equal to h0; times of both, the byte bound and the
    longest row's tokens. Returns the measurements."""
    y, h = sk.ssm_scan(*args)
    torch.cuda.synchronize()
    want_y, want_h = sk.selective_scan_reference(*args)
    errs, peaks = [], []
    for key, got, want in (("y", y, want_y), ("h_out", h, want_h)):
        diff = (got - want).abs()
        peak = want.abs().max().item()
        over = diff > SCAN_ATOL * min(1.0, peak) + SCAN_RTOL * want.abs()
        check(not bool(over.any()), f"{label}: {key} beyond rtol "
              f"{SCAN_RTOL} / atol {SCAN_ATOL} x min(1, max|{key}| = "
              f"{peak:.3g}) at {int(over.sum())} elements")
        errs.append(diff.max().item())
        peaks.append(peak)
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
          f"{label}: non-finite")
    for r in pad_rows:
        check(torch.equal(h[r], args[5][r]), f"{label}: row {r}, touched "
                                             f"only by pads, changed")
    x, _, b, _, _, h0, seq = args
    (T, D), N, R = x.shape, b.shape[1], h0.shape[0]
    ms = cuda_ms(torch, lambda: sk.ssm_scan(*args), 20, flush)
    plain_ms = cuda_ms(torch, lambda: sk.selective_scan_reference(*args), 3,
                       flush)
    bound_ms, bound_by = scan_bound(T, D, N, R)
    longest = int(torch.bincount(seq.long().clamp_min(-1) + 1).max())
    live = int((args[1] != 0).any(dim=1).sum())
    res = dict(label=label, tokens=T, live=live, rows=R,
               max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               longest=longest)
    print(f"  {label:30s} T={T:4d} live={live:4d} R={R} err y {errs[0]:.3g} "
          f"(max|y| {peaks[0]:.3g}) h {errs[1]:.3g} (max|h| {peaks[1]:.3g}) "
          f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
          f"library=none bound={bound_ms:.5f}ms ({bound_by}) "
          f"bound/kernel={bound_ms / ms:.4f} longest row={longest} "
          f"tokens", flush=True)
    return res


def scan_inputs(torch, rows, pads, R, rng, D=1536, N=16):
    """Kernel inputs at serving widths: token t on row rows[t]; tokens in
    `pads` carry dt = 0. dt = softplus(N(-2, 1)), A = -(1..N) (the
    A_log init), h0 ~ N(0, 1)."""
    T = len(rows)
    dt = np.log1p(np.exp(rng.standard_normal((T, D)) - 2.0))
    dt[list(pads)] = 0.0
    arrays = (rng.standard_normal((T, D)), dt, rng.standard_normal((T, N)),
              rng.standard_normal((T, N)),
              -np.tile(np.arange(1, N + 1), (D, 1)),
              rng.standard_normal((R, D, N)))
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda()
            for a in arrays] + [torch.tensor(rows, dtype=torch.int32,
                                             device="cuda")]


def phase_scan(torch, sk, flush):
    """#11 against its twin at serving shapes (D 1536, N 16, f32) and at
    the full causal forward of 4 rows x 1024 tokens."""
    rng = np.random.default_rng(SEED + 11)
    chunk = [0] * 128 + list(range(1, 8))
    cases = [
        ("decode, 8 rows", list(range(8)), (), 8, ()),
        ("chunk 128 + 7 decode rows", chunk + [0] * 121,
         range(135, 256), 8, ()),
        ("3 decode rows + 5 pads", [1, 2, 3] + [0] * 5, range(3, 8), 8,
         (0, 4, 5, 6, 7)),
        ("interleaved rows + 16 pads", [1, 1, 2, 1, 2, 2, 1, 2] * 2
         + [0] * 16, range(16, 32), 3, (0,)),
        ("full forward, 4 x 1024", [r for r in range(4) for _ in
                                    range(1024)], (), 4, ()),
    ]
    out = []
    for label, rows, pads, R, pad_rows in cases:
        args = scan_inputs(torch, rows, pads, R, rng)
        out.append(hold_scan(torch, sk, flush, args, label, pad_rows))
    return out


def ssm_numpy_state(model, seed):
    """The reference's SSM init, drawn with numpy: Normal(0,
    initializer_range) weights, embeddings and convolution taps,
    A_log = log(1..N) per channel, D = 1, zero biases, LayerNorm weight
    1 and bias 0."""
    rng = np.random.default_rng(seed)
    std = np.float32(model.cfg.initializer_range)
    state = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        owner, leaf = name.split(".")[-2:]
        if owner.startswith("ln_"):
            state[name] = (np.ones if leaf == "weight" else np.zeros)(
                shape, np.float32)
        elif leaf == "A_log":
            state[name] = np.log(np.tile(np.arange(
                1, shape[1] + 1, dtype=np.float32), (shape[0], 1)))
        elif leaf == "D":
            state[name] = np.ones(shape, np.float32)
        elif leaf.endswith("bias"):
            state[name] = np.zeros(shape, np.float32)
        else:
            state[name] = rng.standard_normal(shape, dtype=np.float32) * std
    return state


def phase_ssm_serve(torch, sk, flush, km, smods):
    """Mamba-130M-shaped SSM serving in bf16 through replayed CUDA graphs
    (wave B the main path of this slice, `serve_graphs`); then a replayed
    mixed and decode step against their eager bodies, whose layer-0 scan
    inputs the kernel is held against its twin on. Returns (launches,
    the held measurements)."""
    GenerationEngine, SSMConfig, SSMForCausalLM, load_state, ssm_mod = smods
    cfg = SSMConfig(**MAMBA_130M)
    check(cfg.d_inner == 1536 and cfg.dt_rank == 48
          and cfg.max_position_embeddings == 1024 and cfg.attn_every == 0,
          "SSMConfig does not give Mamba-130M's shape")
    model = SSMForCausalLM(cfg, dtype=torch.bfloat16)
    t = time.perf_counter()
    state = ssm_numpy_state(model, SEED)
    load_state(model, state)
    torch.cuda.synchronize()
    n_params = sum(a.size for a in state.values())
    check(n_params == SSM_PARAMS, f"{n_params} parameters, want "
                                  f"{SSM_PARAMS}")
    print(f"  weights drawn and loaded in {time.perf_counter() - t:.1f}s "
          f"({n_params} parameters)")
    prompts = make_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()

    eng, launches = serve_graphs(torch, km, GenerationEngine, model,
                                 prompts, SSM_SERVE, "ssm_scan", "ssm_",
                                 "scan kernel")
    try:
        n = launches.pop("ssm_scan")
        check(not any(launches.values()),
              f"other kernels ran while serving the SSM: {launches}")
        check(eng.cache_strategy == "recurrent",
              f"strategy {eng.cache_strategy}")
        # the inert prefix cache: every prompt token and every fed-back
        # token went through a step: waves A-C, wave D twice (prompts of
        # the same lengths) and its seeded request alone twice
        per_wave = sum(p.size for p in prompts) \
            + len(prompts) * (NEW_TOKENS - 1)
        stepped = 5 * per_wave + 2 * (prompts[1].size + NEW_TOKENS - 1)
        check(eng._attn_useful == stepped, f"steps took {eng._attn_useful} "
                                           f"real tokens, want {stepped}: "
                                           f"the prefix cache served some")
        check(eng.cache.match_prefix(prompts[1]) == (0, 0),
              "prefix cache hit")
        stats = eng.cache.pool_stats()
        print(f"  prefix-cache tokens 0 ({stepped} real tokens stepped in "
              f"five waves and two lone requests), pad share of the scan's updates "
              f"{eng.pad_token_fraction():.3f}; state bytes a sequence "
              f"{stats['state_bytes']} ({stats['n_slots']} slots: "
              f"{stats['state_bytes_total']} bytes)")

        best, real = {}, ssm_mod.ssm_scan

        def record(kind):
            """Around the eager body of the `kind` step: keep layer 0's
            scan inputs (its first call) and the rows only pads touch."""
            @contextlib.contextmanager
            def around(shadow):
                def call(*args):
                    if kind not in best:
                        seq, dt = args[6], args[1]
                        live = (dt != 0).any(dim=1)
                        pad_rows = tuple(sorted(
                            set(range(args[5].shape[0]))
                            - set(seq[live].tolist())))
                        best[kind] = ([a.clone() for a in args], pad_rows)
                    return real(*args)
                ssm_mod.ssm_scan = call
                try:
                    yield
                finally:
                    ssm_mod.ssm_scan = real
            return around

        hold_replays(torch, model, eng.cache, lambda sids: 1, record)
    finally:
        eng.shutdown()
    held = {kind: hold_scan(torch, sk, flush, best[kind][0],
                            f"served {kind} step, layer 0", best[kind][1])
            for kind in ("decode", "mixed")}
    del model
    torch.cuda.empty_cache()
    return n, held


SSM_AGREE_KINDS = (("pure", {}), ("hybrid", dict(attn_every=2,
                                                   num_heads=12)))


def ssm_agree_cfg(SSMConfig, extra):
    return SSMConfig(**dict(MAMBA_130M, num_layers=2,
                            initializer_range=SSM_AGREE_STD, **extra))


def ssm_serve_half(torch, km, smods, prompts, cfg, device):
    """One device's half of phase 14 for `cfg`: the model from
    ssm_numpy_state, the sampled wave (seeds 300-307), then the greedy
    wave with its launches held ((replays + captures) x layers of each
    kind on the card, 0 on the CPU). Returns (model, greedy streams,
    the slots' pools after the run, sampled streams)."""
    GenerationEngine, _, SSMForCausalLM, load_state, _ = smods
    pa, sk = km[1], km[5]
    model = SSMForCausalLM(cfg, device=device)
    load_state(model, ssm_numpy_state(model, SEED))
    samp = wave_sampling(len(prompts), range(len(prompts)), seed=300)
    sampled = serve(GenerationEngine, model, prompts, SSM_SERVE, samp)[2]
    before = (sk.ssm_scan.launches, pa.ragged_paged_attention.launches)
    eng, _, streams, _, _ = serve(GenerationEngine, model, prompts,
                                  SSM_SERVE)
    on_card = device == "cuda"
    n_attn = sum(cfg.is_attn_layer(i) for i in range(2))
    runs_ = (eng.steps + eng.retraces) * on_card
    want = (runs_ * (2 - n_attn), runs_ * n_attn)
    got = (sk.ssm_scan.launches - before[0],
           pa.ragged_paged_attention.launches - before[1])
    check(got == want, f"ssm {device}: (scan, paged) launches {got}, want "
                       f"{want}")
    rec = getattr(eng.cache, "recurrent", eng.cache)
    return (model, streams, [t[1:].cpu() for t in rec.conv + rec.ssm],
            sampled)


def ssm_agreement_cpu_half(torch, km, smods, prompts):
    """Phase 14's CPU halves (twins; run beside the build), pure and
    hybrid: {kind: ssm_serve_half on the CPU}."""
    SSMConfig = smods[1]
    return {kind: ssm_serve_half(torch, km, smods, prompts,
                                 ssm_agree_cfg(SSMConfig, extra), "cpu")
            for kind, extra in SSM_AGREE_KINDS}


def phase_ssm_agreement(torch, km, smods, prompts, cpu_halves):
    """2-layer float32 pure and hybrid (attn_every=2, 12 heads: head_dim
    64, so #1 and #11 both run) SSMs at Mamba-130M's width, served on the
    card (kernels) against `cpu_halves` (the CPU's twins, run beside the
    build on the same weights and prompts): greedy streams equal, or the
    CPU's top-2 gap at the first mismatch within GAP_LIMIT; with every
    stream equal, the real slots' conv tails and states after the run
    within SSM_STATE_RTOL of their largest entry. The weights are drawn
    with std SSM_AGREE_STD: at the reference's 0.02 a greedy stream
    repeats its last prompt token whatever the mixers add, so equal
    streams would not show that the card's steps are right."""
    SSMConfig = smods[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, extra in SSM_AGREE_KINDS:
        cfg = ssm_agree_cfg(SSMConfig, extra)
        samp = wave_sampling(len(prompts), range(len(prompts)), seed=300)
        card = ssm_serve_half(torch, km, smods, prompts, cfg, "cuda")
        runs = {"cuda": card[:3], "cpu": cpu_halves[kind][:3]}
        sampled = {"cuda": card[3], "cpu": cpu_halves[kind][3]}
        cpu_model, cpu, cpu_pools = runs["cpu"]
        gpu, gpu_pools = runs["cuda"][1], runs["cuda"][2]
        equal = first_mismatches(torch, cpu_model, prompts, sampled["cuda"],
                                 sampled["cpu"], samp,
                                 f"{kind}: sampled (seeds 300-307)",
                                 gap_rule(GAP_LIMIT))
        print(f"  {kind}: 2-layer float32 sampled streams ({SAMPLED}) equal "
              f"on card and CPU: {equal}/{len(gpu)} requests")
        distinct = [len(set(s)) for s in cpu]
        print(f"  {kind}: distinct tokens in each CPU stream {distinct}")
        check(min(distinct) > 1, f"{kind}: a stream repeats one token, so "
                                 f"it does not depend on the mixers")
        equal = 0
        for r, (a, b) in enumerate(zip(gpu, cpu)):
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                equal += 1
                continue
            ctx = np.concatenate([prompts[r], np.asarray(b[:i])])
            gap = top2_gap(torch, cpu_model, ctx)
            print(f"  {kind}: request {r}: first mismatch at generated token "
                  f"{i} (cuda {a[i]}, cpu {b[i]}), cpu top-2 logit gap "
                  f"{gap:.3g}")
            check(gap <= GAP_LIMIT, f"{kind}: request {r} diverges at token "
                                    f"{i} with a top-2 gap {gap} > "
                                    f"{GAP_LIMIT}")
        print(f"  {kind}: 2-layer float32 greedy streams equal on card and "
              f"CPU: {equal}/{len(gpu)} requests")
        if equal < len(gpu):
            print(f"  {kind}: pools not compared: a stream took another "
                  f"token within the gap")
            continue
        worst = 0.0
        for got, want in zip(gpu_pools, cpu_pools):
            peak = want.abs().max().item()
            check(peak > 0, f"{kind}: a pool was never written")
            worst = max(worst, (got - want).abs().max().item() / peak)
        print(f"  {kind}: conv tails and states of slots 1-"
              f"{cpu_pools[0].shape[0]}, card vs CPU: max |diff| / max|cpu| "
              f"{worst:.3g}")
        check(worst <= SSM_STATE_RTOL, f"{kind}: pools differ by {worst:.3g} "
                                       f"of their size > {SSM_STATE_RTOL}")


# -- Paddle's dygraph surface: Tensor, Layer, the eager loop, save/load ------

# phase 15 (a): the eager loop's steps (the first untimed) and its lr and
# clip, examples/train_gpt.py's
EAGER = dict(warmup=1, timed=4, lr=3e-4, clip=1.0)
# phase 15 (b): examples/train_gpt.py's TrainStep program, its steps
EXAMPLE = dict(warmup=2, timed=6)
# phase 15 (d): the user-defined Layer at head_dim 64, float32
USER_D, USER_HEADS, USER_STEPS = 128, 2, 3


def user_net(paddle, d=USER_D, heads=USER_HEADS):
    """tests/test_torch_dygraph.py's user-defined Layer: two Linears, a
    LayerNorm, a create_parameter with a ParamAttr initializer,
    transpose(perm) and F.scaled_dot_product_attention."""
    nn, F = paddle.nn, paddle.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.heads = heads
            self.norm = nn.LayerNorm(d)
            self.qkv = nn.Linear(d, 3 * d, bias_attr=False)
            self.out = nn.Linear(d, d)
            self.gain = self.create_parameter(
                [d], attr=paddle.ParamAttr(
                    initializer=nn.initializer.Constant(0.5)))

        def forward(self, x):
            B, T, D = x.shape
            qkv = self.qkv(self.norm(x)).reshape(
                [B, T, 3, self.heads, D // self.heads])
            qkv = qkv.transpose([2, 0, 1, 3, 4])
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                               is_causal=True)
            return self.out(o.reshape([B, T, D])) * self.gain + x
    return Net()


def eager_adamw(paddle, model, lr, clip):
    return paddle.optimizer.AdamW(
        lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(clip))


def phase_dygraph(torch, km, state, train_main):
    """Paddle's dygraph surface on the card (`import paddle_tpu_torch as
    paddle`): (a) GPT-medium bf16 as a Layer, loaded with the phase-4
    weights by set_state_dict, trained by the eager loop on phase 7's
    batch from paddle.to_tensor; (b) the same Layer model through
    examples/train_gpt.py's TrainStep program; (c) paddle.save /
    paddle.load / set_state_dict into a fresh model; (d) the user
    Layer, card against CPU; (e) the surface's host cost."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_medium
    F = paddle.nn.functional
    paddle.set_device("gpu")
    paddle.seed(0)
    cfg = gpt_medium()
    L, V = cfg.num_layers, cfg.vocab_size
    B, T = TRAIN["batch"], TRAIN["seq"]
    ids_np = np.random.RandomState(0).randint(0, V, size=(B, T)).astype(
        np.int32)
    flash = [n for n, _ in FLASH_KERNELS]

    def new_model():
        model = GPTForCausalLM(cfg)
        model.bfloat16()
        missing, unexpected = model.set_state_dict(state)
        check(not missing and not unexpected,
              f"set_state_dict: missing {missing}, unexpected {unexpected}")
        check(isinstance(model, paddle.nn.Layer)
              and all(isinstance(p, paddle.Tensor)
                      for p in model.parameters()),
              "GPT is not a Layer of Paddle Parameters")
        return model

    # (a) the eager loop
    model = new_model().train()
    opt = eager_adamw(paddle, model, EAGER["lr"], EAGER["clip"])
    ids = paddle.to_tensor(ids_np)
    check(ids.value.is_cuda, "paddle.to_tensor did not place on CUDA")
    losses = []

    def eager_step():
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, V]), ids.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.value.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(km)
    for _ in range(EAGER["warmup"]):
        eager_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(EAGER["timed"]):
        eager_step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / EAGER["timed"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eager_step()
        torch.cuda.synchronize()
    launches = counts(km)
    n = EAGER["warmup"] + EAGER["timed"] + 1
    vals = torch.stack(losses).float().tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  (a) eager loop: {n} steps, loss {vals[0]:.4f} -> "
          f"{vals[-1]:.4f}; {step_s * 1e3:.1f} ms/step wall over "
          f"{EAGER['timed']} steps; peak memory {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(np.isfinite(vals).all(), f"(a) non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"(a) loss did not fall: {vals}")
    for k in flash:
        check(launches[k] == n * L,
              f"(a) {k}: {launches[k]} launches, want {n} x {L}")
    rel = abs(vals[0] - train_main["first"]) / abs(train_main["first"])
    print(f"  (a) step-1 loss {vals[0]:.6f}, phase 7's default TrainStep "
          f"{train_main['first']:.6f}: relative difference {rel:.3g} "
          f"(limit 1e-3)")
    check(rel <= 1e-3, f"(a) step-1 loss differs from phase 7's by {rel}")
    eager = dict(ms=step_s * 1e3, peak_gib=peak)
    eager["device_ms"], eager["idle"], _, _ = train_time_goes(prof, step_s)
    opt.clear_grad()
    del opt, prof
    torch.cuda.empty_cache()

    # (c) save / load / set_state_dict into a fresh model, bit for bit
    model.eval()
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "dygraph", "gpt_medium.pdparams")
    t = time.perf_counter()
    paddle.save(model.state_dict(), ckpt)
    loaded = paddle.load(ckpt)
    io_s = time.perf_counter() - t
    os.remove(ckpt)
    fresh = GPTForCausalLM(cfg)
    fresh.bfloat16()
    fresh.eval()
    missing, unexpected = fresh.set_state_dict(loaded)
    del loaded
    check(not missing and not unexpected,
          f"(c) missing {missing}, unexpected {unexpected}")
    for (k, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"(c) {k} differs after save / load")
    probe = paddle.to_tensor(ids_np[:1, :256])
    with paddle.no_grad():
        la, lb = model(probe), fresh(probe)
    check(torch.equal(la.value, lb.value), "(c) logits differ after load")
    print(f"  (c) save + load of {len(model.state_dict())} tensors in "
          f"{io_s:.1f}s: every parameter and the logits bit-equal")
    del fresh, model, la, lb
    torch.cuda.empty_cache()

    # (b) examples/train_gpt.py's program on the same Layer model
    model = new_model()

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]))
    step = TrainStep(model, loss_fn, eager_adamw(paddle, model, EAGER["lr"],
                                                 EAGER["clip"]))
    check(step._fused is not None, "(b) TrainStep took the tree epilogue")
    groups = n_groups(step)
    zero_counts(km)
    out = [step(ids, ids) for _ in range(EXAMPLE["warmup"])]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out += [step(ids, ids) for _ in range(EXAMPLE["timed"])]
    torch.cuda.synchronize()
    ex_s = (time.perf_counter() - t) / EXAMPLE["timed"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out.append(step(ids, ids))
        torch.cuda.synchronize()
    launches = counts(km)
    n = EXAMPLE["warmup"] + EXAMPLE["timed"] + 1
    vals = [float(v) for v in out]
    check(all(isinstance(v, paddle.Tensor) for v in out),
          "(b) TrainStep called with Tensors did not hand back Tensors")
    check(np.isfinite(vals).all(), f"(b) non-finite loss: {vals}")
    for k, _ in FUSED_KERNELS:
        check(launches[k] == n * groups,
              f"(b) {k}: {launches[k]} launches, want {n} x {groups}")
    for k in flash:
        check(launches[k] == n * L,
              f"(b) {k}: {launches[k]} launches, want {n} x {L}")
    ex = dict(ms=ex_s * 1e3)
    print(f"  (b) TrainStep (examples/train_gpt.py's AdamW 3e-4 + "
          f"ClipGradByGlobalNorm(1.0), bf16 without f32 masters, health "
          f"off): {n} steps, loss {vals[0]:.4f} -> {vals[-1]:.4f}; "
          f"{ex['ms']:.1f} ms/step wall, retraces {step.retraces}, "
          f"{groups} bucket group(s); #9/#10 launches "
          f"{launches['fused_pass1']}/{launches['fused_pass2']}")
    ex["device_ms"], ex["idle"], _, _ = train_time_goes(prof, ex_s)
    print(f"  (b) beside phase 7's default run on the same weights and "
          f"batch (AdamW 1e-4 with f32 masters, health on, no clip): "
          f"{train_main['ms']:.1f} ms/step wall, "
          f"{train_main['device_ms']} device ms")
    del step, model, prof, out
    torch.cuda.empty_cache()

    # (d) the user Layer at head_dim 64: card against CPU, float32
    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal((2, 64, USER_D), dtype=np.float32)
    y_np = rng.standard_normal((2, 64, USER_D), dtype=np.float32)
    weights = None
    user = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            net = user_net(paddle)
            if weights is None:
                weights = {k: (np.ones if k.endswith("norm.weight") else
                               lambda s: rng.standard_normal(
                                   s, dtype=np.float32) * 0.05)(
                                       tuple(v.shape))
                           for k, v in net.state_dict().items()}
            net.set_state_dict(weights)
            opt = eager_adamw(paddle, net, 1e-3, 1.0)
            zero_counts(km)
            ls = []
            for _ in range(USER_STEPS):
                loss = ((net(paddle.to_tensor(x_np))
                         - paddle.to_tensor(y_np)) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                ls.append(float(loss))
            user[dev] = (ls, counts(km))
    finally:
        paddle.set_device("gpu")
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card_l, card_n), (cpu_l, _) = user["gpu"], user["cpu"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    print(f"  (d) user Layer (d {USER_D}, {USER_HEADS} heads, float32, "
          f"TF32 off), {USER_STEPS} eager steps: card {card_l}, CPU "
          f"{cpu_l}; worst relative difference {worst:.3g} (limit 1e-3); "
          f"card launches { {k: card_n[k] for k in flash} }")
    check(worst <= 1e-3, f"(d) card and CPU losses differ by {worst}")
    for k in flash:
        check(card_n[k] == USER_STEPS, f"(d) {k}: {card_n[k]} launches on "
                                       f"the card, want {USER_STEPS}")

    # (e) the host cost of the surface
    xt = torch.randn(8, 1024, device="cuda", dtype=torch.bfloat16)
    yt = torch.randn(8, 1024, device="cuda", dtype=torch.bfloat16)
    x, y = paddle.to_tensor(xt), paddle.to_tensor(yt)
    lin = paddle.nn.Linear(1024, 1024)
    lin.bfloat16()

    class Wrap(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = lin

        def forward(self, v):
            return self.fc(v)
    wrap = Wrap()
    host = {
        "torch.add (torch tensors)": host_us(torch, lambda: torch.add(xt,
                                                                      yt)),
        "paddle.add (Tensors)": host_us(torch, lambda: paddle.add(x, y)),
        "x + y (Tensors)": host_us(torch, lambda: x + y),
        "Linear.forward (torch tensor)": host_us(torch,
                                                 lambda: lin.forward(xt)),
        "Linear(torch tensor)": host_us(torch, lambda: lin(xt)),
        "Linear(Tensor)": host_us(torch, lambda: lin(x)),
        "user Layer(Tensor) -> Linear": host_us(torch, lambda: wrap(x)),
    }
    print("  (e) host us a call, [8, 1024] bf16: " + "; ".join(
        f"{k} {v:.2f}" for k, v in host.items()))
    return dict(eager=eager, example=ex, host=host, user_worst=worst)


# -- phase 16: examples/bench_bert.py's ERNIE-base MLM step, the AMP eager
# loop, card against CPU, the float16 flash kernels -------------------------

# bench_bert.py's step (bench_bert.py:24-71): batch 32 x 128, AdamW 1e-4
# with f32 masters, 3 warm-up and 30 timed steps (then one profiled)
BERT = dict(batch=32, seq=128, lr=1e-4, warmup=3, timed=30)
# (b) the AMP eager loop: 1 warm-up, 4 timed, 1 profiled step a mode
AMP_STEPS = dict(warmup=1, timed=4)
AMP_MODES = (("O1 bfloat16", "O1", "bfloat16", False),
             ("O2 bfloat16 (decorate)", "O2", "bfloat16", False),
             ("O1 float16, dynamic GradScaler", "O1", "float16", True))
# (c) card against CPU: 2 of ERNIE-base's layers at full width, batch
# 4 x 128, 3 TrainSteps in float32 (TF32 off) and one O1-bf16 eager step
BERT_AGREE = dict(layers=2, batch=4, seq=128, steps=3, rtol=1e-3,
                  amp_rtol=2e-2)
BERT_PARAMS = 117_395_776  # ernie_base(): vocab 40000, 512 positions, tied
# (d) parks the card ~5 ms before each timed call: after phase 15 the
# host may take longer than the default ~1 ms to enqueue one
FLASH_F16_SPIN = 10_000_000


def bert_numpy_state(model, seed):
    """{name: numpy array} for every parameter of a BERT model, by the
    reference's init: Normal(0, 0.02) embeddings, XavierNormal Linear
    weights ([in, out]), zero biases (decoder_bias too), unit LayerNorm
    weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in model.named_parameters():
        shape = tuple(p.shape)
        if k.endswith("bias"):
            out[k] = np.zeros(shape, np.float32)
        elif "norm" in k:
            out[k] = np.ones(shape, np.float32)
        elif "embeddings" in k:
            out[k] = rng.standard_normal(shape, dtype=np.float32) * 0.02
        else:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            out[k] = rng.standard_normal(shape, dtype=np.float32) * std
    return out


def bench_bert_batch(vocab, B, T):
    """bench_bert.py's ids and MLM labels (bench_bert.py:53-59): ids from
    RandomState(0), 15 % of the positions labelled, the rest -100."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    lab = ids.copy()
    lab[rng.rand(B, T) > 0.15] = -100
    return ids, lab.astype(np.int32)


def bert_loss_fn(F):
    """bench_bert.py's loss_fn (bench_bert.py:46-52)."""
    def loss_fn(logits, labels):
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]),
                               ignore_index=-100)
    return loss_fn


def flash_kernel_names(prof):
    """Names of the flash kernels the profiler saw run on the card."""
    return {name for name, _, _ in device_events(prof) if "flash_" in name}


def phase_bert(torch, km, fa, flush):
    """examples/bench_bert.py's ERNIE-base MLM step on the card: (a) the
    TrainStep at full width in bf16; (b) the AMP eager loop in three
    modes on the float32 model; (c) card against CPU; (d) the float16
    flash kernels against their twins. Returns {"bench", "amp",
    "flash_f16"}."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertForMaskedLM, ernie_base,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.profiler import cost
    F = paddle.nn.functional
    paddle.set_device("gpu")
    cfg = ernie_base()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    L, V = cfg.num_layers, cfg.vocab_size
    B, T = BERT["batch"], BERT["seq"]
    flash = [n for n, _ in FLASH_KERNELS]
    t0 = time.perf_counter()
    model = BertForMaskedLM(cfg)
    state = bert_numpy_state(model, SEED + 16)
    n_params = sum(a.size for a in state.values())
    check(n_params == BERT_PARAMS, f"ERNIE-base has {n_params} parameters, "
                                   f"want {BERT_PARAMS}")
    check(len(state) == 12 * 16 + 13, f"{len(state)} state entries")
    ids_np, lab_np = bench_bert_batch(V, B, T)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(lab_np).cuda()

    # (a) bench_bert.py's TrainStep: bf16, AdamW with f32 masters
    load_paddle_tpu_state(model, state)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=BERT["lr"],
                                 parameters=model.parameters(),
                                 multi_precision=True)
    step = TrainStep(model, bert_loss_fn(F), opt)
    check(step._fused is not None, "(a) TrainStep took the tree epilogue")
    groups = n_groups(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with switches(False):
        t = time.perf_counter()
        for _ in range(BERT["warmup"]):
            losses.append(step(ids, labels))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        zero_counts(km)
        t = time.perf_counter()
        for _ in range(BERT["timed"]):
            losses.append(step(ids, labels))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t) / BERT["timed"]
        launches = counts(km)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            losses.append(step(ids, labels))
            torch.cuda.synchronize()
    vals = torch.stack(losses).float().tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    flop = step.flops(ids, labels)
    n = BERT["timed"]
    check(np.isfinite(vals).all(), f"(a) non-finite loss: {vals}")
    check(vals[-1] < vals[0], f"(a) loss did not fall: {vals}")
    # no clip, no GradScaler, health off: the epilogue needs no global
    # norm or non-finite sweep, so pass 1 (#9) does not run, only #10
    want = {k: 0 for k in launches}
    want.update({k: n * L for k in flash})
    want["fused_pass2"] = n * groups
    check(launches == want, f"(a) launches over the {n} timed steps "
                            f"{launches}, want {want}")
    bench = dict(ms=step_s * 1e3, seqs_s=B / step_s, tokens_s=B * T / step_s,
                 mfu=cost.mfu(flop, step_s), peak_gib=peak, flops=flop,
                 first=vals[0], last=vals[-1], groups=groups,
                 launches=launches, retraces=step.retraces)
    print(f"  (a) BertForMaskedLM(ernie_base()) bf16, {n_params} "
          f"parameters, batch {B} x {T}, AdamW {BERT['lr']} with f32 "
          f"masters, fused epilogue ({groups} bucket group(s)), CUDA "
          f"graphs (retraces {step.retraces}, warm-up {warm_s:.1f}s for "
          f"{BERT['warmup']}): {len(vals)} steps, loss {vals[0]:.4f} -> "
          f"{vals[-1]:.4f}")
    print(f"  (a) {bench['ms']:.2f} ms/step over {n} timed steps, "
          f"{bench['seqs_s']:.1f} sequences/s, {bench['tokens_s']:.0f} "
          f"tokens/s, MFU {bench['mfu']:.4f} ({flop:.4g} FLOP/step, "
          f"profiler/cost.py, over {cost.device_peak_flops():.4g} FLOP/s); "
          f"peak memory {peak:.2f} GiB; launches over the timed steps "
          f"{ {k: v for k, v in launches.items() if v} }")
    bench["device_ms"], bench["idle"], bench["other_ms"], \
        bench["parts_ms"] = train_time_goes(prof, step_s)
    del step, opt, prof, model, losses
    torch.cuda.empty_cache()

    # (b) the AMP eager loop on the float32 model, three modes
    amp_res = {}
    steps_b = AMP_STEPS["warmup"] + AMP_STEPS["timed"] + 1
    ids_t, lab_t = paddle.to_tensor(ids_np), paddle.to_tensor(lab_np)
    for label, level, dtype, scaled in AMP_MODES:
        model = BertForMaskedLM(cfg)
        load_paddle_tpu_state(model, state)
        opt = paddle.optimizer.AdamW(learning_rate=BERT["lr"],
                                     parameters=model.parameters())
        if level == "O2":
            model, opt = amp.decorate(models=model, optimizers=opt,
                                      level="O2", dtype=dtype)
        scaler = amp.GradScaler(enable=scaled)
        low = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        probe = model.bert.encoder.layers[0].self_attn.q_proj.weight
        got = []

        def eager_step():
            with amp.auto_cast(level=level, dtype=dtype):
                loss = model.loss(ids_t, lab_t)
            scaler.scale(loss).backward()
            got.append((loss.value.detach(), loss.value.dtype,
                        probe.grad.dtype, model.decoder_bias.grad.dtype))
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(km)
        for _ in range(AMP_STEPS["warmup"]):
            eager_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(AMP_STEPS["timed"]):
            eager_step()
        torch.cuda.synchronize()
        wall_s = (time.perf_counter() - t) / AMP_STEPS["timed"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            eager_step()
            torch.cuda.synchronize()
        launches = counts(km)
        vals = [float(v) for v, *_ in got]
        want_grad = torch.float32 if level == "O1" else low
        names = flash_kernel_names(prof)
        tag = "__half" if dtype == "float16" else "__nv_bfloat16"
        check(np.isfinite(vals).all(), f"(b) {label}: non-finite loss "
                                       f"{vals}")
        check(all(d == torch.float32 for _, d, _, _ in got),
              f"(b) {label}: loss dtypes {[d for _, d, _, _ in got]}")
        check(all(g == b == want_grad for _, _, g, b in got),
              f"(b) {label}: grad dtypes {[(g, b) for *_, g, b in got]}, "
              f"want {want_grad}")
        for k in flash:
            check(launches[k] == steps_b * L,
                  f"(b) {label}: {k}: {launches[k]} launches, want "
                  f"{steps_b} x {L}")
        others = {k: v for k, v in launches.items() if v and k not in flash}
        check(not others, f"(b) {label}: other kernels ran: {others}")
        check(len(names) == 3 and all(tag in nm for nm in names),
              f"(b) {label}: flash kernels on the card {sorted(names)}, "
              f"want the three {tag} variants")
        res = dict(wall_ms=wall_s * 1e3, losses=vals,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches={k: launches[k] for k in flash},
                   scale=scaler.get_loss_scaling())
        print(f"  (b) {label}: {steps_b} steps, loss {vals[0]:.4f} -> "
              f"{vals[-1]:.4f} (float32), grads {want_grad}, "
              f"{res['wall_ms']:.1f} ms/step wall over "
              f"{AMP_STEPS['timed']} steps, peak memory "
              f"{res['peak_gib']:.2f} GiB, loss scale {res['scale']}; "
              f"flash launches {res['launches']}: "
              + ", ".join(sorted(re.search(r"flash_\w+<[^>]*>", nm).group(0)
                                 for nm in names)))
        res["device_ms"], res["idle"], _, _ = train_time_goes(prof, wall_s)
        amp_res[label] = res
        del model, opt, prof, got, probe
        torch.cuda.empty_cache()

    # (c) card against CPU: 2 layers at full width
    small_cfg = copy.copy(cfg)
    small_cfg.num_layers = BERT_AGREE["layers"]
    Bc, Tc = BERT_AGREE["batch"], BERT_AGREE["seq"]
    ids_c, lab_c = bench_bert_batch(V, Bc, Tc)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agree, small = {}, None
    try:
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            model = BertForMaskedLM(small_cfg)
            if small is None:
                small = bert_numpy_state(model, SEED + 17)
            load_paddle_tpu_state(model, small)
            x = torch.from_numpy(ids_c).to(model.decoder_bias.device)
            y = torch.from_numpy(lab_c).to(x.device)
            step = TrainStep(model, bert_loss_fn(F), paddle.optimizer.AdamW(
                learning_rate=BERT["lr"], parameters=model.parameters()))
            with switches(False):
                ts = [float(step(x, y)) for _ in range(BERT_AGREE["steps"])]
            del step
            model = BertForMaskedLM(small_cfg)
            load_paddle_tpu_state(model, small)
            opt = paddle.optimizer.AdamW(learning_rate=BERT["lr"],
                                         parameters=model.parameters())
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model.loss(x, y)
            loss.backward()
            opt.step()
            agree[dev] = (ts, float(loss.detach()))
            del model, opt, loss
    finally:
        paddle.set_device("gpu")
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    (card_ts, card_amp), (cpu_ts, cpu_amp) = agree["gpu"], agree["cpu"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_ts, cpu_ts))
    amp_rel = abs(card_amp - cpu_amp) / abs(cpu_amp)
    print(f"  (c) 2-layer ERNIE at full width, batch {Bc} x {Tc}, float32 "
          f"(TF32 off), {BERT_AGREE['steps']} TrainSteps: card {card_ts}, "
          f"CPU {cpu_ts}, worst relative difference {worst:.3g} (limit "
          f"{BERT_AGREE['rtol']}); one O1-bf16 eager step: card "
          f"{card_amp:.6f}, CPU {cpu_amp:.6f}, relative {amp_rel:.3g} "
          f"(limit {BERT_AGREE['amp_rtol']})")
    check(worst <= BERT_AGREE["rtol"], f"(c) TrainStep losses differ by "
                                       f"{worst}")
    check(amp_rel <= BERT_AGREE["amp_rtol"], f"(c) O1-bf16 eager losses "
                                             f"differ by {amp_rel}")

    # (d) float16 flash kernels against their twins; ERNIE's shape in
    # bf16 too (no other phase runs it)
    rng = np.random.default_rng(SEED + 18)
    H_ERNIE, D_ERNIE = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    cases = [("ERNIE-base shape, full", B, T, T, D_ERNIE, False, H_ERNIE,
              torch.bfloat16),
             ("ERNIE-base shape, full", B, T, T, D_ERNIE, False, H_ERNIE,
              torch.float16),
             ("training shape, causal", TRAIN["batch"], TRAIN["seq"],
              TRAIN["seq"], 64, True, H, torch.float16),
             ("GPT-1.3B training shape, causal", TRAIN_1P3B["batch"],
              TRAIN_1P3B["seq"], TRAIN_1P3B["seq"], 128, True, H,
              torch.float16)]
    f16, worst_f16 = {}, {k: 0.0 for k in flash}
    for label, Bd, tq, tk, d, causal, heads, dtype in cases:
        res = hold_flash(torch, fa, flush, f"{label} [{Bd}, {tq}, {heads}, "
                         f"{d}]", Bd, tq, tk, d, causal, dtype, rng,
                         heads=heads, spin=FLASH_F16_SPIN)
        if dtype == torch.float16:
            f16.setdefault("main", res)
            for k in flash:
                worst_f16[k] = max(worst_f16[k], res[k]["max_abs_err"])
    for k in flash:
        f16["main"][k]["max_abs_err"] = worst_f16[k]
    print(f"  phase 16 took {time.perf_counter() - t0:.1f}s")
    return dict(bench=bench, amp=amp_res, flash_f16=f16["main"],
                f16_launches=amp_res[AMP_MODES[2][0]]["launches"],
                agree=dict(worst=worst, amp_rel=amp_rel))


# -- phase 17: examples/train_vision_hapi.py's ResNet-50 fit (BASELINE.json's
# "ResNet-50 dygraph on CIFAR-10"), ResNet-50 at ImageNet's shape, the eager
# loop, card against CPU, a replay against its eager body -------------------

# (a) the example's workflow at CIFAR-10's shape: 26 batches of 128, a
# validation set of 8, two epochs; BASELINE.json:6 names the model
VISION = dict(train=3328, val=1024, batch=128, epochs=2, lr=0.01,
              momentum=0.9, classes=10, hw=32)
RESNET50_PARAMS = 23_528_522  # resnet50(num_classes=10): 161 leaves
RESNET50_LEAVES = 161
# (b) ImageNet's shape: 2 warm-up (the capture and a replay), 10 timed,
# 1 profiled step, float32 and O1 bfloat16
IMAGENET = dict(batch=64, hw=224, classes=1000, warmup=2, timed=10)
# (c) the dygraph eager loop at (a)'s shape: 1 warm-up, 5 timed
VISION_EAGER = dict(warmup=1, timed=5)
# (d) ResNet-18 at full width, float32 with TF32 off, card against CPU:
# at 8 x 32 x 32 and lr 1e-3 a float32 run stays within 2e-5 (losses) and
# 5e-6 (running statistics, over each buffer's largest value) of a
# float64 one (a CPU run); at lr 1e-2 it does not (batch statistics over
# 8 values a channel in the last stage)
VISION_AGREE = dict(batch=8, hw=32, steps=3, lr=1e-3, rtol=1e-3,
                    bn_rtol=1e-4, eval_images=32, eval_loss_rtol=1e-3)
# a family of device kernels by name: cuDNN's convolutions (and the
# products it runs through CUTLASS / xmma), the epilogue (#10), the rest
CONV_NAMES = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit",
              "xmma", "cutlass", "sm90", "gemm", "nvjet")


class SyntheticImages:
    """examples/train_vision_hapi.py's stand-in for CIFAR-10: `n` images
    3 x hw x hw uniform in [0, 1) and labels from RandomState(seed)."""

    def __init__(self, n, classes=10, hw=32, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.rand(n, 3, hw, hw).astype(np.float32)
        self.y = rng.randint(0, classes, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def vision_numpy_state(model, seed):
    """{name: numpy array} for every parameter and buffer of a vision
    model by the reference's init: Uniform(+-1/sqrt(fan_in)) conv
    weights, XavierNormal Linear weights, zero biases, unit BatchNorm
    weights, running statistics 0 and 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("._variance") or (k.endswith(".weight") and
                                        len(shape) == 1):
            out[k] = np.ones(shape, np.float32)
        elif len(shape) == 4:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            out[k] = rng.uniform(-bound, bound, shape).astype(np.float32)
        elif len(shape) == 2:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            out[k] = (rng.standard_normal(shape) * std).astype(np.float32)
        else:
            out[k] = np.zeros(shape, np.float32)
    return out


def families_time(prof, wall_s, families, rest="other"):
    """(device ms a step, idle share, {family: ms}) of a profiled step:
    `families` maps a label to the name fragments of its kernels, the
    rest is `rest`. Prints the top kernels."""
    by_name = device_us_by_name(prof)
    total = sum(by_name.values()) / 1e3
    if not total:
        print("  device time: not measured (the profiler saw no device "
              "events)")
        return None, None, {}
    parts = {}
    for label, frags in families.items():
        parts[label] = sum(v for n, v in by_name.items()
                           if any(f in n.lower() for f in frags)) / 1e3
    parts[rest] = total - sum(parts.values())
    idle = max(0.0, 1 - total / (wall_s * 1e3))
    print(f"  device kernels {total:.2f}ms a step (profiled), wall "
          f"{wall_s * 1e3:.2f}ms (timed), idle share {idle:.3f}; "
          + ", ".join(f"{k} {v:.2f}ms ({v / total:.3f})"
                      for k, v in parts.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:8.3f}ms  {name[:100]}")
    return total, idle, parts


# phase 17's breakdown: the convolutions (cuDNN and the products), #10,
# the rest
VISION_FAMILIES = {"convolutions and products": CONV_NAMES,
                   "epilogue #10": ("fused_",)}
VISION_REST = ("the rest (BatchNorm's composition, ReLU, adds, pools, "
               "copies)")


def profile_call(torch, fn):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def fit_epochs(torch, model, train, val, epochs):
    """Model.fit(train, val, epochs, verbose=0) with a callback that
    records, for each epoch: wall s and images/s of its training part,
    ms a step over the replayed steps (after the first, which captures),
    the step's captures / compile_s / replays and graph pool, the
    epoch's peak memory and what stays allocated after its evaluation;
    and every step's loss (on the device)."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    rec = dict(epochs=[], losses=[])
    n_batches = len(train)

    class Clock(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            loss = logs["loss"][0]  # a Tensor over the device value
            rec["losses"].append(getattr(loss, "value", loss))
            if step == 0:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
            if step == n_batches - 1:
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                ts = model._train_step
                (prog,) = [p for c in ts._graphs.values()
                           for p in c.values()]
                self.cur = dict(
                    wall_s=t2 - self.t0, images_s=len(train.dataset) / (
                        t2 - self.t0),
                    ms=(t2 - self.t1) / (n_batches - 1) * 1e3,
                    captures=ts.retraces, compile_s=ts.compile_s,
                    replays=prog.replays, graph=prog.graph is not None,
                    pool_bytes=prog.info.get("pool_bytes", 0))

        def on_epoch_end(self, epoch, logs=None):
            self.cur.update(
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                after_eval_gib=torch.cuda.memory_allocated() / 2**30,
                eval_loss=logs["eval_loss"][0], eval_acc=logs["eval_acc"])
            rec["epochs"].append(self.cur)

    model.fit(train, val, epochs=epochs, verbose=0, callbacks=[Clock()])
    return rec


def phase_vision(torch, km):
    """examples/train_vision_hapi.py's ResNet-50 on the card: (a) its
    Model.fit at CIFAR-10's shape in float32; (b) its TrainStep at
    ImageNet's shape, float32 and O1 bfloat16; (c) the dygraph eager
    loop; (d) ResNet-18 card against CPU; (e) a replayed ResNet-18 step
    against its eager body, BatchNorm's buffers included. Returns the
    measurements."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.io import DataLoader, Dataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models import load_paddle_tpu_state
    from paddle_tpu_torch.profiler import cost
    from paddle_tpu_torch.vision.models import resnet18, resnet50
    F = paddle.nn.functional
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    # torch's defaults, what a user's float32 convolution gets (earlier
    # phases turn both off): cuDNN's products in TF32, cuBLAS's not
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    print("  cuDNN TF32 on, matmul TF32 off (torch's defaults: a float32 "
          "convolution runs its products in TF32)")
    Images = type("Images", (SyntheticImages, Dataset), {})

    def momentum(net, lr=VISION["lr"]):
        return paddle.optimizer.Momentum(learning_rate=lr,
                                         momentum=VISION["momentum"],
                                         parameters=net.parameters())

    # (a) Model.prepare / fit / evaluate at CIFAR-10's shape
    paddle.seed(SEED + 20)
    net = resnet50(num_classes=VISION["classes"])
    n_params = sum(p.numel() for p in net.parameters())
    check(n_params == RESNET50_PARAMS and len(net.parameters())
          == RESNET50_LEAVES, f"(a) ResNet-50 has {n_params} parameters in "
          f"{len(net.parameters())} leaves")
    init_bufs = [b.detach().clone() for b in net.buffers()]
    model = paddle.Model(net)
    model.prepare(momentum(net), nn.CrossEntropyLoss(), Accuracy())
    np.random.seed(SEED)
    train = DataLoader(Images(VISION["train"]), batch_size=VISION["batch"],
                       shuffle=True)
    val = DataLoader(Images(VISION["val"], seed=1),
                     batch_size=VISION["batch"])
    zero_counts(km)
    rec = fit_epochs(torch, model, train, val, VISION["epochs"])
    launches = counts(km)
    n_steps = len(rec["losses"])
    vals = torch.stack(rec["losses"]).float().tolist()
    check(n_steps == VISION["epochs"] * len(train), f"(a) {n_steps} steps")
    check(np.isfinite(vals).all(), f"(a) non-finite losses {vals}")
    for i, e in enumerate(rec["epochs"]):
        check(e["graph"] and e["captures"] == 1
              and e["replays"] == len(train) - 1,
              f"(a) epoch {i}: {e['captures']} captures, {e['replays']} "
              f"replays of {len(train)} steps")
        print(f"  (a) epoch {i}: {e['wall_s']:.2f}s wall, "
              f"{e['images_s']:.0f} images/s (its first step captures), "
              f"{e['ms']:.2f} ms a replayed step "
              f"({VISION['batch'] / e['ms'] * 1e3:.0f} images/s); captures "
              f"{e['captures']}, compile_s {e['compile_s']:.2f}, graph pool "
              f"{e['pool_bytes'] / 2**20:.0f} MiB, replays {e['replays']}; "
              f"peak {e['peak_gib']:.2f} GiB, allocated after evaluate "
              f"{e['after_eval_gib']:.2f} GiB; eval loss "
              f"{e['eval_loss']:.4f}, acc {e['eval_acc']:.4f}")
    e1, e2 = rec["epochs"][0], rec["epochs"][-1]
    check(e2["peak_gib"] <= e1["peak_gib"] + e1["pool_bytes"] / 2**30,
          f"(a) epoch 2 peaks at {e2['peak_gib']:.2f} GiB, epoch 1 at "
          f"{e1['peak_gib']:.2f} + a pool of {e1['pool_bytes'] / 2**30:.2f}")
    check(abs(e2["after_eval_gib"] - e1["after_eval_gib"]) < 0.25,
          f"(a) the dropped step's memory stays: after epoch 1 "
          f"{e1['after_eval_gib']:.2f} GiB, after epoch 2 "
          f"{e2['after_eval_gib']:.2f}")
    # Momentum, no clip, scaler or health: pass 1 (#9) has nothing to
    # do; pass 2 (#10) once a group a step (the capture's eager run is
    # that call's step); nothing else of the table
    want = {k: 0 for k in launches}
    bufs = [b for b in net.buffers()]
    check(all(torch.isfinite(b).all() for b in bufs)
          and all(not torch.equal(b, i) for b, i in zip(bufs, init_bufs)),
          "(a) a BatchNorm running statistic is not finite or did not move")
    evaluated = model.evaluate(val, verbose=0)
    print(f"  (a) evaluate on {VISION['val']} images: loss "
          f"{evaluated['loss'][0]:.4f}, acc {evaluated['acc']:.4f}; losses "
          f"{vals[0]:.4f} -> {vals[-1]:.4f} over {n_steps} steps")
    x_np = np.stack([train.dataset[i][0] for i in range(VISION["batch"])])
    y_np = np.stack([train.dataset[i][1] for i in range(VISION["batch"])])
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    model._ensure_train_step()
    step = model._train_step
    groups = n_groups(step)
    want["fused_pass2"] = n_steps * groups
    check(launches == want, f"(a) launches over fit's {n_steps} steps "
                            f"{launches}, want {want}")
    step(x, y)
    step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_call(torch, lambda: step(x, y))
    flop = step.flops(x, y)
    fit_s = e2["ms"] / 1e3
    cifar = dict(epochs=rec["epochs"], ms=e2["ms"],
                 images_s=VISION["batch"] / fit_s, mfu=cost.mfu(flop, fit_s),
                 flops=flop, peak_gib=max(e["peak_gib"] for e in
                                          rec["epochs"]),
                 eval=evaluated, groups=groups, launches=launches)
    cifar["device_ms"], cifar["idle"], cifar["parts"] = families_time(
        prof, fit_s, VISION_FAMILIES, VISION_REST)
    print(f"  (a) ResNet-50 (10 classes, {n_params} parameters, "
          f"{RESNET50_LEAVES} leaves, {groups} bucket group(s)), float32, "
          f"{VISION['batch']} x 3 x {VISION['hw']} x {VISION['hw']}: "
          f"{cifar['ms']:.2f} ms a step, {cifar['images_s']:.0f} images/s, "
          f"MFU {cifar['mfu']:.4f} ({flop:.4g} FLOP a step, "
          f"profiler/cost.py, over {cost.device_peak_flops():.4g}); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    del model, step, prof, net, bufs, init_bufs, rec
    torch.cuda.empty_cache()

    # (b) ImageNet's shape, the TrainStep that fit builds
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, hw = IMAGENET["batch"], IMAGENET["hw"]
    xb = torch.rand(B, 3, hw, hw, device="cuda", generator=gen)
    yb = torch.randint(0, IMAGENET["classes"], (B,), device="cuda",
                       generator=gen)
    paddle.seed(SEED + 22)
    net = resnet50(num_classes=IMAGENET["classes"])
    imagenet = {}
    for label, policy in (("float32", contextlib.nullcontext),
                          ("O1 bfloat16", lambda: amp.auto_cast(
                              level="O1", dtype="bfloat16"))):
        model = paddle.Model(net)
        model.prepare(momentum(net, 1e-3), nn.CrossEntropyLoss())
        model._ensure_train_step()
        step = model._train_step
        with policy():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = [step(xb, yb) for _ in range(IMAGENET["warmup"])]
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses += [step(xb, yb) for _ in range(IMAGENET["timed"])]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t) / IMAGENET["timed"]
            prof = profile_call(torch, lambda: losses.append(step(xb, yb)))
        vals = torch.stack(losses).float().tolist()
        check(np.isfinite(vals).all(), f"(b) {label}: non-finite {vals}")
        check(step.retraces == 1, f"(b) {label}: {step.retraces} captures")
        flop = step.flops(xb, yb)
        res = dict(ms=step_s * 1e3, images_s=B / step_s,
                   mfu=cost.mfu(flop, step_s), flops=flop,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   first=vals[0], last=vals[-1])
        print(f"  (b) ResNet-50 ({IMAGENET['classes']} classes) {label}, "
              f"{B} x 3 x {hw} x {hw}: {res['ms']:.2f} ms a step, "
              f"{res['images_s']:.1f} images/s, MFU {res['mfu']:.4f} "
              f"({flop:.4g} FLOP a step), peak {res['peak_gib']:.2f} GiB, "
              f"loss {vals[0]:.4f} -> {vals[-1]:.4f}")
        res["device_ms"], res["idle"], res["parts"] = families_time(
            prof, step_s, VISION_FAMILIES, VISION_REST)
        convs = {n: v for n, v in device_us_by_name(prof).items()
                 if any(c in n.lower() for c in CONV_NAMES)}
        low = sum(v for n, v in convs.items() if "bf16" in n.lower()
                  or "bfloat16" in n.lower())
        res["bf16_share"] = low / max(sum(convs.values()), 1e-9)
        print(f"  (b) {label}: kernels named bf16 take "
              f"{res['bf16_share']:.3f} of the convolutions' device time; "
              f"its largest: " + "; ".join(
                  f"{v / 1e3:.3f}ms {n[:80]}" for n, v in sorted(
                      convs.items(), key=lambda kv: -kv[1])[:4]))
        if label != "float32":
            check(res["bf16_share"] >= 0.5,
                  f"(b) {label}: the convolutions did not run the bf16 "
                  f"kernels ({res['bf16_share']:.3f} of their time)")
        imagenet[label] = res
        del model, step, prof, losses
        torch.cuda.empty_cache()
    del net, xb, yb
    torch.cuda.empty_cache()

    # (c) the dygraph eager loop at (a)'s shape
    paddle.seed(SEED + 23)
    net = resnet50(num_classes=VISION["classes"])
    opt = momentum(net)
    xe, ye = paddle.to_tensor(x_np), paddle.to_tensor(y_np)

    def eager_step():
        loss = F.cross_entropy(net(xe), ye)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for _ in range(VISION_EAGER["warmup"]):
        eager_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eloss = [eager_step() for _ in range(VISION_EAGER["timed"])]
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t) / VISION_EAGER["timed"]
    prof = profile_call(torch, eager_step)
    evals = [float(v) for v in eloss]
    check(np.isfinite(evals).all(), f"(c) non-finite losses {evals}")
    eager = dict(wall_ms=eager_s * 1e3)
    print(f"  (c) the eager loop (net(x) -> F.cross_entropy -> backward -> "
          f"opt.step -> clear_grad) on ResNet-50 at (a)'s shape: "
          f"{eager['wall_ms']:.2f} ms a step wall, loss {evals[0]:.4f} -> "
          f"{evals[-1]:.4f}")
    eager["device_ms"], eager["idle"], _ = families_time(
        prof, eager_s, VISION_FAMILIES, VISION_REST)
    del net, opt, prof, eloss
    torch.cuda.empty_cache()

    # (d) ResNet-18 card against CPU, float32, TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Bd, hwd = VISION_AGREE["batch"], VISION_AGREE["hw"]
    xd_np = np.random.RandomState(SEED + 24).rand(Bd, 3, hwd, hwd).astype(
        np.float32)
    yd_np = np.random.RandomState(SEED + 25).randint(0, 10, Bd)
    ev_data = Images(VISION_AGREE["eval_images"], seed=2)
    agree, state = {}, None
    try:
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            net = resnet18(num_classes=10)
            if state is None:
                state = vision_numpy_state(net, SEED + 26)
            load_paddle_tpu_state(net, state)
            model = paddle.Model(net)
            model.prepare(momentum(net, VISION_AGREE["lr"]),
                          nn.CrossEntropyLoss(), Accuracy())
            ts = [model.train_batch([paddle.to_tensor(xd_np)],
                                    [paddle.to_tensor(yd_np)])[0]
                  for _ in range(VISION_AGREE["steps"])]
            bn = [b.detach().cpu().clone() for b in net.buffers()]
            ev = model.evaluate(DataLoader(ev_data, batch_size=Bd),
                                verbose=0)
            agree[dev] = (ts, bn, ev)
            del model, net
    finally:
        paddle.set_device("gpu")
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    (card_ts, card_bn, card_ev), (cpu_ts, cpu_bn, cpu_ev) = \
        agree["gpu"], agree["cpu"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_ts, cpu_ts))
    bn_worst = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(card_bn, cpu_bn))
    ev_rel = abs(card_ev["loss"][0] - cpu_ev["loss"][0]) / abs(
        cpu_ev["loss"][0])
    print(f"  (d) ResNet-18 float32 (TF32 off), batch {Bd} x 3 x {hwd} x "
          f"{hwd}, {VISION_AGREE['steps']} train_batch steps: card "
          f"{card_ts}, CPU {cpu_ts}, worst relative {worst:.3g} (limit "
          f"{VISION_AGREE['rtol']}); running statistics worst "
          f"{bn_worst:.3g} of a buffer's largest value (limit "
          f"{VISION_AGREE['bn_rtol']}); evaluate on "
          f"{VISION_AGREE['eval_images']} images: card {card_ev}, CPU "
          f"{cpu_ev}")
    check(worst <= VISION_AGREE["rtol"], f"(d) losses differ by {worst}")
    check(bn_worst <= VISION_AGREE["bn_rtol"],
          f"(d) running statistics differ by {bn_worst}")
    check(card_ev["acc"] == cpu_ev["acc"] and
          ev_rel <= VISION_AGREE["eval_loss_rtol"],
          f"(d) evaluate differs: {card_ev} vs {cpu_ev}")

    # (e) a replayed ResNet-18 step against its eager body, buffers too
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        paddle.seed(SEED + 27)
        net = resnet18(num_classes=10)
        model = paddle.Model(net)
        model.prepare(momentum(net, VISION_AGREE["lr"]),
                      nn.CrossEntropyLoss())
        model._ensure_train_step()
        step = model._train_step
        xr, yr = paddle.to_tensor(xd_np), paddle.to_tensor(yd_np)
        replayed = hold_replayed(
            torch, step, lambda: step(xr, yr).value,
            lambda: step._eager_call(xr, yr).value,
            "(e) ResNet-18 float32 Momentum (cuDNN deterministic)", held=3,
            timed=3)
    finally:
        torch.backends.cudnn.deterministic = det
    del model, step, net
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags
    print(f"  phase 17 took {time.perf_counter() - t0:.1f}s")
    return dict(cifar=cifar, imagenet=imagenet, eager=eager,
                agree=dict(worst=worst, bn=bn_worst, eval_rel=ev_rel),
                replayed=replayed)


# phase 18: the recurrent slice. (a) Transformer-base (Vaswani et al.,
# 2017: the repo's Seq2SeqConfig defaults) at ~4096 target tokens a
# batch; (b) an LSTM encoder-decoder with attention at PaddleNLP's
# examples/machine_translation/seq2seq widths (IWSLT'15 En-Vi)
S2S = dict(batch=32, src=128, tgt=128, min_len=64, warmup=2, timed=3,
           lr=1e-4, agree_batch=2, agree_rtol=1e-4, greedy_sources=8,
           greedy_len=32, held=2, timed_held=2)
S2S_PARAMS = 77_168_640  # Seq2SeqTransformer(Seq2SeqConfig()): 255 leaves
S2S_LEAVES = 255
# post-norm: 2 LayerNorms an encoder layer, 3 a decoder layer, no final
S2S_NORMS = 6 * 2 + 6 * 3
LSTM_S2S = dict(src_vocab=17191, tgt_vocab=7709, hidden=512, layers=2,
                dropout=0.2, batch=128, seq=50, min_len=20, beam=10,
                steps=4, lr=1e-3, clip=5.0, init=0.1, agree_sources=4,
                score_rtol=1e-4, held=2, timed_held=3)
RNN_AGREE = dict(batch=16, seq=32, width=256, rtol=1e-4)


def s2s_numpy_state(model, seed):
    """{name: numpy array} for a Seq2SeqTransformer: the token and
    position tables Normal(0, d_model^-0.5) (the usual Transformer init:
    scaled by sqrt(d_model) they are unit-variance), Linear weights
    XavierNormal ([in, out]), zero biases, unit LayerNorm weights."""
    rng = np.random.default_rng(seed)
    d = model.cfg.d_model
    out = {}
    for k, p in model.named_parameters():
        shape = tuple(p.shape)
        if k.endswith("bias"):
            out[k] = np.zeros(shape, np.float32)
        elif "norm" in k:
            out[k] = np.ones(shape, np.float32)
        elif "embed" in k:
            out[k] = rng.standard_normal(shape, dtype=np.float32) * d ** -0.5
        else:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            out[k] = rng.standard_normal(shape, dtype=np.float32) * std
    return out


def s2s_batch(rng, B, S, T, src_vocab, tgt_vocab, min_len):
    """(src, tgt_in, labels) int64: sources of seeded lengths in
    [min_len, S], pad (0) after; targets bos (1), tokens, eos (2) at a
    seeded length in [min_len, T], pad after; labels the targets shifted
    by one."""
    src = rng.integers(3, src_vocab, (B, S))
    src[np.arange(S)[None] >= rng.integers(min_len, S + 1, B)[:, None]] = 0
    tgt = rng.integers(3, tgt_vocab, (B, T + 1))
    tgt[:, 0] = 1
    ends = rng.integers(min_len, T + 1, B)
    tgt[np.arange(B), ends] = 2
    tgt[np.arange(T + 1)[None] > ends[:, None]] = 0
    return (src.astype(np.int64), tgt[:, :-1].astype(np.int64),
            tgt[:, 1:].astype(np.int64))


def s2s_loss_fn(F):
    """The teacher-forced loss of both models: mean cross-entropy over
    the non-pad labels."""
    def loss_fn(logits, labels):
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]),
                               ignore_index=0)
    return loss_fn


S2S_FAMILIES = {"products": ("gemm", "sm90", "cutlass", "xmma", "matmul"),
                "layer norm #5-#6": ("ln_", "layer_norm"),
                "xent #7-#8": ("xent",), "epilogue #9-#10": ("fused_",)}


def greedy_mismatch(torch, cpu_model, src, got, want, limit):
    """None when the card's greedy tokens equal the CPU's; else, at each
    row's first mismatch, the CPU's top-2 logit gap there must be at
    most `limit` (a near-tie): returns the gaps."""
    if got.shape == want.shape and torch.equal(got, want):
        return None
    gaps = []
    n = min(got.shape[1], want.shape[1])
    for b in range(got.shape[0]):
        diff = (got[b, :n] != want[b, :n]).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        with torch.no_grad():
            logits = cpu_model(src[b:b + 1], want[b:b + 1, :t])[0, -1]
        top = torch.topk(logits.float(), 2).values
        gaps.append(float(top[0] - top[1]))
    check(all(g <= limit for g in gaps),
          f"(a) greedy tokens differ card vs CPU beyond a near-tie: top-2 "
          f"gaps {gaps} (limit {limit})")
    return gaps


def phase_transformer_base(torch, km):
    """(a) Seq2SeqTransformer(Seq2SeqConfig()) trained by a replayed
    TrainStep on the default route and with both switches set, a replay
    against its eager body, the step-1 loss and greedy tokens card
    against CPU. Returns the measurements."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (Seq2SeqConfig, Seq2SeqTransformer,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.optimizer import AdamW
    F = paddle.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = True
    print("  float32 weights, TF32 products (matmul TF32 on)")
    cfg = Seq2SeqConfig()
    paddle.seed(SEED + 30)
    model = Seq2SeqTransformer(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == S2S_PARAMS and len(model.parameters()) == S2S_LEAVES,
          f"(a) Transformer-base has {n_params} parameters in "
          f"{len(model.parameters())} leaves")
    state = s2s_numpy_state(model, SEED + 31)
    load_paddle_tpu_state(model, state)
    B, S, T = S2S["batch"], S2S["src"], S2S["tgt"]
    src, tin, lab = s2s_batch(np.random.default_rng(SEED + 32), B, S, T,
                              cfg.src_vocab_size, cfg.tgt_vocab_size,
                              S2S["min_len"])
    x = [torch.from_numpy(a).cuda() for a in (src, tin, lab)]
    n_tok = int((lab != 0).sum())
    step = TrainStep(model, s2s_loss_fn(F),
                     AdamW(learning_rate=S2S["lr"],
                           parameters=model.parameters()),
                     monitor_health=True)
    groups, runs = None, {}
    n_steps = S2S["warmup"] + S2S["timed"] + 1
    for route, on in (("default", False), ("switched", True)):
        with switches(on):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = step.retraces
            zero_counts(km)
            losses = [step(*x) for _ in range(S2S["warmup"])]
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses += [step(*x) for _ in range(S2S["timed"])]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t) / S2S["timed"]
            prof = profile_call(torch, lambda: losses.append(step(*x)))
            launches = counts(km)
            peak = (paddle.device.max_memory_allocated(),
                    torch.cuda.max_memory_allocated())
        groups = n_groups(step)
        want = {k: 0 for k in launches}
        want.update(fused_pass1=n_steps * groups,
                    fused_pass2=n_steps * groups)
        if on:
            want.update(layer_norm_fwd=n_steps * S2S_NORMS,
                        layer_norm_bwd=n_steps * S2S_NORMS,
                        softmax_xent_fwd=n_steps, softmax_xent_bwd=n_steps)
        vals = torch.stack(losses).float().tolist()
        res = dict(ms=step_s * 1e3, tokens_s=n_tok / step_s,
                   all_tokens_s=B * T / step_s, peak_api=peak[0],
                   peak_torch=peak[1], first=vals[0], last=vals[-1],
                   launches={k: v for k, v in launches.items() if v},
                   captures=step.retraces - before)
        print(f"  (a) {route} route: {res['ms']:.2f} ms a step (replayed), "
              f"{res['tokens_s']:.0f} target tokens/s ({n_tok} non-pad of "
              f"{B} x {T}; {res['all_tokens_s']:.0f} counting pads), loss "
              f"{vals[0]:.4f} -> {vals[-1]:.4f}; peak "
              f"paddle.device.max_memory_allocated() {peak[0]} B, "
              f"torch.cuda.max_memory_allocated() {peak[1]} B "
              f"({peak[0] / 2**30:.2f} GiB); captures {res['captures']}; "
              f"launches over its {n_steps} steps {res['launches']}")
        res["device_ms"], res["idle"], res["parts"] = families_time(
            prof, step_s, S2S_FAMILIES)
        check(np.isfinite(vals).all(), f"(a) {route}: non-finite {vals}")
        check(peak[0] == peak[1], f"(a) the two peak APIs disagree: {peak}")
        check(res["captures"] == 1, f"(a) {route}: {res['captures']} "
                                    f"captures")
        check(launches == want, f"(a) {route}: launches {launches}, want "
                                f"{want}")
        runs[route] = res
        del prof
    print(f"  (a) launches predicted: #9 and #10 {groups} a step "
          f"(bucket groups; monitor_health asks for pass 1), #5 and #6 "
          f"{S2S_NORMS} a step on the switched route (6 encoder layers x 2 "
          f"+ 6 decoder layers x 3 post-norm LayerNorms), #7 and #8 one a "
          f"step ({B * T} x {cfg.tgt_vocab_size} logits); #2-#4 none: "
          f"every attention has a mask and takes the plain composition")
    with switches(False):
        replayed = hold_replayed(
            torch, step, lambda: step(*x), lambda: step._eager_call(*x),
            "(a) Transformer-base AdamW (dropout 0.1, the CUDA generator "
            "restored)", held=S2S["held"], timed=S2S["timed_held"])
    del step
    torch.cuda.empty_cache()

    # card (both routes) against CPU, TF32 off, dropout 0 on all sides:
    # the losses of steps 1 and 2 (step 2's after one AdamW update, so
    # the backward's grads count too)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg0 = Seq2SeqConfig(dropout=0.0)
    n = S2S["agree_batch"]
    agree, models = {}, {}
    try:
        for dev, route, on in (("gpu", "default", False),
                               ("gpu", "switched", True),
                               ("cpu", "default", False)):
            paddle.set_device(dev)
            m = Seq2SeqTransformer(cfg0)
            load_paddle_tpu_state(m, state)
            st = TrainStep(m, s2s_loss_fn(F), AdamW(
                learning_rate=S2S["lr"], parameters=m.parameters()))
            xb = [paddle.to_tensor(a[:n]) for a in (src, tin, lab)]
            zero_counts(km)
            with switches(on):
                agree[dev, route] = [float(st(*xb)) for _ in range(2)]
            if on:
                got = {k: counts(km)[k]
                       for k, _ in NORM_KERNELS + XENT_KERNELS}
                check(got == {k: 2 * (S2S_NORMS if k.startswith("layer")
                                      else 1) for k in got},
                      f"(a) switched route on {n} sequences: launches {got}")
            del st
            if not on:
                m.eval()
                load_paddle_tpu_state(m, state)
                models[dev] = m
    finally:
        paddle.set_device("gpu")
    want = agree["cpu", "default"]
    rel = {route: max(abs(g - w) / abs(w) for g, w in
                      zip(agree["gpu", route], want))
           for route in ("default", "switched")}
    print(f"  (a) losses of steps 1 and 2 on {n} sequences, TF32 off, "
          f"dropout 0: card default route {agree['gpu', 'default']}, card "
          f"switched route (#5-#8) {agree['gpu', 'switched']}, CPU {want}; "
          f"largest relative difference from the CPU {rel} (limit "
          f"{S2S['agree_rtol']})")
    check(max(rel.values()) <= S2S["agree_rtol"],
          f"(a) losses of steps 1-2: card {agree}, CPU {want}")
    rel = max(rel.values())
    k = S2S["greedy_sources"]
    gsrc = torch.from_numpy(src[:k])
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = models["gpu"].greedy_decode(gsrc.cuda(),
                                      max_len=S2S["greedy_len"])
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t
    want = models["cpu"].greedy_decode(gsrc, max_len=S2S["greedy_len"])
    gaps = greedy_mismatch(torch, models["cpu"], gsrc, got.cpu(), want,
                           GAP_LIMIT)
    steps = got.shape[1] - 1
    agreed = "equal to the CPU" if gaps is None else \
        f"differ at near-ties, top-2 gaps {gaps}"
    print(f"  (a) greedy_decode(max_len={S2S['greedy_len']}) on {k} "
          f"sources, TF32 off: {steps} steps, {greedy_s / steps * 1e3:.2f} "
          f"ms a step on the card (one forward over the prefix each); "
          f"tokens {agreed}")
    del models
    torch.cuda.empty_cache()
    return dict(runs=runs, replayed=replayed, agree_rel=rel,
                greedy_ms=greedy_s / steps * 1e3, greedy_gaps=gaps,
                groups=groups)


def lstm_seq2seq(paddle, torch, c):
    """PaddleNLP's machine_translation/seq2seq model (seq2seq_attn.py)
    from the port's layers: an LSTM encoder; a decoder cell stacking
    LSTMCells fed the embedding and the last attention output, then dot
    attention over the encoder outputs (input_proj, output_proj, tanh);
    the vocab projection without bias. The cell holds the encoder
    outputs and their pad bias (`attend`: tiled by beam for decoding)
    for the length of a call (`attend(None)` after it, so that no
    step's graph outlives the step)."""
    nn = paddle.nn
    H, L = c["hidden"], c["layers"]

    class AttnCell(nn.RNNCellBase):
        _paddle_io = False

        def __init__(self):
            super().__init__()
            self.cells = nn.LayerList([nn.LSTMCell(2 * H if i == 0 else H, H)
                                       for i in range(L)])
            self.drop = nn.Dropout(c["dropout"])
            self.input_proj = nn.Linear(H, H, bias_attr=False)
            self.output_proj = nn.Linear(2 * H, H, bias_attr=False)
            self.memory = self.memory_bias = None

        def forward(self, x, states):
            lstm_states, feed = states
            inp = torch.cat([x, feed], -1)
            new = []
            for cell, st in zip(self.cells, lstm_states):
                out, st = cell(inp, st)
                inp = self.drop(out)
                new.append(st)
            q = self.input_proj(inp)
            scores = torch.einsum("bsh,bh->bs", self.memory, q) + \
                self.memory_bias
            ctx = torch.einsum("bs,bsh->bh", torch.softmax(scores, -1),
                               self.memory)
            out = torch.tanh(self.output_proj(torch.cat([ctx, inp], -1)))
            return out, (new, out)

    class Seq2SeqAttn(nn.Layer):
        _paddle_io = False

        def __init__(self):
            super().__init__()
            self.src_embed = nn.Embedding(c["src_vocab"], H)
            self.encoder = nn.LSTM(H, H, num_layers=L, dropout=c["dropout"])
            self.tgt_embed = nn.Embedding(c["tgt_vocab"], H)
            self.decoder = nn.RNN(AttnCell())
            self.out = nn.Linear(H, c["tgt_vocab"], bias_attr=False)

        @property
        def cell(self):
            return self.decoder.cell

        def encode(self, src):
            memory, (h, cc) = self.encoder(self.src_embed(src))
            return memory, ([(h[i], cc[i]) for i in range(L)],
                            memory.new_zeros(src.shape[0], H))

        def attend(self, memory, src=None):
            self.cell.memory = memory
            self.cell.memory_bias = None if src is None else torch.where(
                src == 0, -1e9, 0.0).float()

        def forward(self, src, tgt):
            memory, init = self.encode(src)
            self.attend(memory, src)
            out, _ = self.decoder(self.tgt_embed(tgt), init)
            self.attend(None)
            return self.out(out)

        @torch.no_grad()
        def beam_search(self, src, beam, max_steps, times=None):
            """BeamSearchDecoder + dynamic_decode: (sequences, scores).
            `times`, a list: the encoder's and the decode loop's seconds
            are appended (synchronized)."""
            clock = [time.perf_counter()]
            memory, init = self.encode(src)
            tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
            self.attend(tile(memory, beam), tile(src, beam))
            dec = nn.BeamSearchDecoder(self.cell, start_token=1,
                                       end_token=2, beam_size=beam,
                                       embedding_fn=self.tgt_embed,
                                       output_fn=self.out)
            if times is not None:
                torch.cuda.synchronize()
                clock.append(time.perf_counter())
            out = nn.dynamic_decode(dec, inits=init, max_step_num=max_steps)
            self.attend(None)
            if times is not None:
                torch.cuda.synchronize()
                clock.append(time.perf_counter())
                times += [clock[1] - clock[0], clock[2] - clock[1]]
            return out

    return Seq2SeqAttn()


def dtoh_copies(prof):
    """(count, bytes) of the device-to-host copies in a profiled window,
    from its Chrome trace (bytes None when the trace gives none)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    return len(copies), (sum(sizes) if None not in sizes else None)


def phase_lstm_seq2seq(torch, km):
    """(b) the LSTM encoder-decoder trained by a replayed TrainStep
    (AdamW, ClipGradByGlobalNorm(5)), a replay against its eager body,
    beam search over the batch, 4 sources card against CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import load_paddle_tpu_state
    from paddle_tpu_torch.ops.kernels.softmax_xent import supported
    c = LSTM_S2S
    F = paddle.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = True
    paddle.seed(SEED + 40)
    model = lstm_seq2seq(paddle, torch, c)
    rng = np.random.default_rng(SEED + 41)
    state = {k: rng.uniform(-c["init"], c["init"], tuple(p.shape)).astype(
        np.float32) for k, p in model.named_parameters()}
    load_paddle_tpu_state(model, state)
    n_params = sum(p.numel() for p in model.parameters())
    B, T = c["batch"], c["seq"]
    src, tin, lab = s2s_batch(np.random.default_rng(SEED + 42), B, T, T,
                              c["src_vocab"], c["tgt_vocab"], c["min_len"])
    x = [torch.from_numpy(a).cuda() for a in (src, tin, lab)]
    n_tok = int((lab != 0).sum())
    opt = paddle.optimizer.AdamW(
        learning_rate=c["lr"], parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(c["clip"]))
    step = TrainStep(model, s2s_loss_fn(F), opt)
    zero_counts(km)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses = [step(*x)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    losses += [step(*x) for _ in range(c["steps"] - 1)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / (c["steps"] - 1)
    launches = counts(km)
    groups = n_groups(step)
    want = {k: 0 for k in launches}
    want.update(fused_pass1=c["steps"] * groups,
                fused_pass2=c["steps"] * groups)
    vals = torch.stack(losses).float().tolist()
    peak = (paddle.device.max_memory_allocated(),
            torch.cuda.max_memory_allocated())
    print(f"  (b) {n_params} parameters; {c['steps']} steps: the first "
          f"(eager run + capture) {first_s * 1e3:.0f} ms, then "
          f"{step_s * 1e3:.2f} ms a replayed step, {n_tok / step_s:.0f} "
          f"target tokens/s ({n_tok} non-pad of {B} x {T}); loss "
          f"{vals[0]:.4f} -> {vals[-1]:.4f}; peak {peak[0]} B (paddle), "
          f"{peak[1]} B (torch); launches "
          f"{ {k: v for k, v in launches.items() if v} }; #7-#8 not on "
          f"this path: {B * T} x {c['tgt_vocab']} logits, and "
          f"supported({B * T}, {c['tgt_vocab']}) = "
          f"{supported(B * T, c['tgt_vocab'])} (no vocab block of 128s "
          f"divides {c['tgt_vocab']})")
    check(np.isfinite(vals).all(), f"(b) non-finite losses {vals}")
    check(peak[0] == peak[1], f"(b) the two peak APIs disagree: {peak}")
    check(step.retraces == 1, f"(b) {step.retraces} captures")
    check(launches == want, f"(b) launches {launches}, want {want}")
    replayed = hold_replayed(
        torch, step, lambda: step(*x), lambda: step._eager_call(*x),
        "(b) LSTM seq2seq AdamW + global-norm clip (dropout 0.2, the CUDA "
        "generator restored)", held=c["held"], timed=c["timed_held"])
    del step

    # beam search over the batch
    model.eval()
    srct = x[0]
    model.beam_search(srct[:8], c["beam"], 4)  # warm the allocator
    times = []
    seqs, scores = model.beam_search(srct, c["beam"], T, times)
    enc_s, dec_s = times
    n_dec = seqs.shape[2]
    prof = profile_call(torch, lambda: model.beam_search(srct, c["beam"],
                                                         T))
    copies, copied = dtoh_copies(prof)
    dev_ms = sum(device_us_by_name(prof).values()) / 1e3
    check(seqs.shape[:2] == (B, c["beam"]) and torch.isfinite(scores).all(),
          f"(b) beam search gave {tuple(seqs.shape)}")
    check((scores[:, :-1] >= scores[:, 1:]).all(), "(b) beams not sorted")
    print(f"  (b) beam search, beam {c['beam']}, {B} sources ({B * c['beam']}"
          f" rows): the encoder (eager) {enc_s * 1e3:.1f} ms, then {n_dec} "
          f"decode steps in {dec_s * 1e3:.1f} ms, {dec_s / n_dec * 1e3:.3f} "
          f"ms a decode step (wall); device {dev_ms / n_dec:.3f} ms a "
          f"decode step, the encoder's included (profiled run); "
          f"device-to-host copies {copies}, {copied} bytes over {n_dec} "
          f"steps ({copies / n_dec:.2f} a step: the exit test's bool); "
          f"best score "
          f"{float(scores[0, 0]):.4f}")

    # 4 sources card against CPU, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    k = c["agree_sources"]
    import copy as _copy
    cpu_model = _copy.deepcopy(model).to("cpu")
    got_s, got_sc = model.beam_search(srct[:k], c["beam"], T)
    want_s, want_sc = cpu_model.beam_search(srct[:k].cpu(), c["beam"], T)
    got_s, got_sc = got_s.cpu(), got_sc.cpu()
    same = [bool(torch.equal(got_s[b], want_s[b])) if got_s.shape ==
            want_s.shape else False for b in range(k)]
    rel = float(((got_sc - want_sc).abs() / want_sc.abs()).max())
    print(f"  (b) {k} sources, TF32 off: sequences equal for "
          f"{sum(same)} of {k}; scores card {got_sc[:, 0].tolist()} CPU "
          f"{want_sc[:, 0].tolist()}, largest relative difference "
          f"{rel:.3g} (limit {c['score_rtol']})")
    check(all(same), f"(b) beam search sequences differ card vs CPU: "
                     f"{same}")
    check(rel <= c["score_rtol"], f"(b) beam scores differ by {rel}")
    del model, cpu_model, prof
    torch.cuda.empty_cache()
    return dict(ms=step_s * 1e3, first_ms=first_s * 1e3,
                tokens_s=n_tok / step_s, replayed=replayed,
                encode_ms=enc_s * 1e3,
                decode_ms=dec_s / n_dec * 1e3, decode_steps=n_dec,
                decode_device_ms=dev_ms / n_dec, dtoh=copies / n_dec,
                dtoh_bytes=copied,
                launches={k: v for k, v in launches.items() if v},
                n_params=n_params, peak=peak[0], score_rel=rel)


def phase_recurrent_rest(torch, card):
    """(c) bidirectional 2-layer GRU and SimpleRNN card against CPU,
    paddle.device's Event around a product, its device name and memory
    queries."""
    import paddle_tpu_torch as paddle
    c = RNN_AGREE
    torch.backends.cuda.matmul.allow_tf32 = False
    import copy as _copy
    for cls in ("GRU", "SimpleRNN"):
        paddle.seed(SEED + 50)
        layer = getattr(paddle.nn, cls)(c["width"], c["width"],
                                        num_layers=2, direction="bidirect")
        cpu = _copy.deepcopy(layer).to("cpu")
        xs = torch.randn(c["batch"], c["seq"], c["width"],
                         generator=torch.Generator().manual_seed(SEED + 51))
        with torch.no_grad():
            go, gh = layer(xs.cuda())
            co, ch = cpu(xs)
        err = max(float((go.cpu() - co).abs().max()),
                  float((gh.cpu() - ch).abs().max()))
        print(f"  (c) {cls} bidirect, 2 layers, [{c['batch']}, {c['seq']}, "
              f"{c['width']}]: card vs CPU largest difference {err:.3g} "
              f"(limit {c['rtol']})")
        check(err <= c["rtol"], f"(c) {cls} card vs CPU differ by {err}")
    a = torch.randn(8192, 8192, device="cuda")
    dev = paddle.device
    times = []
    for make in (lambda: dev.Event(enable_timing=True),
                 lambda: torch.cuda.Event(enable_timing=True)):
        ms = []
        for _ in range(3):
            start, end = make(), make()
            start.record()
            a @ a
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        times.append(sorted(ms)[1])
    print(f"  (c) an 8192^3 float32 product (TF32 off): paddle.device.Event "
          f"{times[0]:.3f} ms, torch.cuda.Event {times[1]:.3f} ms "
          f"({2 * 8192 ** 3 / times[0] / 1e9:.1f} TFLOP/s)")
    check(0.8 <= times[0] / times[1] <= 1.25,
          f"(c) the two events disagree: {times}")
    name = dev.get_device_properties().name
    check(name == card.split(",")[0].strip(),
          f"(c) get_device_properties().name {name!r}, nvidia-smi {card!r}")
    alloc, reserved = dev.memory_allocated(), dev.memory_reserved()
    check(reserved >= alloc and alloc == torch.cuda.memory_allocated(),
          f"(c) memory_reserved {reserved} < memory_allocated {alloc}")
    print(f"  (c) get_device_properties().name {name!r}; "
          f"memory_allocated {alloc} B <= memory_reserved {reserved} B; "
          f"cuDNN {dev.get_cudnn_version()}")
    del a


def phase_seq2seq(torch, km, card):
    """Phase 18: (a), (b), (c). Returns the measurements."""
    t0 = time.perf_counter()
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        print("  (a) Transformer-base (Seq2SeqConfig(): vocab 32000 / "
              "32000, d_model 512, 8 heads, 6 + 6 layers, FFN 2048)",
              flush=True)
        base = phase_transformer_base(torch, km)
        print("  (b) LSTM seq2seq with attention (PaddleNLP "
              "machine_translation/seq2seq, IWSLT'15 En-Vi widths)",
              flush=True)
        rnn = phase_lstm_seq2seq(torch, km)
        print("  (c) GRU / SimpleRNN card vs CPU, Event, device queries",
              flush=True)
        phase_recurrent_rest(torch, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"  phase 18 took {time.perf_counter() - t0:.1f}s")
    return dict(base=base, rnn=rnn)


# -- the data pipeline's rest and the legacy generation path ------------------

# phase 19 (a): phase 17's fit, one epoch, through worker processes and
# the device prefetch ring; (b) bench.py's steady loop (bench.py:430-439)
# on 7c's step: 2 steps to capture and warm, then 10 timed, the batches
# new host arrays every step
DATA_PATH = dict(workers=4, depth=2)
PREFETCH_LOOP = dict(warmup=2, timed=10, depth=2)
# phase 20 (a): examples/bench_decode.py's TPU configuration
DECODE = dict(prompt=32, new=128, top_k=50, batches=(1, 8, 32))
# (c): bench.py --serve's model and clients (bench.py:1286-1330)
SERVE_DIM, SERVE_CLIENTS, SERVE_REQS = 2048, 8, 40
SERVE_LADDER = (1, 2, 4, 8)
# (d): a 2-layer float32 GPT-medium, card against CPU
AGREE_DECODE = dict(batch=4, prompt=32, new=32, steps=8,
                    lengths=(40, 17, 64))


def batch_checksum(torch, batch):
    """An order-sensitive checksum of an (images, labels) batch on the
    device (float64): each image's sum and each label, weighted by their
    row."""
    x, y = (t.value if hasattr(t, "value") else t for t in batch)
    w = torch.arange(1, x.shape[0] + 1, device=x.device,
                     dtype=torch.float64)
    return torch.stack([(x.double().sum(dim=(1, 2, 3)) * w).sum(),
                        (y.double() * w).sum()])


def phase_data_path(torch, km, cifar):
    """19 (a): phase 17's ResNet-50 `Model.fit` at CIFAR-10's shape (the
    same model, optimizer, data and batch; one epoch, no evaluation)
    through DataLoader(num_workers=4, prefetch_to_device=2): worker
    processes assemble the batches, the ring copies them to the card.
    The dataset is the port's TensorDataset over SyntheticImages'
    arrays, so spawned workers can unpickle it. Holds: the native ring
    loaded; the batches the step receives equal (order-sensitive
    checksums) those of DataLoader(num_workers=0) under the same numpy
    seed, and so do those of the threaded path (worker threads over the
    native ring); #10 once a group a step and nothing else. Prints ms a
    step, images/s, idle share, dataloader.wait_s p50 / p99 and
    prefetch.h2d_bytes beside phase 17's num_workers=0 run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, runtime
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.profiler import monitor
    from paddle_tpu_torch.vision.models import resnet50
    lib = runtime.get_lib()
    check(lib is not None, f"19 (a): the native ring did not load: "
                           f"{runtime.build_error()}")
    print(f"  the native runtime loaded: {lib._name}")
    paddle.set_device("gpu")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # phase 17's (torch's defaults)
    images = SyntheticImages(VISION["train"])
    data = TensorDataset([images.x, images.y])
    B = VISION["batch"]

    class Recording(DataLoader):
        """A DataLoader that keeps each batch's checksum as it hands the
        batch on (fit takes a DataLoader as it is)."""

        def __iter__(self):
            self.sums = []
            for batch in super().__iter__():
                self.sums.append(batch_checksum(torch, batch))
                yield batch

    def epoch_sums(**kw):
        np.random.seed(SEED)
        loader = Recording(data, batch_size=B, shuffle=True, **kw)
        for _ in loader:
            pass
        return torch.stack(loader.sums)

    want = epoch_sums()
    t = time.perf_counter()
    threaded = epoch_sums(num_workers=DATA_PATH["workers"],
                          use_shared_memory=False)
    threaded_s = time.perf_counter() - t
    check(torch.equal(threaded, want), "19 (a): the threaded path's "
                                       "batches differ from num_workers=0")
    print(f"  worker threads over the native ring ({DATA_PATH['workers']} "
          f"threads): {len(want)} batches equal to num_workers=0's, "
          f"{threaded_s:.2f}s an epoch")

    paddle.seed(SEED + 20)
    net = resnet50(num_classes=VISION["classes"])
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(
        learning_rate=VISION["lr"], momentum=VISION["momentum"],
        parameters=net.parameters()), nn.CrossEntropyLoss(), Accuracy())
    np.random.seed(SEED)
    train = Recording(data, batch_size=B, shuffle=True,
                      num_workers=DATA_PATH["workers"],
                      prefetch_to_device=DATA_PATH["depth"])
    n_batches = len(train)
    rec = {}

    class Clock(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            rec["t0"] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            rec["loss"] = logs["loss"][0]
            if step == 0:
                torch.cuda.synchronize()
                rec["t1"] = time.perf_counter()
            if step == n_batches - 1:
                torch.cuda.synchronize()
                rec["t2"] = time.perf_counter()
                rec["bound"] = train._batch_sharding_fn

    monitor.reset_metrics()
    zero_counts(km)
    model.fit(train, epochs=1, verbose=0, callbacks=[Clock()])
    launches = counts(km)
    check(torch.equal(torch.stack(train.sums), want),
          "19 (a): the step's batches differ from num_workers=0's")
    check(rec["bound"] is not None and train._batch_sharding_fn is None,
          "19 (a): fit did not bind (or did not release) the step's "
          "input_sharding")
    step = model._train_step
    groups = n_groups(step)
    want_launches = {k: 0 for k in launches}
    want_launches["fused_pass2"] = n_batches * groups
    check(launches == want_launches, f"19 (a): launches {launches}, want "
                                     f"{want_launches}")
    loss = float(rec["loss"])
    check(np.isfinite(loss), f"19 (a): loss {loss}")
    wall_s = rec["t2"] - rec["t0"]
    ms = (rec["t2"] - rec["t1"]) / (n_batches - 1) * 1e3
    wait = monitor.histogram("dataloader.wait_s")
    h2d = monitor.counter("prefetch.h2d_bytes").value
    x = torch.from_numpy(images.x[:B]).cuda()
    y = torch.from_numpy(images.y[:B]).cuda()
    step(x, y)
    torch.cuda.synchronize()
    prof = profile_call(torch, lambda: step(x, y))
    device_ms, idle, _ = families_time(prof, ms / 1e3, VISION_FAMILIES,
                                       VISION_REST)
    check(h2d >= data.tensors[0].nbytes, f"19 (a): {h2d} bytes staged")
    print(f"  (a) ResNet-50 fit, 1 epoch of {n_batches} steps through "
          f"{DATA_PATH['workers']} worker processes and the ring (depth "
          f"{DATA_PATH['depth']}): {ms:.2f} ms a replayed step, "
          f"{B / ms * 1e3:.0f} images/s ({len(data) / wall_s:.0f} over the "
          f"epoch, the capture and the workers' start included, "
          f"{wall_s:.2f}s), device {device_ms:.2f} ms, idle share "
          f"{idle:.3f}; dataloader.wait_s p50 {wait.percentile(50) * 1e3:.3f}"
          f" ms, p99 {wait.percentile(99) * 1e3:.3f} ms over {wait.count} "
          f"batches (the largest, {wait.max:.2f}s, the first: the workers' "
          f"start, each a spawned process that imports torch and the "
          f"port); prefetch.h2d_bytes {h2d}; loss {loss:.4f}; launches "
          f"#10 {launches['fused_pass2']} = {n_batches} x {groups} groups")
    print(f"  (a) beside phase 17 (num_workers=0, this run): "
          f"{cifar['ms']:.2f} ms a replayed step, {cifar['images_s']:.0f} "
          f"images/s, idle share {cifar['idle']:.3f}")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags
    out = dict(ms=ms, idle=idle, launches=launches, h2d=h2d)
    del model, step, net, prof
    torch.cuda.empty_cache()
    return out


def phase_prefetch_loop(torch, km, tmods, state, cfg, dots):
    """19 (b): bench.py's steady loop (bench.py:430-439) on 7c's step
    (GPT-1.3B bf16, remat "dots", the chunked loss, bench.py's Momentum,
    both switches set as 7c has them), fed once from the host (each
    step's [4, 1024] ids copied to the card in the loop) and once through
    device_prefetch_iterator(depth=2, sharding_fn=step.input_sharding),
    each from the same weights on the same new host batch every step:
    the losses bit-equal; the ring's launches those of 7c a step. Prints
    ms a step, idle share and prefetch.h2d_bytes beside 7c's."""
    from paddle_tpu_torch.io.device_prefetch import device_prefetch_iterator
    from paddle_tpu_torch.profiler import monitor
    run = PREFETCH_LOOP
    n = run["warmup"] + run["timed"]
    rng = np.random.RandomState(SEED + 30)
    host = [rng.randint(0, cfg.vocab_size, size=(BENCH_1P3B["batch"],
                                                 BENCH_1P3B["seq"])
                        ).astype(np.int32) for _ in range(n)]
    res = {}
    for kind in ("host", "ring"):
        with switches(True):
            model, step = bench_step(torch, tmods, state, cfg, "dots")
            if kind == "host":
                batches = ((torch.from_numpy(a).cuda(),) * 2 for a in host)
            else:
                monitor.reset_metrics()
                batches = device_prefetch_iterator(
                    ((a, a) for a in host), depth=run["depth"],
                    sharding_fn=step.input_sharding)
            zero_counts(km)
            losses = []
            for i, (ids, labels) in enumerate(batches):
                if i == run["warmup"]:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                losses.append(step(ids, labels))
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t) / run["timed"]
            launches = counts(km)
            ids = torch.from_numpy(host[0]).cuda()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step(ids, ids)
                torch.cuda.synchronize()
            device_ms = sum(device_us_by_name(prof).values()) / 1e3
        res[kind] = dict(
            losses=torch.stack(losses), ms=step_s * 1e3,
            device_ms=device_ms or None,
            idle=max(0.0, 1 - device_ms / (step_s * 1e3)) if device_ms
            else None, launches=launches,
            h2d=monitor.counter("prefetch.h2d_bytes").value)
        del step, model, prof
        torch.cuda.empty_cache()
    a, b = res["host"]["losses"], res["ring"]["losses"]
    check(torch.isfinite(a).all() and torch.equal(a, b),
          f"19 (b): the ring's losses {b.tolist()} differ from the "
          f"host-fed loop's {a.tolist()}")
    ring = res["ring"]
    for name, per_step in BENCH_1P3B_LAUNCHES.items():
        check(ring["launches"][name] == n * per_step,
              f"19 (b): {name}: {ring['launches'][name]} launches, want "
              f"{n} x {per_step}")
    want_h2d = 2 * sum(h.nbytes for h in host)
    check(ring["h2d"] == want_h2d, f"19 (b): prefetch.h2d_bytes "
                                   f"{ring['h2d']}, want {want_h2d}")
    for kind, r in res.items():
        idle = "n/m" if r["idle"] is None else f"{r['idle']:.3f}"
        dev = "n/m" if r["device_ms"] is None else f"{r['device_ms']:.2f}"
        print(f"  (b) {kind}-fed loop: {r['ms']:.2f} ms a step over "
              f"{run['timed']} timed steps, device {dev} ms (a profiled "
              f"step), idle share {idle}")
    idle7c = "n/m" if dots["idle"] is None else f"{dots['idle']:.3f}"
    print(f"  (b) losses bit-equal over {n} steps ({a[0]:.6f} -> "
          f"{a[-1]:.6f}); prefetch.h2d_bytes {ring['h2d']}; beside 7c "
          f"(one device-resident batch, no ring): {dots['ms']:.2f} ms a "
          f"step, idle share {idle7c}")
    return ring


def phase_generate(torch, mods, state):
    """20 (a): examples/bench_decode.py's TPU configuration on phase 4's
    weights: GPT-medium bf16, prompt 32, 128 new tokens, top_k 50, batch
    1, 8 and 32: `generate` twice (compile_s: the first call, its two
    captures included), decode tokens/s and e2e ms a new token of the
    second, the device ms of one decode step (its graph replayed 127
    times under CUDA events) and that step's bound: the bytes of the
    weights and of the static cache over HBM bandwidth."""
    _, GPTForCausalLM, gpt_medium, load_state, _ = mods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    T, new, top_k = DECODE["prompt"], DECODE["new"], DECODE["top_k"]
    out = {}
    for B in DECODE["batches"]:
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T))).cuda()
        t = time.perf_counter()
        model.generate(ids, max_new_tokens=new, top_k=top_k).cpu()
        compile_s = time.perf_counter() - t
        t = time.perf_counter()
        toks = model.generate(ids, max_new_tokens=new, top_k=top_k).cpu()
        dt = time.perf_counter() - t
        check(toks.shape == (B, T + new) and torch.equal(toks[:, :T],
                                                         ids.cpu())
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"20 (a) batch {B}: tokens {toks.shape}")
        prog = model._gen_jit[(B, T, new, top_k, None)]
        graph = prog.graphs[1][0]
        prog.step.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(new - 1):
            graph.replay()
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / (new - 1)
        cache = 2 * prog.k.numel() * prog.k.element_size()
        bound_ms = (weights + cache) / HBM_BYTES_PER_S * 1e3
        out[B] = dict(compile_s=compile_s, tok_s=B * new / dt,
                      ms_per_token=dt / new * 1e3, step_ms=step_ms,
                      bound_ms=bound_ms)
        print(f"  (a) batch {B}: compile_s {compile_s:.2f} (the first "
              f"call, prefill and decode captured), decode_tok_per_s "
              f"{B * new / dt:.1f}, e2e_ms_per_new_token "
              f"{dt / new * 1e3:.3f}; one decode step {step_ms:.3f} device "
              f"ms (CUDA events over {new - 1} replays), bound "
              f"{bound_ms:.3f} ms ({weights / 1e6:.1f} MB of weights + "
              f"{cache / 1e6:.1f} MB of static cache over 3.35 TB/s), "
              f"{bound_ms / step_ms:.3f} of it", flush=True)
    check(len(model._gen_jit) == len(DECODE["batches"]),
          f"20 (a): {len(model._gen_jit)} program sets")
    del model
    torch.cuda.empty_cache()
    return out


def phase_bucketed(torch, km, mods, state, prompts):
    """20 (b): GenerationEngine(ragged=False), the legacy bucketed loop,
    against the ragged engine, each on phase 4's engine config, weights
    and prompts, all greedy, each warmed for every prompt length first:
    retraces 0 over the traffic; output tokens/s and
    pad_token_fraction() of each; the streams equal, or at a first
    mismatch both tokens within BF16_ULPS bf16 ulps of the largest
    logit (`bf16_rule`, the tier-1 tests' near-tie rule). Returns the
    ragged run's ragged_paged_attention launches."""
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    timed = same_shape_prompts(prompts, SEED + 2, cfg.vocab_size)
    runs = {}
    for label, kw in (("ragged", {}), ("bucketed", {"ragged": False})):
        eng = GenerationEngine(model, **SERVE, **kw)
        try:
            t = time.perf_counter()
            for n in sorted({p.size for p in prompts}):
                eng.warm(n, NEW_TOKENS)
            warm_s = time.perf_counter() - t
            warmed = eng.retraces
            # an untimed wave first, as phase 4's wave A: the ragged
            # engine's warm covers one request's schedule, and the
            # batches of several requests take (tokens, rows)
            # signatures of their own, captured inline here
            traffic(eng, prompts)
            first = eng.retraces - warmed
            zero_counts(km)
            _, streams, _, all_s = traffic(eng, timed)
            launches = counts(km)
            traced = eng.retraces - warmed - first
            check(label == "ragged" or first + traced == 0,
                  f"20 (b) {label}: traffic captured {first + traced}")
            check(all(len(st) == NEW_TOKENS for st in streams),
                  f"20 (b) {label}: stream lengths")
            runs[label] = dict(streams=streams, tok_s=len(prompts)
                               * NEW_TOKENS / all_s,
                               pad=eng.pad_token_fraction(),
                               launches=launches, steps=eng.steps)
            print(f"  (b) {label}: {warmed} signatures captured by warm in "
                  f"{warm_s:.2f}s, retraces over the untimed wave {first} "
                  f"and over the timed one {traced}; the timed wave: "
                  f"{runs[label]['tok_s']:.1f} output tokens/s "
                  f"({all_s:.3f}s, prefill included; {eng.steps} steps "
                  f"over both waves), "
                  f"pad_token_fraction {runs[label]['pad']:.4f}", flush=True)
        finally:
            eng.shutdown()
    bucketed_launches = {k: v for k, v in runs["bucketed"]["launches"].items()
                         if v}
    check(not bucketed_launches, f"20 (b): the bucketed loop launched "
                                 f"{bucketed_launches}")
    equal = first_mismatches(torch, model, timed,
                             runs["bucketed"]["streams"],
                             runs["ragged"]["streams"], [None] * len(timed),
                             "20 (b) bucketed vs ragged", bf16_rule)
    print(f"  (b) streams equal: {equal}/{len(prompts)} (the rest excused "
          f"by the near-tie rule above)")
    del model
    torch.cuda.empty_cache()
    return runs["ragged"]["launches"]["ragged_paged_attention"]


def phase_inference_engine(torch):
    """20 (c): InferenceEngine over bench.py --serve's model (Linear(2048,
    2048), Tanh, Linear(2048, 2048), float32, TF32 off) with
    BucketLadder((1, 2, 4, 8)) warmed, 8 closed-loop client threads of
    40 requests [1, 2048] each: requests/s, p50 / p99 ms, mean batch,
    retraces 0 over the traffic; the serial baseline (the same model, one
    request at a time, each read back); every output within 1e-5
    relative of the serial one on the same input."""
    import threading
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.inference import BucketLadder, InferenceEngine
    paddle.set_device("gpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        paddle.seed(SEED)
        nn = paddle.nn
        model = nn.Sequential(nn.Linear(SERVE_DIM, SERVE_DIM), nn.Tanh(),
                              nn.Linear(SERVE_DIM, SERVE_DIM))
        rng = np.random.RandomState(SEED)
        xs = rng.randn(SERVE_CLIENTS, SERVE_REQS, 1, SERVE_DIM).astype(
            np.float32)
        with torch.no_grad():
            model(torch.from_numpy(xs[0, 0]).cuda()).cpu()  # warm cuBLAS
            serial = np.empty_like(xs)
            t = time.perf_counter()
            for c in range(SERVE_CLIENTS):
                for i in range(SERVE_REQS):
                    serial[c, i] = model(torch.from_numpy(
                        xs[c, i]).cuda()).cpu().numpy()
            serial_s = time.perf_counter() - t
        ladder = BucketLadder(SERVE_LADDER)
        eng = InferenceEngine(model, batch_sizes=ladder.batch_sizes)
        try:
            t = time.perf_counter()
            caps = eng.warm(xs[0, 0])
            warm_s = time.perf_counter() - t
            got = np.empty_like(xs)
            lat = [[] for _ in range(SERVE_CLIENTS)]

            def client(c):
                for i in range(SERVE_REQS):
                    t0 = time.perf_counter()
                    got[c, i] = eng.submit(xs[c, i]).result(timeout=300)
                    lat[c].append(time.perf_counter() - t0)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            check(eng.retraces == caps == len(SERVE_LADDER),
                  f"20 (c): {caps} captured by warm, retraces "
                  f"{eng.retraces}")
            batches, rows = eng.batches, eng.rows
        finally:
            eng.shutdown()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    n = SERVE_CLIENTS * SERVE_REQS
    check(rows == n, f"20 (c): {rows} rows served of {n}")
    rel = float(np.abs(got - serial).max() / np.abs(serial).max())
    check(rel <= 1e-5, f"20 (c): outputs {rel:.3g} from the serial ones")
    lat = np.sort(np.concatenate(lat)) * 1e3
    print(f"  (c) {SERVE_CLIENTS} clients x {SERVE_REQS} requests: "
          f"{n / wall:.1f} requests/s, p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms, mean batch "
          f"{rows / batches:.2f} ({batches} batches); warm captured {caps} "
          f"buckets in {warm_s:.2f}s, retraces over the traffic 0; serial "
          f"baseline {n / serial_s:.1f} requests/s "
          f"({serial_s / n * 1e3:.3f} ms a request); outputs within "
          f"{rel:.2g} relative of the serial ones (TF32 off)")


def phase_legacy_agreement(torch, mods, state):
    """20 (d): a 2-layer float32 GPT-medium (phase 5's weights), card
    against CPU, TF32 off: generate(top_k=1) on 4 prompts of 32, 32 new
    tokens, tokens equal (or at a first mismatch the CPU's top-2 logit
    gap at most GAP_LIMIT, phase 5's rule); paged_decode_step over three
    sequences of 40, 17 and 64 tokens, 8 decode steps padded to 4 rows,
    the CPU's tokens fed to both: logits within TOL float32 (phase 5's)."""
    _, GPTForCausalLM, gpt_medium, load_state, _ = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt_medium()
    cfg.num_layers = 2
    small = first_layers(state, cfg.num_layers)
    models = {}
    for device in ("cuda", "cpu"):
        models[device] = GPTForCausalLM(cfg, device=device)
        load_state(models[device], small)
    c = AGREE_DECODE
    rng = np.random.RandomState(SEED + 40)
    ids = rng.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]))
    gen = {d: m.generate(torch.from_numpy(ids).to(d), max_new_tokens=c["new"],
                         top_k=1).cpu().numpy()[:, c["prompt"]:].tolist()
           for d, m in models.items()}
    equal = first_mismatches(torch, models["cpu"], list(ids), gen["cuda"],
                             gen["cpu"], [None] * len(ids),
                             "20 (d) generate", gap_rule(GAP_LIMIT))
    print(f"  (d) generate(top_k=1): {equal}/{len(ids)} streams equal on "
          f"card and CPU")
    caches = {d: m.make_paged_cache(64, P) for d, m in models.items()}
    worst = 0.0
    sids = [f"s{i}" for i in range(len(c["lengths"]))]
    for sid, n in zip(sids, c["lengths"]):
        prompt = rng.randint(0, cfg.vocab_size, (1, n))
        outs = {}
        for d, m in models.items():
            caches[d].add_sequence(sid)
            outs[d] = m.paged_decode_step(
                caches[d], [sid], torch.from_numpy(prompt).to(d)).cpu()
        worst = max(worst, float((outs["cuda"] - outs["cpu"]).abs().max()))
    toks = torch.argmax(outs["cpu"], -1)[:, None].repeat(len(sids), 1)
    for _ in range(c["steps"]):
        outs = {d: m.paged_decode_step(caches[d], sids, toks.to(d),
                                       pad_to=4).cpu()
                for d, m in models.items()}
        worst = max(worst, float((outs["cuda"] - outs["cpu"]).abs().max()))
        toks = torch.argmax(outs["cpu"], -1)[:, None]
    check(worst <= TOL["torch.float32"], f"20 (d): paged_decode_step logits "
                                         f"{worst:.3g} apart")
    traces = models["cuda"]._paged_decode_traces
    print(f"  (d) paged_decode_step: prefill and {c['steps']} decode steps "
          f"(pad_to 4), logits card vs CPU within {worst:.3g} (limit "
          f"{TOL['torch.float32']}); {traces} decode signature(s) captured")


def phase_legacy_generation(torch, km, mods, state, prompts):
    """Phase 20: (a), (b), (c), (d). Returns (b)'s kernel launches."""
    t0 = time.perf_counter()
    print("  (a) examples/bench_decode.py: GPT-medium bf16 generate(), "
          "prompt 32, 128 new, top_k 50", flush=True)
    phase_generate(torch, mods, state)
    print("  (b) GenerationEngine(ragged=False) against the ragged engine, "
          "phase 4's config and prompts, greedy", flush=True)
    launches = phase_bucketed(torch, km, mods, state, prompts)
    print("  (c) InferenceEngine: bench.py --serve's MLP, BucketLadder"
          f"({SERVE_LADDER}), {SERVE_CLIENTS} client threads", flush=True)
    phase_inference_engine(torch)
    print("  (d) 2-layer float32 GPT: generate and paged_decode_step, card "
          "vs CPU", flush=True)
    phase_legacy_agreement(torch, mods, state)
    print(f"  phase 20 took {time.perf_counter() - t0:.1f}s")
    return launches



# phase 21: the serving front door. A pool of 512 pages of 16 for both
# topologies; the disaggregated pair (prefill engine, decode engine over
# one cache) against one engine of 8 slots
ROUTER_POOL = dict(n_pages=512, page_size=16)
ROUTER_SINGLE = dict(max_batch=8, prefill_chunk=32, max_new_tokens=NEW_TOKENS)
ROUTER_PAIR = dict(max_batch=4, prefill_batch=4, prefill_chunk=32)
SYSTEM_PROMPT = 64  # tokens the 8 extra requests share
# the open-loop trace (tools/load_harness.py `generate_trace`, the port's)
LOAD_TRACE = dict(n_requests=64, rate_rps=8.0, burst=(0.4, 0.7, 10.0),
                  prompt_mean=128.0, prompt_sigma=0.6, max_prompt=1024,
                  out_mean=32.0, out_sigma=0.5, max_out=128, vocab=50304)
LOAD_QUEUE = 8  # the pair's admission queue in 21 (b): the burst overflows


def pow2_upto(lo, hi):
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def warm_pair_signatures(model, cache, max_len):
    """Capture every (tokens, rows, width) signature a disaggregated pair
    of ROUTER_PAIR's shape can step through over `cache`, before its
    traffic: token buckets from MIN_Q_TOKENS to the prefill chunk (a
    prefill step carries at most a chunk; a decode step at most 4 rows),
    rows 1 to 4, table widths from 2 pages (the first chunk of a prompt
    of 32 or more) to the pages of `max_len` tokens. Returns (captured,
    seconds)."""
    from paddle_tpu_torch.ops.attention_core import MIN_Q_TOKENS
    t = time.perf_counter()
    chunk, rows = ROUTER_PAIR["prefill_chunk"], ROUTER_PAIR["max_batch"]
    widths = pow2_upto(2, 1 << (-(-max_len // P) - 1).bit_length())
    n = 0
    for T in pow2_upto(MIN_Q_TOKENS, chunk):
        for B in pow2_upto(1, rows):
            for W in widths:
                n += model.warm_ragged(cache, T, B, W)
    return n, time.perf_counter() - t


def timed_wave(server, prompts, new=NEW_TOKENS):
    """All `prompts` submitted at once to an engine or a router: (streams,
    seconds from the first submit to the last result, TTFTs sorted: each
    handle's first token handed to its stream less its submit, host
    stamps)."""
    t = time.perf_counter()
    hs = [server.submit(p, max_new_tokens=new) for p in prompts]
    streams = [h.result(timeout=900).tolist() for h in hs]
    return streams, time.perf_counter() - t, \
        sorted(h.t_first - h.t_submit for h in hs)


def pct(sorted_vals, p):
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(round(p / 100 * (len(sorted_vals) - 1))))]


def router_prompts(prompts, vocab):
    """Phase 4's 8 prompts and 8 sharing a 64-token system prompt."""
    rng = np.random.default_rng(SEED + 21)
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    return list(prompts) + [np.concatenate([system,
                                            rng.integers(0, vocab, n)])
                            for n in (8, 16, 24, 40, 56, 72, 96, 128)]


def spy_chains(cache):
    """Record each chain `cache` exports and check each adoption lands
    the very page ids exported (no copy). Returns (exported, adopted)
    lists the spies fill."""
    exported, adopted = [], []
    real_export, real_adopt = cache.export_chain, cache.adopt_chain

    def export(sid):
        chain = real_export(sid)
        exported.append(list(chain.pages))
        return chain

    def adopt(sid, chain):
        held = all(cache._ref.get(pg, 0) >= 1 for pg in chain.pages)
        n = real_adopt(sid, chain)
        adopted.append((list(cache._tables[sid]), held))
        return n

    cache.export_chain, cache.adopt_chain = export, adopt
    return exported, adopted


def phase_router_parity(torch, km, mods, state, prompts):
    """21 (a): the same 16 greedy requests through one GenerationEngine of
    8 slots and through a disaggregated pair (prefill_batch 4, max_batch
    4, prefill chunk 32) over one pool of the same size, GPT-medium bf16,
    prefix cache off (so both draw the same pages). The single engine
    runs the requests once untimed (its signatures captured inline); the
    pair (`ServingRouter.disaggregated`) has its cache warmed for every
    signature it can take, then `router.warm` runs for each prompt
    length. Held: streams equal or bf16 near-ties; one handoff a request,
    each adopted chain the exporter's page ids; pages drawn equal; no
    capture in the pair's run, and each engine's `retraces` no more than
    the warm's captures; #1 = (replays) x 24 there, nothing else.
    Returns (the model, #1's launches)."""
    from paddle_tpu_torch.inference import ServingRouter
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    cfg = gpt_medium()
    model = GPTForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    reqs = router_prompts(prompts, cfg.vocab_size)
    max_len = max(p.size for p in reqs) + NEW_TOKENS
    lengths = sorted({p.size for p in reqs})
    runs = {}

    single = GenerationEngine(model, **ROUTER_POOL, **ROUTER_SINGLE,
                              prefix_cache=False, name="single")
    try:
        timed_wave(single, reqs)  # untimed: its signatures captured inline
        before = single.retraces, single.cache.pool_stats()["pages_drawn"]
        streams, wall, ttft = timed_wave(single, reqs)
        runs["single"] = dict(streams=streams, wall=wall, ttft=ttft,
                              drawn=single.cache.pool_stats()["pages_drawn"]
                              - before[1],
                              retraces=single.retraces - before[0])
        print(f"  (a) one engine (8 slots): the untimed wave captured "
              f"{before[0]} signatures inline, the timed wave "
              f"{runs['single']['retraces']}", flush=True)
    finally:
        single.shutdown()
    del single
    torch.cuda.empty_cache()

    router = ServingRouter.disaggregated(
        model, **ROUTER_POOL, **ROUTER_PAIR, prefix_cache=False,
        max_new_tokens=NEW_TOKENS, name="pair", fleet_snapshot_s=1.0)
    pre, dec = router.engines
    cache = pre.cache
    try:
        built = model._ragged_traces
        caps, cap_s = warm_pair_signatures(model, cache, max_len)
        fresh = sum(router.warm(n, NEW_TOKENS) for n in lengths)
        exported, adopted = spy_chains(cache)
        traces = model._ragged_traces
        steps = pre.steps + dec.steps
        drawn = cache.pool_stats()["pages_drawn"]
        zero_counts(km)
        streams, wall, ttft = timed_wave(router, reqs)
        launches = counts(km)
        stats = cache.pool_stats()
        runs["pair"] = dict(streams=streams, wall=wall, ttft=ttft,
                            drawn=stats["pages_drawn"] - drawn)
        replays = pre.steps + dec.steps - steps
        captured = model._ragged_traces - traces
        routing = router.load_report()["routing"]
    finally:
        router.shutdown()
    del cache.export_chain, cache.adopt_chain  # the spies: back to the class
    # each engine folds every capture of the shared model since it was
    # built into `retraces`: the warm's, then any in the run
    warmed = traces - built
    retraces = pre.retraces - warmed, dec.retraces - warmed
    n = launches.pop("ragged_paged_attention")
    check(not any(launches.values()),
          f"21 (a): other kernels ran while the pair served: {launches}")
    print(f"  (a) the pair: {caps} signatures captured before its traffic "
          f"in {cap_s:.1f}s, router.warm captured {fresh} more; the timed "
          f"wave: {replays} graph replays ({pre.name} and {dec.name}), "
          f"captures {captured}, retraces after the warm {retraces[0]} / "
          f"{retraces[1]}, ragged_paged_attention launches {n}", flush=True)
    check(fresh == 0 and captured == 0 and retraces == (0, 0),
          f"21 (a): the pair captured {fresh} at warm and {captured} in "
          f"its run (retraces after the warm {retraces})")
    check(n == replays * cfg.num_layers,
          f"21 (a): #1 launches {n} != {replays} replays x "
          f"{cfg.num_layers}")
    check(routing["handoffs"] == len(reqs) == len(exported) == len(adopted),
          f"21 (a): {routing['handoffs']} handoffs, {len(exported)} "
          f"exported, {len(adopted)} adopted, {len(reqs)} requests")
    same = sorted(map(tuple, exported)) == sorted(tuple(t)
                                                  for t, _ in adopted)
    check(same and all(h for _, h in adopted),
          "21 (a): an adopted chain's pages are not the exported ones")
    check(stats["cow_copies"] == 0
          and runs["pair"]["drawn"] == runs["single"]["drawn"],
          f"21 (a): pages drawn {runs['pair']['drawn']} (pair) and "
          f"{runs['single']['drawn']} (one engine), "
          f"{stats['cow_copies']} copies")
    check(all(len(st) == NEW_TOKENS for r in runs.values()
              for st in r["streams"]), "21 (a): stream lengths")
    equal = first_mismatches(torch, model, reqs, runs["pair"]["streams"],
                             runs["single"]["streams"], [None] * len(reqs),
                             "21 (a) pair vs one engine", bf16_rule)
    print(f"  (a) streams equal: {equal}/{len(reqs)} (the rest excused "
          f"by the near-tie rule above); handoffs {routing['handoffs']} = "
          f"requests; every adopted chain holds the exporter's page ids; "
          f"pages drawn {runs['pair']['drawn']} in both topologies, 0 "
          f"copied")
    for label, r in runs.items():
        print(f"  (a) {label}: {len(reqs) / r['wall']:.2f} requests/s "
              f"({len(reqs) * NEW_TOKENS / r['wall']:.1f} output tokens/s, "
              f"{r['wall']:.3f}s), TTFT p50 {pct(r['ttft'], 50) * 1e3:.1f}"
              f" ms p99 {pct(r['ttft'], 99) * 1e3:.1f} ms", flush=True)
    return model, n


def phase_open_loop(torch, km, model):
    """21 (b): the port's tools/load_harness.py trace (LOAD_TRACE, seed 0)
    driven open-loop through a disaggregated pair of (a)'s shape with
    max_queue 8, its cache warmed for the trace's lengths first, the
    metrics JSONL written and checked by tools/check_metrics_schema.py.
    Returns #1's launches."""
    import subprocess
    import tempfile

    from paddle_tpu_torch.inference import ServingRouter
    from paddle_tpu_torch.profiler import mem_observatory
    from paddle_tpu_torch.tools.load_harness import (generate_trace,
                                                     run_harness)
    kw = dict(LOAD_TRACE)
    trace = generate_trace(SEED, kw.pop("n_requests"), **kw)
    max_len = max(r["prompt"].size + r["max_new"] for r in trace)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        os.environ["PADDLE_TPU_METRICS_FILE"] = path
        router = ServingRouter.disaggregated(
            model, **ROUTER_POOL, **ROUTER_PAIR, max_queue=LOAD_QUEUE,
            max_new_tokens=LOAD_TRACE["max_out"], name="load",
            fleet_snapshot_s=1.0)
        pre, dec = router.engines
        cache = pre.cache
        try:
            caps, cap_s = warm_pair_signatures(model, cache, max_len)
            traces, steps = model._ragged_traces, pre.steps + dec.steps
            zero_counts(km)
            summary = run_harness(router, trace, seed=SEED,
                                  burst=LOAD_TRACE["burst"])
            launches = counts(km)
            peaks = [e.kv_peak_occupancy() for e in router.engines]
            frag = mem_observatory.fragmentation(cache)
        finally:
            router.shutdown()
            del os.environ["PADDLE_TPU_METRICS_FILE"]
        with open(path) as f:
            kinds = {}
            for line in f:
                k = json.loads(line)["kind"]
                kinds[k] = kinds.get(k, 0) + 1
        lint = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools",
                "check_metrics_schema.py"), path],
            capture_output=True, text=True, timeout=300)
    replays = pre.steps + dec.steps - steps
    captured = model._ragged_traces - traces
    n = launches.pop("ragged_paged_attention")
    check(lint.returncode == 0,
          f"21 (b): the metrics JSONL fails the schema: "
          f"{(lint.stdout + lint.stderr)[-600:]}")
    check(not any(launches.values()),
          f"21 (b): other kernels ran: {launches}")
    check(n == (replays + captured) * model.cfg.num_layers,
          f"21 (b): #1 launches {n} != (replays {replays} + captures "
          f"{captured}) x {model.cfg.num_layers}")
    check(summary["requests"] == len(trace), "21 (b): requests offered")
    print(f"  (b) {caps} signatures captured before the trace in "
          f"{cap_s:.1f}s", flush=True)
    print(f"  (b) {len(trace)} requests over {trace[-1]['t']:.2f}s "
          f"({LOAD_TRACE['rate_rps']} req/s, x{LOAD_TRACE['burst'][2]} over "
          f"indices {LOAD_TRACE['burst'][0]}-{LOAD_TRACE['burst'][1]}), "
          f"max_queue {LOAD_QUEUE}: goodput "
          f"{summary['goodput_tokens_per_s']} tokens/s, attainment "
          f"{summary['attainment_by_class']}, TTFT p50 / p99 "
          f"{summary['ttft_p50_s'] * 1e3:.1f} / "
          f"{summary['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 / p99 "
          f"{summary['tpot_p50_s'] * 1e3:.2f} / "
          f"{summary['tpot_p99_s'] * 1e3:.2f} ms, rejected "
          f"{summary['rejected_fraction']}, expired "
          f"{summary['expired_fraction']}, peak in flight "
          f"{summary['peak_in_flight']}, pressure events "
          f"{summary.get('pressure_events')}, completed "
          f"{summary['completed']}, submit lateness p99 "
          f"{summary['submit_lateness_p99_s'] * 1e3:.2f} ms, "
          f"{summary['duration_s']:.2f}s", flush=True)
    print(f"  (b) phases {summary['phases']}; kv_peak_occupancy "
          f"{peaks[0]:.4f} (prefill engine) / {peaks[1]:.4f} (decode); "
          f"fragmentation at the end {frag['fragmentation']} "
          f"({frag['free_runs']} free runs, largest {frag['largest_free_run']}"
          f" of {frag['free_pages']}); {replays} replays, {captured} "
          f"captures, #1 launches {n}; metrics JSONL {kinds}: "
          f"{lint.stdout.strip()}", flush=True)
    return n


def phase_ssm_pair(torch, km, smods, prompts):
    """21 (c): phase 13's Mamba-130M-shaped SSM (bf16, numpy-seeded) as a
    disaggregated pair over one RecurrentStateCache (65 slots) against
    one engine: greedy streams equal or bf16 near-ties; one handoff a
    request; #11 = (replays + captures) x 24 over the pair's run, nothing
    else. Returns #11's launches."""
    from paddle_tpu_torch.inference import ServingRouter
    GenerationEngine, SSMConfig, SSMForCausalLM, load_state, _ = smods
    cfg = SSMConfig(**MAMBA_130M)
    model = SSMForCausalLM(cfg, dtype=torch.bfloat16)
    load_state(model, ssm_numpy_state(model, SEED))
    pool = dict(n_pages=SSM_SERVE["n_pages"], page_size=16)
    single = GenerationEngine(model, **pool, **ROUTER_SINGLE, name="ssm_one")
    try:
        want, wall_one, _ = timed_wave(single, prompts)
    finally:
        single.shutdown()
    router = ServingRouter.disaggregated(
        model, **pool, max_new_tokens=NEW_TOKENS, name="ssm_pair",
        **ROUTER_PAIR)
    pre, dec = router.engines
    try:
        traces, steps = model._ragged_traces, pre.steps + dec.steps
        zero_counts(km)
        got, wall, _ = timed_wave(router, prompts)
        launches = counts(km)
        handoffs = router.load_report()["routing"]["handoffs"]
        strategy = pre.cache_strategy
    finally:
        router.shutdown()
    replays = pre.steps + dec.steps - steps
    captured = model._ragged_traces - traces
    n = launches.pop(SCAN_KERNEL[0])
    check(strategy == "recurrent", f"21 (c): strategy {strategy}")
    check(not any(launches.values()), f"21 (c): other kernels ran: "
                                      f"{launches}")
    check(n > 0 and n == (replays + captured) * cfg.num_layers,
          f"21 (c): #11 launches {n} != (replays {replays} + captures "
          f"{captured}) x {cfg.num_layers}")
    check(handoffs == len(prompts), f"21 (c): {handoffs} handoffs")
    equal = first_mismatches(torch, model, prompts, got, want,
                             [None] * len(prompts), "21 (c) SSM pair vs "
                             "one engine", bf16_rule)
    print(f"  (c) SSM pair: streams equal {equal}/{len(prompts)} (the rest "
          f"excused above); handoffs {handoffs}, each moving one state "
          f"blob ({pre.cache.state_bytes_per_slot()} bytes); {replays} "
          f"replays + {captured} captures, ssm_scan launches {n}; "
          f"{len(prompts) / wall:.2f} requests/s (one engine "
          f"{len(prompts) / wall_one:.2f})", flush=True)
    del model
    torch.cuda.empty_cache()
    return n


def phase_front_door(torch, km, mods, smods, state, prompts):
    """Phase 21: (a), (b), (c). Returns (#1's launches, #11's)."""
    t0 = time.perf_counter()
    print("  (a) one engine against a disaggregated pair, GPT-medium bf16, "
          f"{len(prompts) + 8} greedy requests of {NEW_TOKENS} tokens",
          flush=True)
    model, paged = phase_router_parity(torch, km, mods, state, prompts)
    torch.cuda.empty_cache()
    print("  (b) the open-loop trace through a pair with max_queue "
          f"{LOAD_QUEUE}", flush=True)
    paged += phase_open_loop(torch, km, model)
    del model
    torch.cuda.empty_cache()
    print("  (c) the Mamba-130M-shaped SSM as a disaggregated pair",
          flush=True)
    scan = phase_ssm_pair(torch, km, smods, prompts)
    print(f"  phase 21 took {time.perf_counter() - t0:.1f}s")
    return paged, scan



# -- phase 22: the profiler on bench.py's stages -------------------------------

# (a): steps the Profiler covers (its scheduler: 1 closed, 1 ready, 4
# recorded), the probe's cadence, the steps timed with telemetry on and off
PROFILED = dict(steps=6, closed=1, ready=1, record=4, probe_every=2,
                cost_steps=12, cost_rounds=2)
TELEMETRY_COST_LIMIT = 0.02   # telemetry on vs off, relative ms a step
DEVICE_TIME_REL = 0.10        # the probe's device time vs the trace's
# a device kernel's name (substring) -> the wrapper whose launch it is;
# ln_bwd's finalize is the second CUDA launch of every #6 call
TRACE_KERNELS = {"flash_fwd": "flash_attention_fwd",
                 "flash_dq": "flash_attention_dq",
                 "flash_dkv": "flash_attention_dkv",
                 "ln_fwd": "layer_norm_fwd", "ln_bwd": "layer_norm_bwd",
                 "ln_finalize": "layer_norm_bwd",
                 "xent_fwd": "softmax_xent_fwd",
                 "xent_bwd": "softmax_xent_bwd",
                 "tree_update": "tree_update",
                 "paged_cc": "ragged_paged_attention"}
# (b): phase 4's prompts served one at a time, each warmed first
PROFILED_SERVE = dict(prompts=(2, 5), new=8)
# (c): the watchdog's timeout and the pause that must trip it
WATCHDOG = dict(timeout_s=0.5, pause_s=1.5, steps=8)
NAN_STEP = 3  # nan@train.step#k on the float drill's replayed steps


def trace_launches(prof_or_kernels):
    """{wrapper name: CUDA launches} in a device trace's kernels
    ({kernel name: (launches, µs)}), by TRACE_KERNELS."""
    out = {}
    for name, (n, _) in prof_or_kernels.items():
        for part, wrapper in TRACE_KERNELS.items():
            if part in name:
                out[wrapper] = out.get(wrapper, 0) + n
    return out


def trace_graph_launches(path, part):
    """A device trace file's kernels grouped by the launch that made them
    (their correlation id: one group a CUDA graph replay), in launch
    order: [(kernels named with `part`, all kernels)] (a diagnostic)."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("cat") == "kernel"]
    groups = {}
    for e in sorted(evs, key=lambda e: e["ts"]):
        g = groups.setdefault(e.get("args", {}).get("correlation"), [0, 0])
        g[0] += part in e.get("name", "")
        g[1] += 1
    return [tuple(g) for g in groups.values()]


def telemetry_env(on, metrics=None, probe_every=None):
    """The telemetry switches: on, the metrics file and the probe every
    `probe_every` steps (None: its default cadence, 16; memory and
    rankstat records at their defaults); off, every cadence 0 and no
    file."""
    probe = None if on and probe_every is None else \
        str(probe_every) if on else "0"
    env = {"PADDLE_TPU_METRICS_FILE": metrics if on else None,
           "PADDLE_TPU_DEVICE_TIME_EVERY": probe,
           "PADDLE_TPU_MEMORY_EVERY": None if on else "0",
           "PADDLE_TPU_RANKSTAT_EVERY": None if on else "0"}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@contextlib.contextmanager
def step_telemetry(api, on):
    """TrainStep's per-step telemetry as it ships (on), or skipped (off:
    jit/api.py's export_step_metrics a no-op), the baseline its cost is
    held against."""
    real = api.export_step_metrics
    if not on:
        api.export_step_metrics = lambda *a, **k: None
    try:
        yield
    finally:
        api.export_step_metrics = real


def ring_steps(torch, step, host, n):
    """n steps of bench.py's steady loop (bench.py:426): the batches
    through device_prefetch_iterator(depth=2, sharding_fn=
    step.input_sharding). Returns the losses (device tensors)."""
    from paddle_tpu_torch.io.device_prefetch import device_prefetch_iterator
    losses = []
    for ids, labels in device_prefetch_iterator(
            ((a, a) for a in host[:n]), depth=2,
            sharding_fn=step.input_sharding):
        losses.append(step(ids, labels))
    return losses


def check_fast_device_events(torch):
    """device_events (the Kineto events) against prof.events() on a
    small profile: the same device microseconds by name."""
    a = torch.randn(1024, 1024, device="cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    slow = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != EPILOGUE:
            slow[e.name] = slow.get(e.name, 0.0) + e.time_range.elapsed_us()
    fast = device_us_by_name(prof)
    check(fast.keys() == slow.keys() and all(
        abs(fast[k] - slow[k]) <= 1e-3 * max(1.0, slow[k]) for k in fast),
        f"22: the Kineto events' device times {fast} differ from "
        f"prof.events()' {slow}")


def profiler_bench(torch, km, tmods, state, cfg, out_dir):
    """22 (a): bench.py's steady stage on 7c's step (GPT-1.3B bf16, remat
    "dots", the chunked loss, bench.py's Momentum, both switches) fed
    through the prefetch ring, under Profiler(targets=[CPU, GPU],
    make_scheduler(closed=1, ready=1, record=4), export_chrome_tracing)
    opened before the step's first call (the capture runs under it), a
    RecordEvent around each step, the metrics JSONL on and the probe
    every 2 steps. Holds: losses bit-equal to the same steps run again
    from a snapshot_state taken before the first, without the Profiler
    and telemetry; the wrappers' launches 6 x 7c's per-step constants and
    the device trace's over the 4 recorded steps 4 x them; every JSONL
    record passes tools/check_metrics_schema.py, each probed step record
    carries step_time_device_s; device_time_summary()'s median within 10%
    of the trace's device ms a step; mem_report()'s params tag the step's
    parameter bytes exactly; ms a step with telemetry on within 2% of off
    (the Profiler closed; off skips export_step_metrics and the probe). Returns (the step, its launches, the
    measurements)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.jit import DeferredLoss
    from paddle_tpu_torch.jit import api as jit_api
    from paddle_tpu_torch.profiler import (dist_observatory, mem_observatory,
                                           monitor, statistic)
    P = profiler
    metrics = os.path.join(out_dir, "metrics.jsonl")
    os.environ["PADDLE_PROFILER_DIR"] = os.path.join(out_dir, "device")
    n = PROFILED["steps"]
    rng = np.random.RandomState(SEED + 40)
    host = [rng.randint(0, cfg.vocab_size, size=(BENCH_1P3B["batch"],
                                                 BENCH_1P3B["seq"])
                        ).astype(np.int32)
            for _ in range(n + PROFILED["cost_steps"])]
    with switches(True):
        model, step = bench_step(torch, tmods, state, cfg, "dots")
        snap = step.snapshot_state()
        telemetry_env(True, metrics, PROFILED["probe_every"])
        monitor.reset_metrics()
        statistic.reset_statistics()
        dist_observatory.reset()
        zero_counts(km)
        blocked0 = monitor.host_blocked_s()
        prof = P.Profiler(targets=[P.ProfilerTarget.CPU,
                                   P.ProfilerTarget.GPU],
                          scheduler=P.make_scheduler(
                              closed=PROFILED["closed"],
                              ready=PROFILED["ready"],
                              record=PROFILED["record"]),
                          on_trace_ready=P.export_chrome_tracing(
                              os.path.join(out_dir, "unified")))
        prof.start()
        losses = []
        first_rec = PROFILED["closed"] + PROFILED["ready"]
        from paddle_tpu_torch.io.device_prefetch import \
            device_prefetch_iterator
        for i, (ids, labels) in enumerate(device_prefetch_iterator(
                ((a, a) for a in host[:n]), depth=2,
                sharding_fn=step.input_sharding)):
            if i == first_rec:  # the previous (probed) step has finished
                t_rec = time.perf_counter()
            with P.RecordEvent("bench.step"):
                losses.append(step(ids, labels))
            if i + 1 < n:
                prof.step()
        DeferredLoss(losses[-1]).resolve()  # bench.py's one read
        rec_ms = (time.perf_counter() - t_rec) / (n - first_rec) * 1e3
        blocked = monitor.host_blocked_s() - blocked0
        prof.stop()
        launches = counts(km)
        kernels = prof.device_kernels()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = prof.summary()
        telemetry_env(False)
        probe = dist_observatory.device_time_summary()
        rep = mem_observatory.mem_report()
        param_bytes = sum(p.numel() * p.element_size()
                          for p in step.params.values())
        # the same steps again from the snapshot, no Profiler, no telemetry
        step.set_tree_state(snap["params"], snap["opt_state"])
        step._step_i = 0
        again = ring_steps(torch, step, host, n)
        a, b = torch.stack(losses), torch.stack(again)
        check(torch.isfinite(a).all() and torch.equal(a, b),
              f"22 (a): the profiled losses {a.tolist()} differ from the "
              f"same steps without telemetry {b.tolist()}")
        # telemetry's cost: the Profiler closed, on (as it ships: the
        # step records, the probe at its default cadence) vs off (no
        # export_step_metrics, every cadence 0), interleaved
        ms = {True: [], False: []}
        for _ in range(PROFILED["cost_rounds"]):
            for on in (False, True):
                telemetry_env(on, metrics)
                with step_telemetry(jit_api, on):
                    ring_steps(torch, step, host[n:], 2)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    ring_steps(torch, step, host[n:], PROFILED["cost_steps"])
                    torch.cuda.synchronize()
                ms[on].append((time.perf_counter() - t)
                              / PROFILED["cost_steps"] * 1e3)
        telemetry_env(False)
    rec_steps = PROFILED["record"]
    for name, per_step in BENCH_1P3B_LAUNCHES.items():
        check(launches[name] == n * per_step,
              f"22 (a): {name}: {launches[name]} launches, want {n} x "
              f"{per_step}")
    traced = trace_launches(kernels)
    want = {k: rec_steps * v for k, v in BENCH_1P3B_LAUNCHES.items() if v}
    want["layer_norm_bwd"] *= 2  # each call's kernel and its finalize
    got = {k: traced.get(k, 0) for k in want}
    check(got == want, f"22 (a): the device trace's launches over "
                       f"{rec_steps} recorded steps {got}, want {want}")
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    lint = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "check_metrics_schema.py"),
         metrics], capture_output=True, text=True, timeout=300)
    check(lint.returncode == 0, f"22 (a): the metrics JSONL fails the "
                                f"schema: {(lint.stdout + lint.stderr)[-600:]}")
    step_recs = [r for r in recs if r["kind"] == "step"]
    probed = [r["step"] for r in step_recs if "step_time_device_s" in r]
    want_probed = [i for i in range(2, n + 1) if i % PROFILED[
        "probe_every"] == 0]
    check(probed[:len(want_probed)] == want_probed,
          f"22 (a): probed step records {probed}, want {want_probed}")
    kinds = sorted({r["kind"] for r in recs})
    trace_ms = sum(us for _, us in kernels.values()) / rec_steps / 1e3
    check(probe.get("samples", 0) >= 1, f"22 (a): no device-time probe: "
                                        f"{probe}")
    probe_ms = probe["step_time_device_s"] * 1e3
    rel = abs(probe_ms - trace_ms) / trace_ms
    check(rel <= DEVICE_TIME_REL,
          f"22 (a): the probe's device ms a step {probe_ms:.3f} is {rel:.3f} "
          f"from the trace's {trace_ms:.3f}")
    check(rep["tags"].get("params") == param_bytes,
          f"22 (a): mem_report params {rep['tags'].get('params')}, the "
          f"step's parameter bytes {param_bytes}")
    on, off = np.mean(ms[True]), np.mean(ms[False])
    cost = (on - off) / off
    check(cost <= TELEMETRY_COST_LIMIT,
          f"22 (a): telemetry on {ms[True]} ms a step against off "
          f"{ms[False]}: {cost:+.4f} > {TELEMETRY_COST_LIMIT}")
    trace_bytes = sum(os.path.getsize(p) for p in prof.device_traces)
    unified = os.path.join(out_dir, "unified", "paddle_tpu_trace.rank0.json")
    print(f"  (a) {n} steps under the Profiler (the capture in its closed "
          f"step, steps 3-6 recorded): {rec_ms:.2f} ms a step recorded "
          f"(wall, steps 3-6 to the last loss's read), stop() "
          f"{prof.stop_s:.2f}s (the trace's flush), host_blocked_s "
          f"{blocked:.4f}; losses bit-equal to the same steps without "
          f"telemetry ({a[0].item():.6f} -> {a[-1].item():.6f})", flush=True)
    print(f"  (a) the device trace over {rec_steps} recorded steps: launches "
          f"{got} (= {rec_steps} x 7c's a step); {trace_ms:.3f} device ms "
          f"a step; the probe's median {probe_ms:.3f} ms over "
          f"{probe['samples']} samples (rel {rel:.4f}, limit "
          f"{DEVICE_TIME_REL}), MFU measured {probe['mfu_measured']:.4f}")
    print(f"  (a) trace files: device {trace_bytes / 2**20:.1f} MiB "
          f"({len(prof.device_traces)} file), unified host trace "
          f"{os.path.getsize(unified) / 2**10:.1f} KiB; metrics JSONL "
          f"{len(recs)} records ({', '.join(kinds)}) pass the schema, "
          f"probed steps {probed}; mem_report params {param_bytes} B "
          f"(attributed {rep['attributed_bytes']}, in use "
          f"{rep['device_bytes_in_use']})")
    print(f"  (a) telemetry's cost, the Profiler closed: on (step records, "
          f"the probe every 16) {[round(x, 3) for x in ms[True]]} ms a "
          f"step, off (no export_step_metrics, no probe) "
          f"{[round(x, 3) for x in ms[False]]}: {cost:+.4f} (limit "
          f"{TELEMETRY_COST_LIMIT})")
    print("  (a) the summary's head:\n    " + "\n    ".join(
        summary.splitlines()[:12]))
    del model
    return step, launches, dict(ms=rec_ms, trace_ms=trace_ms,
                                probe_ms=probe_ms, cost=cost)


def profiler_serve(torch, km, mods, state, prompts):
    """22 (b): phase 4's GPT-medium bf16 engine under the Profiler (every
    step recorded, one window): PROFILED_SERVE's prompts, each warmed
    (`engine.warm`) and then served alone, so no step captures. Holds:
    the serve.batch spans = the engine's steps, the trace's #1 launches =
    (replays + captures) x 24 with captures 0, retraces 0 over the wave.
    Returns #1's launches (the wrappers' count)."""
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.profiler import statistic
    GenerationEngine, GPTForCausalLM, gpt_medium, load_state, _ = mods
    model = GPTForCausalLM(gpt_medium(), dtype=torch.bfloat16)
    load_state(model, state)
    eng = GenerationEngine(model, **SERVE)
    picks = [prompts[i] for i in PROFILED_SERVE["prompts"]]
    try:
        for p in picks:
            eng.warm(len(p), PROFILED_SERVE["new"])
        traces, steps = eng.retraces, eng.steps
        spans0 = sum(r["count"] for r in statistic.get_events("serve.batch"))
        zero_counts(km)
        prof = P.Profiler(targets=[P.ProfilerTarget.CPU,
                                   P.ProfilerTarget.GPU])
        prof.start()
        t = time.perf_counter()
        for p in picks:
            eng.submit(p, max_new_tokens=PROFILED_SERVE["new"]).result(300)
        wave_s = time.perf_counter() - t
        prof.stop()
        n1 = counts(km)["ragged_paged_attention"]
        retraces, served = eng.retraces - traces, eng.steps - steps
    finally:
        eng.shutdown()
    spans = sum(r["count"] for r in statistic.get_events("serve.batch")) \
        - spans0
    traced = trace_launches(prof.device_kernels()).get(
        "ragged_paged_attention", 0)
    L = model.cfg.num_layers
    if traced != served * L:  # which launches the trace lacks
        print(f"  (b) (#1, all kernels) in the device trace by launch: "
              f"{trace_graph_launches(prof.device_traces[-1], 'paged_cc')}",
              flush=True)
    check(retraces == 0, f"22 (b): {retraces} captures in the wave")
    check(spans == served, f"22 (b): {spans} serve.batch spans, {served} "
                           f"engine steps")
    check(traced == n1 == served * L,
          f"22 (b): #1 launches in the trace {traced}, counted {n1}, want "
          f"(replays {served} + captures 0) x {L}")
    print(f"  (b) {len(picks)} requests x {PROFILED_SERVE['new']} tokens, "
          f"one at a time after engine.warm: {served} steps in "
          f"{wave_s:.2f}s under the Profiler (its first window), {spans} "
          f"serve.batch spans, #1 {traced} launches in the device trace "
          f"(= {served} x {L}), retraces 0, stop() {prof.stop_s:.2f}s",
          flush=True)
    del model
    return n1


def float_drill(torch, TrainStep, monitor_health=True, loss=None):
    """A float regression's TrainStep on the card (Linear(64, 8), SGD):
    the fault drills' model (nan@train.step poisons a float batch)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import SGD
    torch.manual_seed(SEED)
    net = nn.Linear(64, 8)
    step = TrainStep(net, loss or (lambda out, y: ((out - y) ** 2).mean()),
                     SGD(learning_rate=0.01, parameters=net.parameters()),
                     monitor_health=monitor_health)
    rng = np.random.RandomState(SEED + 41)
    batches = [(torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda(),
                torch.from_numpy(rng.randn(32, 8).astype(np.float32)).cuda())
               for _ in range(6)]
    return step, batches


def profiler_forensics(torch, tmods, bench, out_dir):
    """22 (c): after (a), a dump's bundle (the ring's step records, the
    text of each registered program still alive, mem_state.json), and a
    dump makes no allocation; a Watchdog (0.5 s) that stays quiet over replayed steps
    and fires once in a 1.5 s pause; dumps from another thread and a
    SIGQUIT dump on the capturing thread while a TrainStep captures,
    the capture valid (its replay equals the eager body, retraces 1);
    nan@train.step#3 on replayed steps (the poison copied into the
    static batch buffer: retraces stays 1, the health vector flags step
    3 first); oom@train.step raising DeviceOOMError naming its site with
    a device_oom event; FLAGS_check_nan_inf on an eager op on the card
    recording the reference's nan_detected event."""
    import signal
    import threading
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import fault_injection
    from paddle_tpu_torch.profiler import flight_recorder, mem_observatory
    TrainStep = tmods[3]
    base = os.path.join(out_dir, "bundles")
    stats = torch.cuda.memory_stats()
    d = flight_recorder.dump("after_bench", base_dir=base)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] \
        - stats["allocation.all.allocated"]
    check(d is not None and allocs == 0,
          f"22 (c): the dump {d} made {allocs} allocations")
    files = sorted(os.listdir(d))
    ring = json.load(open(os.path.join(d, "ring.json")))
    mani = json.load(open(os.path.join(d, "MANIFEST.json")))
    hlo = sorted(os.listdir(os.path.join(d, "hlo")))
    mem = json.load(open(os.path.join(d, "mem_state.json")))
    check(any(r.get("kind") == "step" for r in ring["records"])
          and "train.step" in mani["hlo"]
          and sorted(mani["hlo"]) == sorted(ring["executables"])
          and all(f"{t}.txt" in hlo for t in mani["hlo"])
          and "params" in mem["ledger"],
          f"22 (c): bundle {files}, hlo {hlo}, manifest {mani.get('hlo')}, "
          f"live programs {ring['executables']}")
    text = open(os.path.join(d, "hlo", "train.step.txt")).read()
    check("tree_update" in text, f"22 (c): train.step.txt: {text[:300]}")
    print(f"  (c) dump after (a): {files}; programs {mani['hlo']}; "
          f"{sum(r.get('kind') == 'step' for r in ring['records'])} step "
          f"records in the ring; no allocation", flush=True)
    # the watchdog: quiet over steps, one expiry in a pause
    step, batches = float_drill(torch, TrainStep)
    step(*batches[0])  # the capture
    wd = flight_recorder.Watchdog(WATCHDOG["timeout_s"],
                                  base_dir=base).start()
    try:
        for i in range(WATCHDOG["steps"]):
            step(*batches[i % len(batches)])
            torch.cuda.synchronize()
            time.sleep(WATCHDOG["timeout_s"] / 5)
        quiet = not wd.fired
        time.sleep(WATCHDOG["pause_s"])
        fired = wd.fired
    finally:
        wd.stop()
    expired = [e for e in flight_recorder.snapshot()["events"]
               if e["event"] == "watchdog_expired"]
    check(quiet and fired and len(expired) == 1,
          f"22 (c): watchdog quiet over steps {quiet}, fired in the pause "
          f"{fired}, expiries {len(expired)}")
    print(f"  (c) Watchdog({WATCHDOG['timeout_s']}s): quiet over "
          f"{WATCHDOG['steps']} replayed steps, one expiry in a "
          f"{WATCHDOG['pause_s']}s pause (hang_s "
          f"{expired[0]['hang_s']})", flush=True)
    # dumps while a TrainStep captures: another thread's, and SIGQUIT's
    # (the handler runs on the capturing thread, inside the capture: the
    # loss sends the signal when it runs under capture)
    saved = (os.environ.get("PADDLE_TPU_DEBUG_DUMP"), sys.excepthook,
             threading.excepthook, signal.getsignal(signal.SIGQUIT),
             signal.getsignal(signal.SIGTERM))
    flight_recorder.install(base_dir=base)
    sent = []

    def loss(out, y):
        if torch.cuda.is_current_stream_capturing() and not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGQUIT)
        return ((out - y) ** 2).mean()

    step, batches = float_drill(torch, TrainStep, loss=loss)
    stop = threading.Event()
    dumps = []

    def dumper():
        while True:
            dumps.append(flight_recorder.dump("during_capture"))
            if stop.wait(0.02):
                return

    th = threading.Thread(target=dumper)
    th.start()
    try:
        step(*batches[0])
    finally:
        stop.set()
        th.join()
        env, sys.excepthook, threading.excepthook, quit_h, term_h = saved
        signal.signal(signal.SIGQUIT, quit_h)
        signal.signal(signal.SIGTERM, term_h)
        if env is None:
            del os.environ["PADDLE_TPU_DEBUG_DUMP"]
        else:
            os.environ["PADDLE_TPU_DEBUG_DUMP"] = env
    snap = step.snapshot_state()
    i0 = step._step_i
    replayed = step(*batches[1])
    step.set_tree_state(snap["params"], snap["opt_state"])
    step._step_i = i0
    eager = step._eager_call(*batches[1])
    sig = os.path.exists(os.path.join(base, "sigquit", "MANIFEST.json"))
    check(step.retraces == 1 and torch.equal(replayed, eager) and sent
          and sig and all(dumps) and len(dumps) >= 1,
          f"22 (c): the capture under dumps: retraces {step.retraces}, "
          f"replay {replayed.item()} vs eager {eager.item()}, SIGQUIT sent "
          f"{bool(sent)}, its bundle {sig}, dumps {len(dumps)}")
    print(f"  (c) a capture under {len(dumps)} dumps from another thread and "
          f"a SIGQUIT dump on its own thread: valid (replay bit-equal to "
          f"the eager body, retraces 1)", flush=True)
    # nan@train.step#k on replayed steps
    step, batches = float_drill(torch, TrainStep)
    fault_injection.configure(f"nan@train.step#{NAN_STEP}")
    try:
        for x, y in batches[:NAN_STEP + 1]:
            step(x, y)
    finally:
        fault_injection.configure("")
    step.flush_health()
    finite = [bool(np.isfinite(h["loss"])) for h in step.health_log]
    check(step.retraces == 1 and finite[:NAN_STEP - 1] == [True] * (
        NAN_STEP - 1) and not finite[NAN_STEP - 1]
        and step.health_log[NAN_STEP - 1]["found_inf"] == 1.0,
        f"22 (c): nan@train.step#{NAN_STEP}: retraces {step.retraces}, "
        f"finite {finite}, health {step.health_log[NAN_STEP - 1]}")
    print(f"  (c) nan@train.step#{NAN_STEP} on replayed steps: retraces 1, "
          f"the health vector flags step {NAN_STEP} first (finite "
          f"{finite})", flush=True)
    # oom@train.step, its bundle under `base`
    fault_injection.configure("oom@train.step#2")
    os.environ["PADDLE_TPU_DEBUG_DUMP"] = base
    try:
        step(*batches[0])
        err = None
        try:
            step(*batches[1])
        except mem_observatory.DeviceOOMError as e:
            err = e
    finally:
        fault_injection.configure("")
        if saved[0] is None:
            del os.environ["PADDLE_TPU_DEBUG_DUMP"]
        else:
            os.environ["PADDLE_TPU_DEBUG_DUMP"] = saved[0]
    ev = [e for e in flight_recorder.snapshot()["events"]
          if e["event"] == "device_oom"]
    check(err is not None and err.site == "train.step"
          and err.requested_bytes == 8 << 30 and ev
          and ev[-1]["site"] == "train.step" and err.bundle_dir
          and os.path.exists(os.path.join(err.bundle_dir, "mem_state.json")),
          f"22 (c): oom@train.step: {err!r}, events {ev}")
    print(f"  (c) oom@train.step#2: {type(err).__name__} at "
          f"{err.site}, requested {err.requested_bytes} B, top holders "
          f"{err.top_holders}, a device_oom event and bundle "
          f"{err.bundle_dir}", flush=True)
    # FLAGS_check_nan_inf on an eager op on the card
    flight_recorder.reset()
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = paddle.to_tensor(np.array([-1.0, 4.0], np.float32),
                             place="gpu")
        raised = False
        try:
            paddle.log(x)
        except FloatingPointError:
            raised = True
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    ev = [{k: v for k, v in e.items() if k != "ts"}
          for e in flight_recorder.snapshot()["events"]
          if e["event"] == "nan_detected"]
    want = [{"event": "nan_detected", "op": "log", "n_nan": 1, "n_inf": 0,
             "where": "eager"}]
    check(raised and ev == want, f"22 (c): FLAGS_check_nan_inf on the "
                                 f"card: raised {raised}, events {ev}")
    print(f"  (c) FLAGS_check_nan_inf: paddle.log of a negative on the card "
          f"raises FloatingPointError, event {ev[0]}", flush=True)


def phase_profiler(torch, km, tmods, mods, state_1p3b, cfg_1p3b, state,
                   prompts):
    """Phase 22: the profiler on bench.py's stages, (a)-(c) above, its
    files (traces, metrics, bundles) under build/phase22. Returns the
    launches to add to the kernels line ((a)'s wrappers' and (b)'s
    #1)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase22")
    os.makedirs(out_dir, exist_ok=True)
    step, launches, _ = profiler_bench(torch, km, tmods, state_1p3b,
                                       cfg_1p3b, out_dir)
    launches = dict(launches)
    launches["ragged_paged_attention"] = profiler_serve(torch, km, mods,
                                                        state, prompts)
    profiler_forensics(torch, tmods, step, out_dir)
    del step
    torch.cuda.empty_cache()
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_1p3b,
                                         gpt_medium, load_paddle_tpu_state)
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_update as fu
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_update as fk
    from paddle_tpu_torch.ops.kernels import layer_norm as lk
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import softmax_xent as xk
    from paddle_tpu_torch.ops.kernels import ssm_scan as sk
    from paddle_tpu_torch.ops.kernels import stochastic_round as srk
    from paddle_tpu_torch.ops.kernels import tree_update as tk
    from paddle_tpu_torch.models import SSMConfig, SSMForCausalLM
    from paddle_tpu_torch.models import ssm as ssm_mod
    from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum
    mods = (GenerationEngine, GPTForCausalLM, gpt_medium,
            load_paddle_tpu_state, gpt_mod)
    tmods = (GPTForCausalLM, gpt_medium, load_paddle_tpu_state, TrainStep,
             AdamW, F)
    smods = (GenerationEngine, SSMConfig, SSMForCausalLM,
             load_paddle_tpu_state, ssm_mod)
    km = (fa, pa, fk, lk, xk, sk, srk, tk)
    t_start = time.perf_counter()
    marks = []  # (phase, seconds since the start) as each phase begins

    def mark(phase):
        marks.append((phase, time.perf_counter() - t_start))
        print(f"  ({phase} starts at {marks[-1][1]:.1f}s)", flush=True)

    card = card_line()
    mark("1")
    print(f"[1] card: {card}", flush=True)

    mark("2")
    t = time.perf_counter()
    # the CPU halves of phases 5 and 14 need no card: they run beside the
    # build, whose nvcc processes leave most cores idle after the first
    # ~20 s (one compile, flash_attention.cu, takes the rest)
    halves = Background(lambda: (
        agreement_cpu_half(torch, pa, mods),
        ssm_agreement_cpu_half(torch, km, smods,
                               make_prompts(gpt_medium().vocab_size))))
    logs = _build.build()
    print(f"[2] built {sorted(logs)} in {time.perf_counter() - t:.1f}s")
    phase_registers(logs, ln_main_labels(lk), scan_main_labels(sk))
    gpt_half, ssm_halves = halves.result()
    print(f"  the CPU halves of phases 5 and 14 (served beside the build) "
          f"done at {time.perf_counter() - t:.1f}s", flush=True)
    check_fast_device_events(torch)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    mark("3")
    print("[3] ragged paged attention: kernel vs plain twin", flush=True)
    phase_kernel(torch, pa, flush)

    mark("4")
    print("[4] GPT-medium bf16 through GenerationEngine", flush=True)
    zero_counts(km)
    with switches(False):
        launches, held, prompts, state, model = phase_serve(
            torch, pa, flush, km, mods)
    served = {k: v for k, v in counts(km).items()
              if k != "ragged_paged_attention"}
    check(not any(served.values()),
          f"other kernels ran while serving GPT: {served}")

    mark("4b")
    print(f"[4b] GPT-medium bf16, speculative: a {DRAFT_LAYERS}-layer "
          f"self-draft, k = {SPEC_K}", flush=True)
    with switches(False):
        phase_speculative(torch, pa, mods, model, state, prompts)
    del model
    torch.cuda.empty_cache()

    mark("5")
    print("[5] 2-layer float32: card vs CPU greedy and sampled streams",
          flush=True)
    phase_agreement(torch, pa, mods, prompts, state, gpt_half)

    mark("6")
    print("[6] flash attention: kernels vs plain twins", flush=True)
    flash_main = phase_flash(torch, fa, flush)

    mark("7")
    print("[7] GPT-medium bf16 through TrainStep: the default (fused) "
          "epilogue, fused_update=False, then the default epilogue with "
          "PADDLE_TPU_PALLAS_LN=1 and PADDLE_TPU_PALLAS_XENT=1", flush=True)
    captured = {}
    train_main, _, train_switched, train_bf16_state, train_k2 = phase_train(
        torch, km, tmods, state, captured)
    mark("7 (cont.)")
    print("[7] (cont.) run_steps(4) against 4 calls, accumulate(2) against "
          "the whole batch, on the switched route", flush=True)
    phase_train_flavors(torch, km, tmods, state)
    mark("7d")
    print("[7d] captured train steps: replays against the eager body, "
          "bit for bit; eager against replayed wall and device ms",
          flush=True)
    with switches(False):
        captured_main = phase_captured(torch, km, tmods, state)
    mark("6 (cont.)")
    print("[6] (cont.) flash forward, dQ and dK/dV: kernels vs plain twins "
          "on layer 0's inputs of the first phase-7 training step",
          flush=True)
    for name, err in hold_flash_captured(
            torch, fa, captured, gpt_medium().num_layers).items():
        flash_main[64][name]["max_abs_err"] = max(
            flash_main[64][name]["max_abs_err"], err)

    mark("7b")
    print("[7b] GPT-1.3B bf16 (head_dim 128) through TrainStep with "
          "PADDLE_TPU_PALLAS_LN=1 and PADDLE_TPU_PALLAS_XENT=1; then 2 of its "
          "layers in float32, card vs CPU", flush=True)
    train_1p3b, train_1p3b_sr, bench, state_1p3b, cfg_1p3b = \
        phase_train_1p3b(torch, km, tmods, gpt_1p3b)

    mark("8")
    print("[8] 2-layer float32 training: card vs CPU, each epilogue, and "
          "the LayerNorm and xent kernels switched on; the eager loop, Lamb "
          "and bf16 moments", flush=True)
    phase_train_agreement(torch, km, tmods, state)
    phase_optimizer_agreement(torch, km, tmods, state)
    phase_flavor_agreement(torch, km, tmods, state)

    mark("9")
    print("[9] fused epilogue: kernels vs plain twins", flush=True)
    fused_main = phase_fused(torch, fk, fu, (SGD, Momentum, AdamW), tmods,
                             flush)

    mark("9b")
    print("[9b] the tree update and stochastic rounding (K2): kernels vs "
          "plain twins", flush=True)
    tree_main = phase_tree_update(torch, tk, tmods, gpt_1p3b, flush)
    sr_main = phase_stochastic_round(torch, srk, flush)

    mark("10")
    print("[10] GradScaler on the card: a non-finite step is skipped (in "
          "TrainStep on each epilogue, and around the eager step)",
          flush=True)
    phase_scaler(torch, km, tmods, state)
    phase_eager_scaler(torch, tmods, state)

    mark("11")
    print("[11] LayerNorm and softmax cross-entropy: kernels vs plain twins",
          flush=True)
    norm_xent = phase_norm_xent(torch, lk, xk, flush)
    phase_chunked_xent(torch, xk, flush)

    mark("12")
    floor_ms = cuda_ms(torch, lambda: torch.cuda._sleep(0), 20, flush)
    print(f"[12] selective scan: kernel vs plain twin (the timing's floor, "
          f"an empty kernel timed the same way: {floor_ms:.5f} ms)",
          flush=True)
    scan_cases = phase_scan(torch, sk, flush)

    mark("13")
    print("[13] Mamba-130M-shaped SSM bf16 through GenerationEngine",
          flush=True)
    scan_launches, scan_held = phase_ssm_serve(torch, sk, flush, km,
                                               smods)

    mark("14")
    print("[14] 2-layer float32 SSM, pure and hybrid: card vs CPU greedy "
          "and sampled "
          "streams", flush=True)
    phase_ssm_agreement(torch, km, smods, prompts, ssm_halves)

    mark("15")
    print("[15] the Paddle dygraph surface: GPT-medium bf16 as a Layer "
          "through the eager loop and TrainStep, save / load, a user "
          "Layer card vs CPU, host cost", flush=True)
    phase_dygraph(torch, km, state, train_main)

    mark("16")
    print("[16] examples/bench_bert.py's ERNIE-base MLM step: TrainStep in "
          "bf16, the AMP eager loop (O1 bf16, O2 bf16, O1 fp16), card vs "
          "CPU, the float16 flash kernels", flush=True)
    bert = phase_bert(torch, km, fa, flush)

    mark("17")
    print("[17] examples/train_vision_hapi.py's ResNet-50 through "
          "Model.fit / evaluate (CIFAR-10's shape, float32), its TrainStep "
          "at ImageNet's shape (float32, O1 bf16), the eager loop, "
          "ResNet-18 card vs CPU, a replay against its eager body",
          flush=True)
    vision = phase_vision(torch, km)

    mark("18")
    print("[18] the recurrent slice: Transformer-base seq2seq (TrainStep on "
          "the default route and with PADDLE_TPU_PALLAS_LN=1 and "
          "PADDLE_TPU_PALLAS_XENT=1, greedy decode), an LSTM seq2seq with "
          "attention (TrainStep, beam search), GRU / SimpleRNN and the "
          "device queries", flush=True)
    phase_seq2seq(torch, km, card)

    mark("19")
    print("[19] the data path: (a) phase 17's ResNet-50 fit through "
          f"DataLoader(num_workers={DATA_PATH['workers']}, "
          f"prefetch_to_device={DATA_PATH['depth']}); (b) bench.py's "
          "steady loop on 7c's step through device_prefetch_iterator",
          flush=True)
    data_path = phase_data_path(torch, km, vision["cifar"])
    prefetch_loop = phase_prefetch_loop(torch, km, tmods, state_1p3b,
                                        cfg_1p3b, bench["dots"])

    mark("20")
    print("[20] the legacy generation path: static-cache generate, the "
          "bucketed GenerationEngine, InferenceEngine, card vs CPU",
          flush=True)
    legacy_launches = phase_legacy_generation(torch, km, mods, state,
                                              prompts)

    mark("21")
    print("[21] the serving front door: one engine against a "
          "disaggregated pair (ServingRouter), the open-loop load trace, "
          "the SSM pair", flush=True)
    router_launches, router_scan = phase_front_door(torch, km, mods, smods,
                                                    state, prompts)

    mark("22")
    print("[22] the profiler on bench.py's stages: (a) 7c's steady loop "
          "through the prefetch ring under Profiler + RecordEvent, the "
          "metrics JSONL and the device-time probe; (b) GPT-medium served "
          "under the Profiler; (c) forensics: a debug bundle, the "
          "watchdog, dumps during a capture, nan / oom faults, "
          "FLAGS_check_nan_inf", flush=True)
    profiled = phase_profiler(torch, km, tmods, mods, state_1p3b, cfg_1p3b,
                              state, prompts)
    del state_1p3b
    # the new phases' launches, added to the main paths' counts
    extra = {"ragged_paged_attention": legacy_launches + router_launches
             + profiled["ragged_paged_attention"],
             "fused_pass2": data_path["launches"]["fused_pass2"]}
    extra.update({name + "_d128": prefetch_loop["launches"][name]
                  + profiled[name] for name, _ in FLASH_KERNELS})
    extra.update({name: prefetch_loop["launches"][name] + profiled[name]
                  for name, _ in NORM_KERNELS + XENT_KERNELS})
    extra[TREE_KERNEL[0]] = prefetch_loop["launches"][TREE_KERNEL[0]] \
        + profiled[TREE_KERNEL[0]]

    main_step = held["decode"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:128",
        "launches": launches + extra["ragged_paged_attention"],
        "max_abs_err": max(h["max_abs_err"] for h in held.values()),
        "ms": main_step["ms"],
        "plain_ms": main_step["plain_ms"],
        "bound_ms": main_step["bound_ms"],
        "bound_by": main_step["bound_by"],
        "library_ms": main_step["library_ms"],
    }]
    # each flash kernel twice: head_dim 64 (GPT-medium's main path) and
    # head_dim 128 (GPT-1.3B's, "_d128")
    for (name, replaces), source, meas, run, suffix in (
            [(k, "paddle_tpu_torch/csrc/flash_attention.cu", flash_main[64],
              train_main, "") for k in FLASH_KERNELS]
            + [(k, "paddle_tpu_torch/csrc/flash_attention.cu",
                flash_main[128], train_1p3b, "_d128") for k in FLASH_KERNELS]
            + [(k, "paddle_tpu_torch/csrc/flash_attention.cu",
                bert["flash_f16"], {"launches": bert["f16_launches"]},
                "_f16") for k in FLASH_KERNELS]
            + [(k, "paddle_tpu_torch/csrc/fused_update.cu", fused_main,
                train_main, "") for k in FUSED_KERNELS]
            + [(k, "paddle_tpu_torch/csrc/layer_norm.cu", norm_xent,
                train_switched, "") for k in NORM_KERNELS]
            + [(k, "paddle_tpu_torch/csrc/softmax_xent.cu", norm_xent,
                bench["dots"], "") for k in XENT_KERNELS]):
        m = meas[name]
        kernels.append({
            "name": name + suffix, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name]
            + extra.get(name + suffix, 0),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    # kernel #10's bf16-moment variant (launches: phase 7's scheduled
    # bf16-state run), the tree update (launches: phase 7b's
    # bench-optimizer run) and K2 (launches: phase 7's Adamax run)
    for name, source, replaces, meas, launches in (
            ("fused_pass2_bf16_state", "paddle_tpu_torch/csrc/fused_update.cu",
             FUSED_KERNELS[1][1], fused_main["fused_pass2_bf16_state"],
             train_bf16_state["launches"]["fused_pass2"]),
            (TREE_KERNEL[0], "paddle_tpu_torch/csrc/tree_update.cu",
             TREE_KERNEL[1], tree_main,
             train_1p3b_sr["launches"][TREE_KERNEL[0]]
             + extra[TREE_KERNEL[0]]),
            (SR_KERNEL[0], "paddle_tpu_torch/csrc/stochastic_round.cu",
             SR_KERNEL[1], sr_main, train_k2["launches"][SR_KERNEL[0]])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": meas["max_abs_err"], "ms": meas["ms"],
            "plain_ms": meas["plain_ms"], "bound_ms": meas["bound_ms"],
            "bound_by": meas["bound_by"], "library_ms": meas["library_ms"]})
    scan_main = scan_held["decode"]
    kernels.append({
        "name": SCAN_KERNEL[0], "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ssm_scan.cu",
        "replaces": SCAN_KERNEL[1],
        "launches": scan_launches + router_scan,
        "max_abs_err": max(m["max_abs_err"] for m in
                           scan_cases + list(scan_held.values())),
        "ms": scan_main["ms"], "plain_ms": scan_main["plain_ms"],
        "bound_ms": scan_main["bound_ms"], "bound_by": scan_main["bound_by"],
        "library_ms": None})
    mark("end")
    print("  seconds a phase (from its start to the next's): " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])),
        flush=True)
    print(f"[23] done in {time.perf_counter() - t_start:.1f}s (the smoke's "
          f"run time); paged "
          f"attention times are of the served decode step's layer-0 call, "
          f"flash times of the training shapes [8, 1024, 16, 64] (and, "
          f"_d128, GPT-1.3B's [4, 1024, 16, 128]) causal bf16 (library: "
          f"SDPA forward for the forward kernel, SDPA backward, dq/dk/dv "
          f"together, for both backward kernels; launches of _d128 from the "
          f"GPT-1.3B run; _f16: the float16 kernels at ERNIE-base's "
          f"[32, 128, 12, 64] non-causal, SDPA in float16, launches from "
          f"phase 16's O1-float16 AMP run, errors the worst of its float16 "
          f"shapes), "
          f"fused epilogue times of the main path's passes on GPT-medium's "
          f"layout (library: torch._foreach_norm over the grad buckets, "
          f"torch._fused_adamw_ over the f32 master buckets), LayerNorm "
          f"times at [8192, 1024] bf16 (library: F.layer_norm forward, its "
          f"backward), xent times at a chunk of the chunked loss, "
          f"[2048, 50304] bf16 (library: F.cross_entropy(reduction='none') "
          f"forward, its backward); launches of #5-#6 from the switched "
          f"training run, of #7-#8 from phase 7c's remat \"dots\" run; "
          f"fused_pass2_bf16_state: #10 with bf16 moments on GPT-medium's "
          f"layout (AdamW, f32 masters; library: none), launches from the "
          f"scheduled bf16-state run; tree_update: GPT-1.3B's 292 leaves on "
          f"bench.py's optimizer (Momentum, bf16 velocity, stochastic "
          f"rounding; library: none), launches from the bench-optimizer "
          f"GPT-1.3B run; stochastic_round (K2): GPT-1.3B's wte "
          f"(103,022,592 elements; library: none), launches from phase 7's "
          f"Adamax + SR run; scan times of "
          f"the served SSM decode step's layer-0 call (library: none, no "
          f"single PyTorch call computes a selective scan); card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
