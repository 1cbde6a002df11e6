#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one (and when run outside the
repository, where ``src/repro_torch`` is missing). Phases, one line each
(or one line per case):

1. device  — card name and power limit (nvidia-smi).
2. build   — every CUDA kernel compiled from ``src/repro_torch/csrc``
             with one nvcc per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
             the serving path's shapes, with the tolerance stated: the
             fused W4A16 GEMM (bf16 at M = 1, 8, 32 and 256 and a K slice
             that is not a multiple of the ring's stage, and fp32 — the
             reduced configurations' dtype), paged attention (decode and the
             32-token chunk, both KV formats, partitions of 544, 272 and
             136 keys, -1 table entries at the tail and inside a live
             partition, a window that masks whole partitions, bf16 and
             fp16; and the speculative verify step's B = 8 rows of 5
             queries with padded rows, an inactive row and stale
             rejected-draft tags, only live queries held; the W4A16 GEMM
             also at its M = 40), and the rest of the paper's GEMM family
             in bf16 and
             fp32 at the four danube (K, N) pairs, M = 8 and 32, the
             planner's split_k and 1: the dense GEMM in both modes, the
             decoupled W4A16 pipeline whole and phase by phase, W8A16,
             and W4A8 (its quantize kernel's int8 activations and row
             scales bit-equal to the CPU's, its group sums exact), W4A8
             also at M = 1, 8, 32, 40 and 256, N = 144, groups 32, 64 and
             128, zero-points, split_k 1, 4 and 16, and rows at the
             quantizer's edges (all zero, ±amax, exact .5 ties); the
             dense GEMM and W8A16 also at M = 1 and 256 and at a ragged K;
             flash attention in bf16 and fp32 at
             danube's heads (32/8 of 80) for 4 x 2048 causal, 1 x 4608
             with the 4096 window biting, 2 x 96 unaligned, 64 queries over
             192 keys non-causal, D = 128 and 32, and the kernel's tile
             edges (Skv or a 100-token window ending mid-tile, 40 queries,
             q/k/v as strided views of a fused projection); the
             FlashAttention Function's gradients against autograd through
             the plain version; the expert-batched W4A16 kernel (one launch
             for an MoE layer's expert stack) at olmoe's (E = 64, 2048 ->
             1024 and 1024 -> 2048, M = 8 and 10) and mixtral's (E = 8,
             4096 -> 14336 and 14336 -> 4096, M = 2 and 10) shapes, the
             planned split_k, 1 and 2 into fp32 partials, one expert's
             rows all zero, and fp32; W8A16 batched at olmoe's shapes;
             the decoupled pipeline and W4A8 on olmoe's w_gate stack,
             expert by expert through their 2-D kernels.
4. serve   — the port's main path on its launcher's engine
             (``repro_torch.launch.serve``'s ``build``, driven through the
             engine's stepper with phase 6's trace windows): h2o-danube-1.8b
             at full width
             (24 layers, d_model 2560, 32/8 heads of 80, d_ff 6912, vocab
             32000, bf16), random weights from seed 0 quantized to
             w4a16_g128, 8 requests of 512 prompt + 32 generated tokens,
             8 slots, 8-token pages, 32-token prefill chunks, kv_fp16. Both
             kernels' launch counters must rise during that run. The same
             requests then run on the plain paths (``--strategy reference
             --attn-path gather``) to compare prefill logits and tokens.
             Then, at the same width, 12 of the 24 layers
             (``FAMILY_LAYERS``), with 8 requests of 128
             prompt + 16 generated tokens: ``--strategy decoupled``,
             ``--format w8a16_channel`` and ``--format w4a8_g128``, each
             against its plain GEMM path (``--strategy reference``,
             ``reference``, ``w4a8_xla``) with the path's kernels' counters
             rising, and ``--no-quant`` (dense bf16 weights, the FP16×FP16
             yardstick); the fused W4A16 path runs in that cell too. Each
             of those kernel runs traces 4 of its decode steps under
             ``torch.profiler`` (device time per decode step: decode steps
             are host-bound, so tok/s hides the GEMMs), every decode step
             launching the path's GEMM kernels 7 times a layer and paged
             attention once a layer.
5. timing  — CUDA-event medians of each kernel, its plain version and one
             PyTorch library call for the same function, with the L2 cache
             flushed before every launch (the serving step reads every
             layer's weights and KV cold) and the host queued ahead of the
             card (device time only), beside the H100 roofline bound of
             ``repro_torch.core.costmodel``, and each GEMM's achieved GB/s
             (its bound's bytes over its time), beside the timer's own
             floor (one trivial kernel between the events). The
             decoupled pipeline is also timed phase by phase, and phase 2
             once more right after phase 1 wrote its workspace (what the
             50 MB L2 keeps of it); W4A8 also with its two launches one
             after the other. Flash
             attention at the two training shapes: the kernel forward, the
             Function's forward + backward, the plain version and SDPA.
             The expert-batched W4A16 kernel: one olmoe layer's three
             expert stacks at M = 8 and mixtral's w_down at E = 8, M = 2,
             beside E GEMMs' bound, dequant + ``torch.bmm`` and the 2-D
             kernel looped over the experts; the decoupled pipeline's and
             W4A8's expert-by-expert runs on olmoe's w_gate stack.
6. trace   — in phase 4's counted run: one prefill step and 4 decode
             steps under ``torch.profiler`` (device busy time and device
             ops per step, the fused W4A16 kernel's share, the kernels and
             host ops that cost the most), and untraced steps of each kind
             timed to a sync, so the idle share is read against host time
             the profiler did not slow. Phase 16 holds the ring engine
             against this run.
7. train   — (a) two train steps of danube at full width and depth (B=4 x
             2048 tokens, the same random weights and batches) through the
             flash kernel and through the plain chunked attention: loss,
             grad norm and moments compared; (b) the port's
             training launcher (``repro_torch.launch.train``) at full width
             and depth, 4 steps of 2 x 8192 tokens with checkpoints at
             steps 0 and 3 (~18.3 GB each, in a temporary directory that is
             removed; disk and host RAM are checked first): step time,
             tokens/s, MFU, peak memory, 48 flash launches a step, and a
             history of checkpoints only; (c) one step of (b)'s shape
             under ``torch.profiler``: device time by kernel group, idle
             share.
8. features — the serving features at full width, danube's first 12 of
             24 layers (``FEATURE_LAYERS``, for the script's time; W4A16,
             kv_fp16, 8 slots, 8 prompts of 512 tokens sharing a 384-token
             prefix, 16 generated each): (a) ngram speculation at k = 4
             (both kernels' counters must rise), exact acceptance (every
             emitted token the verify step's own argmax), its verify
             logits within LOGIT_TOL of a plain decode teacher-forced onto
             its streams, a draft proposer holding the target's weights
             (acceptance >= 90 %), and one verify step against one decode
             step (``torch.profiler``); (b) prefix sharing against an
             unshared run, for the 384-token prefix and a 392-token one
             off the 32-token chunk grid (pages and prefill steps saved
             equal to the CPU count of the same schedule, first-token
             logits within LOGIT_TOL), and a warm readmit with zero
             prefill chunks; (c) the HTTP front door on 127.0.0.1: SSE clients
             against ``engine.run``, one hanging up mid-stream, one 429,
             ``GET /metrics`` against the report.
9. moe     — the MoE family: (a) olmoe-1b-7b at full width, its first 8
             of 16 layers (``MOE_LAYERS``, for the script's time; d_model
             2048, 16/16 heads of 128, 64 experts top-8 of
             d_ff 1024, vocab 50304, bf16) through the serve launcher,
             W4A16, kv_fp16, 8 slots, 8 requests of 256 + 32 tokens,
             16-token pages, 32-token chunks: every expert stack one
             launch of the W4A16 kernel (counters rise), prefill logits
             within LOGIT_TOL of the plain paths on the same weights
             with the kernel run's expert choices replayed (a bf16
             difference flips near-tied top-k choices, which a
             free-running comparison would measure instead of the
             kernels; every replayed choice the plain path would not
             make itself must be a near-tie, gate margin <= 2^-5), 4
             traced decode steps (device ms, ops, idle share) with every
             decode step launching the W4A16 kernel exactly 8 x (4 + 3)
             = 56 times, an ngram-speculative run (verify routes 8 x 5
             rows), and the dense bf16 weights (``--no-quant``, the
             paper's FP16 yardstick) traced the same way; (b) mixtral-8x7b
             at full width and depth (32 layers, 46.7 B parameters: 87 GiB
             in bf16): first ``python -m repro_torch.launch.serve --arch
             mixtral-8x7b`` as typed (``launch.serve.main``, counted: the
             W4A16 kernel, its expert-batched form and paged attention
             launch), then the launcher's engine, built streamed
             (``T.init_serving_params``: drawn and quantized layer by
             layer, 26.7 GiB at the peak reckoned, printed beside the
             measured), W4A16, 8 requests of 64 + 16 tokens, every decode
             step launching the W4A16 kernel 7 x 32 times (3 x 32 of them
             expert-batched) and paged attention 32 times, against its
             plain paths the same way. Phase 3 also holds paged attention
             at both archs' head shapes (16 over 16 heads of 128; 32 over
             8 of 128, window 4096).
10. carry  — the recurrent-carry families at full width, each
             through the serve launcher (W4A16, kv_fp16, 8 slots, 8
             requests of 256 + 32 tokens, 16-token pages, 32-token chunks,
             random weights from seed 0) and against its plain paths on
             the same weights (the first 4 requests' prefill logits within
             LOGIT_TOL): (a)
             rwkv6-7b (its first 8 of 32 layers, ``CARRY_LAYERS``: the cut
             pays for phase 14's elastic run and phase 15; d_model 4096,
             64 heads of 64, d_ff 14336, vocab 65536; no KV cache), every
             decode step launching the W4A16 kernel exactly 8 x 8 = 64
             times and paged attention never; its random-weight logits
             move past LOGIT_TOL under bf16 rounding alone (the bf16
             plain path against an fp32 one, printed), so its paths are
             held with fp32 activations on the same quantized weights
             (the kernel's fp32 variant); (b) hymba-1.5b (its first 4 of
             32 layers, ``CARRY_LAYERS``: the cut pays for
             phases 13 to 15's time; d_model 1600, 25/5 heads of
             64, SSM d_inner 3200 state 16, d_ff 5504, vocab 32001, SWA
             1024; the K = 1600 leaves at group 64), 4 x 10 = 40 W4A16
             and 4 paged-attention launches every decode step, and one
             request of 1200 + 8 tokens (the window bites) against its
             plain path. For each: a traced prefill chunk and 4 traced
             decode steps (device ms, ops, idle share), speculation at k =
             4 with drafts that are the plain decode's own tokens (4
             requests) and with ngram (64-token prompts; exact acceptance; the verify logits at each row's first
             position against a decode step replayed from the same carry;
             every carry commit equal to checkpoint 1 + accepted of the
             stack its verify step returned, 0 for inactive rows), and
             ``--no-quant`` traced the same way. Phase 3 also holds the
             W4A16 kernel at every carry-family (K, N) (M = 1, 8, 40; bf16
             and fp32; hymba's K = 1600 at group 64) and paged attention at
             hymba's heads (G = 5, D = 64: decode, chunk and verify, both
             KV formats, the 1024 window biting and a 100-token one, -1
             table entries, fp32); phase 5 times both there, and the
             sequential recurrences of a prefill chunk alone.
11. encdec/vision — (a) whisper-small at full width and depth (12 + 12
             layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51865,
             1500 frames, LayerNorm and GELU) through the serve launcher's
             engine (W4A16, kv_fp16, 8 slots, 8 requests of 128 + 32
             tokens, each with its own 1500 x 768 frames, 16-token pages,
             32-token chunks; the encoder's attention on the flash kernel):
             counters set to 0 just before and read just after, every
             traced decode step launching 96 W4A16 GEMMs and 12 paged
             attention calls; the first 4 requests' prefill logits against
             the plain paths within LOGIT_TOL; the flash encoder's output
             and cross K/V against the chunked encoder's; the encoder's
             time a request at admit; prefix sharing (the same audio shares
             a 64-token prefix's pages, different audio none; block tables
             read, pages saved against a CPU replica); ngram at k = 4 with
             exact acceptance. (b) internvl2-1b at full width, its first
             12 of 24 layers (``VISION_LAYERS``, for the script's time;
             d_model 896, 14/2 heads of 64, d_ff 4864, vocab 151655)
             the same way with 256 patch embeddings ahead of 128 + 32
             tokens (84 W4A16 and 12 paged-attention launches a decode
             step; a request differing in patch row 100 shares pages 0-5
             only), ngram, and one request with ``prefix_embeds`` through
             the front door. (c) starcoder2-7b (GELU) and granite-20b (one
             KV head for 48) at full width and depth (32 and 52 layers)
             through the serve launcher (granite built streamed,
             starcoder2 whole, as the launcher chooses from the shapes;
             the build's peak measured beside the reckoned), 8 requests of 128 + 16 tokens
             (6 x 32 and 7 x 52 W4A16 launches, 32 and 52 paged-attention
             launches a decode step), against their plain paths. Phase 3
             also holds the W4A16 kernel at whisper's M = 1500 encoder
             shapes and at (896, 128), (896, 151808), (6144,
             128) at every split the planner may pick, (24576, 6144) and
             (18432, 4608); paged attention at G = 1, 7, 9 and 48 (decode,
             chunk, verify); the flash kernel non-causal at 1 x 1500, D =
             64. Phase 5 times those GEMMs, Split-K against data-parallel
             at (6144, 128) for M = 1, 8, 16, paged attention at G = 48 and
             1, the flash encoder, and whisper's decode-step
             cross-attention (plain PyTorch, as the JAX package leaves it to
             XLA).
12. train-families — every family trains at full width, random weights
             from seed 0, the full configs' remat (``FAMILY_TRAIN``):
             whisper-small (12 + 12 layers, 4 x 448 tokens over 1500
             frames each), internvl2-1b (12 of 24 layers, for the
             script's time, 2 x (256 patches + 1792)), hymba-1.5b (4
             of 32 layers, 2 x 1280: the 1024
             window bites; cut for the script's time, its stepped SSM
             scan made each full-depth step 8.4-12.3 s),
             olmoe-1b-7b (4 of 16 layers, 2 x 1024), mixtral-8x7b (1 x 1024
             at the depth 80 GB allows: 1 layer, since the functional
             AdamW holds old and new moments), rwkv6-7b (8 of 32, 2 x 512),
             starcoder2-7b and granite-20b (4 layers, 1 x 1024); each cut
             printed with its byte count (``launch.train.train_bytes``).
             Four ``make_train_step`` steps through the flash kernel and
             two through the chunked attention from the same parameters
             and batches (the launcher's own ``extra_inputs``): loss and
             grad norm of the first two, m and v after them, within
             ``TRAIN_TOL`` (phase 7(a)'s ``compare_paths``); MoE expert
             choices of the flash run replayed in the chunked run, forward
             and recompute in call order, every differing choice a
             near-tie; hymba's two paths held in fp32 (in bf16 two plain
             attention orders alone nearly fill ``TRAIN_TOL``'s m), its
             bf16 flash steps timed; rwkv (no attention) flash steps only,
             finite. Flash launches 2 x the attention layers a step (the
             encoder's included), no other kernel; the median step ms of
             steps 1-3, tokens/s, MFU and peak memory per arch. Then
             ``python -m repro_torch.launch.train --arch whisper-small``
             for 3 steps with checkpoints at steps 0 and 2 (each >= 10 B a
             parameter; phase 7(b)'s ``run_launcher``), and row 7c: the
             flash forward at each family's training shape held against
             its plain version in fp32 and bf16 (hymba's window and
             whisper's encoder among them), then timed against its bound,
             its plain version and SDPA. Phase 3 also holds the Function's
             gradients at each of those head shapes, at S = 256 and at the
             training lengths (``flash_grad_cases``), against the exact
             (fp64) gradient.

13. mesh   — serving on a (data, model) mesh of ranks, one process each,
             spawned on the one card (``chip_smoke.py --mesh-rank``) and
             joined over ``gloo`` (NCCL refuses two ranks on one GPU;
             the collectives go through host memory): (a) h2o-danube-1.8b
             at full width, its first 12 of 24 layers (for the script's
             time), at 1x2 and 2x2, and its first 4 at 2x2 with and
             without JAX's ``fsdp_serve`` (each rank keeps its shares over
             "data" of its W4A16 slice and gathers a layer just before it
             runs): its tokens and launches equal to the run without it,
             each rank's peaks printed beside, (b) llama3-405b at
             full width (d_model 16384, 128/8 heads of 128, d_ff 53248,
             vocab 128256), its first 2 of 126 layers, at 1x4 (each rank
             draws the weights in turn and keeps its slice of each leaf as
             it is drawn: a leaf of several GB at a time). Each rank
             serves 4 requests of 128 + 8 tokens (W4A16, kv_fp16, 4 slots,
             16-token pages, 32-token chunks) through ``ServingEngine(mesh=
             ...)``, counters set to 0 just before and read just after:
             first-token logits within LOGIT_TOL of one process serving
             the same cut on the same weights, W4A16 and paged-attention
             launches exactly 7 and 1 a layer and forward on every rank,
             the ranks' tokens equal, the first greedy token that differs
             from one process printed. Phase 3 also holds the W4A16
             kernel at every shard-local leaf (M = 1, 2, 4, 8) and paged
             attention at a rank's heads (32/2 of 128, 16/4 of 80); phase
             5 times them (rows 1e and 4d). Then the recurrent-carry and
             encoder-decoder families, the same way: (c) rwkv6-7b at full
             width, its first 4 of 32 layers, with fp32 activations (its
             bf16 logits are chaotic on random weights) at 1x4 (16 heads
             a rank), (d) hymba-1.5b at full width, its first 8 of 32
             layers, at 1x2 (the attention whole: 25/5 heads; the SSM's
             3200 channels and d_ff cut; out_proj and w_down whole behind
             a gathered input) and 1x5 (5 over 1 heads, 640 channels, the
             MLP whole), and with ngram at 1x2 (every verify step's carry
             commit equal to checkpoint 1 + accepted, the verify logits
             against a replayed decode step), (e) whisper-small at full
             width and depth at 2x2, each request its own 1500 x 768
             frames (the encoder runs at every admit on every rank, its
             heads cut). Every rank launches exactly the one process's
             W4A16, paged-attention and flash counts (``mesh_want``: a
             layer a forward 8/0 rwkv, 10/1 hymba, 8/1 whisper; 96 W4A16
             and 12 flash a whisper admit). Phase 3 holds the W4A16
             kernel at every new rank-local leaf (rwkv in fp32, M = 1 to
             32; whisper's encoder leaves at 1500), paged attention at
             hymba 1x5 (5 over 1 of 64) and whisper 2x2 (6/6 of 64), the
             flash forward and gradients at whisper 2x2's 6 heads; phase 5
             times them (rows 1f, 4e, 7e). No phase-13 time is a
             multi-GPU figure: the ranks share one card.
14. mesh-train — training on a (data, model) mesh of 4 ranks spawned on
             the one card (``chip_smoke.py --mesh-train-rank``, gloo, as
             phase 13): h2o-danube-1.8b at full width, its first 1 of 24
             layers (``MESH_TRAIN_LAYERS``: the elastic run's four
             checkpoints, gathered to rank 0 through host memory, made
             most of the phase at 4; the cut and its ``train_bytes``
             printed, with each
             mesh's shares and the bytes a step sends through host memory
             reckoned before the run), 8 x 1024 tokens a step under
             danube's preset (``launch.presets.settings_for``: 4
             microbatches, FSDP, ZeRO-2) at 1x4 and 2x2, two steps of
             ``make_train_step(..., mesh=)`` from the weights of seed 0
             against one process (rank 0, before the meshes) running
             ``make_train_step`` with the same settings on the same
             weights and batches: loss and grad norm of both steps, and m
             and v gathered from the ranks after them, within
             ``TRAIN_TOL``; flash launches exactly 2 · L · n a step on
             every rank (forward and recompute per microbatch), no other
             kernel; each rank's step ms beside the one process's. Phase 3
             also holds the flash forward and its gradients at the ranks'
             heads (8/2 and 16/4 of 80, window 4096); phase 5 times the
             forward there (row 7d). Then whisper-small at full width,
             its first 2 of 12 decoder and encoder layers
             (``MESH_TRAIN_WHISPER_LAYERS``, for the script's time), 4 x
             448 tokens over 1500 frames a row at 2x2 under
             its preset (4 microbatches of one row, so every data rank
             runs every row; FSDP, ZeRO-2), held the same way, flash
             launching 2 x 4 x 4 a step on every rank (the encoder's 2
             layers and the decoder's 2). Last, the elastic run
             (``MESH_ELASTIC``): danube as above at 2x2 through
             ``run_training`` with a checkpoint after every step (its steps
             0 and 1 are the 2x2 mesh, held against the one process as
             above, m and v read from the step-1 checkpoint); every try of
             step 2 fails, ``remesh_fn`` drops the last data row
             (``launch.mesh.degraded_mesh``: ranks 2 and 3 leave, 0 and 1
             join a fresh group on a new store), the survivors restore the
             step-1 checkpoint onto their 1x2 shares and train steps 2 and
             3 on a data rank's 4 rows, held against one process restoring
             the same checkpoint (loss, grad norm, m and v within
             ``TRAIN_TOL``); the history JAX's runner records, each rank's
             step ms and flash launches a step printed. Before it, the
             weight-gathered layers of ZeRO-3 (``MESH_ZERO3``): danube's
             first 4 layers, 8 x 1024 tokens in one microbatch at 2x2,
             FSDP with ``zero2`` off (each layer gathered over "data" just
             before it runs and again in its recompute, its gradient
             reduce-scattered onto the shares), three steps held against
             one process, the all-gathers over "data" a step equal to the
             reckoned (``dryrun.zero3_collectives``), and one step of the
             same cell under ZeRO-2 (the whole slice gathered once a
             step): the ZeRO-3
             rank's peak below it by at least 2 layers' TP bytes. No
             phase-14 time is a multi-GPU figure: the ranks share one
             card.
15. dryrun — the dry run (``repro_torch.launch.dryrun``) on the meta
             device, on the card's host: each cell whose peak an earlier
             phase measured (phase 7b's launcher, phase 4's decode step,
             phase 12's whisper flash run, phase 14's danube 1x4 rank (0,
             0) and its ZeRO-3 and ZeRO-2 ranks (0, 0) on a fake world of
             4; the ZeRO-3 one must hold), traced at that geometry, its
             predicted peak beside the measured (less what the process
             held before the cell's tensors; a miss beyond 10 % and 256
             MiB printed with its breakdown) (the full-depth serving
             builds' peaks are held so in phases 9(b) and 11(c)); then
             the production grid:
             danube and llama3-405b at 16x16, train_4k and decode_32k
             (llama3-405b's train cell at 1 and 2 of 126 layers, a rank's
             peak reckoned linear in the layers to 126; its serving cells,
             prefill_32k too, under its preset's ``fsdp_serve``), and
             danube's train_4k at
             15x16, global batch 240 (JAX's elastic cell): each rank-0
             record's peak, fit, FLOPs and collectives; a decode cell
             is JAX's (the ring state of ``input_specs``, its batch over
             "data" and its window over "model"), printed beside the
             paged departure, llama3-405b's decode_32k first. Nothing
             launches.
16. ring   — the ring engine (``ServingEngine(paged=False)``): (a)
             h2o-danube-1.8b at full width and depth, W4A16, 8 requests of
             512 + 32 tokens, each prompt prefilled whole through the
             flash kernel, counters set to 0 just before and read just
             after (24 flash and 168 W4A16 launches a prefill, 168 W4A16
             a decode step, no paged attention), its prefill logits and
             first decode step's logits within LOGIT_TOL of the paged
             engine's on the same weights and requests (phase 4's run),
             greedy tokens compared with the first divergence printed;
             (b) danube's first 2 layers on 1x2 gloo ranks sharing the card,
             served in phase 13's spawn of 2 ranks (the window cut over
             "model": a
             decode step all-gathers the new K/V and q and merges each
             rank's softmax partials), first-token and first decode step's
             logits against one process within LOGIT_TOL, launches equal;
             (c) the planner's refine pass (``kernels/autotune.py``) at
             granite's (6144, 128) and llama3 TP=4's (16384, 256), M = 1,
             8, 16: the refined split held against the plain version and
             timed beside the default split and ``torch.matmul``.

17. compiled — the serving steps under CUDA graphs (``runtime/steps.py``:
             the counterparts of JAX's ``jax.jit`` steps) against eager:
             (a) phase 4's cell (h2o-danube-1.8b at full width and depth,
             W4A16, 8 x (512 + 32)) through the serve launcher's engine
             compiled (the default) and ``--eager``, on the same weights
             and requests, counters set to 0 just before each run and read
             just after: greedy tokens equal, first-token logits bit-equal
             (or within LOGIT_TOL, named), launches per decode step (168
             W4A16, 24 paged attention) and over the run equal, the graphs
             captured, their pool's bytes and the capture's seconds, and
             each run's decode ms a step on the host clock (10 untraced
             steps to a sync) and on the device (4 under
             ``torch.profiler``, which records each kernel a graph replays)
             with the idle share; (b) compiled against eager on tokens,
             first-token logits and launches, 8 requests of 64 + 16 tokens:
             danube's ngram verify step (12 layers, prompts repeating a
             16-token segment), rwkv6-7b (8 layers, carries, a chunk graph
             per slot), whisper-small (full depth, the encoder compiled)
             and olmoe-1b-7b (8 layers).

Every serving phase runs the engine's steps compiled (the engine's
default on one card), except where it says otherwise: phase 9's routed
pairs step eagerly (their expert choices are recorded and replayed in
Python between the ops), phase 8's verify-against-decode timing and phase
10's replayed decode steps call the eager steps, and the mesh's ranks are
eager (``steps.MESH_DEPARTURE``).

Work that needs no card, or only ranks of its own, runs beside the
card's phases: phase 15's production grid traces in a process of its own
(``chip_smoke.py --dryrun-grid``) from the build on, and its lines print in
phase 15; phase 14's ranks start before phase 13, when the card has room,
and train while phase 13 serves and phase 15 traces its one-device cells,
and are held after them.
Every process the script starts is stopped by the time it exits.

The line before the last two is the kernels' JSON record; the line before
the last is the card's name and power limit; the last line is the
contract's JSON object.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "h2o-danube-1.8b"
GEN = 32
SERVE_ARGV = ["--arch", ARCH, "--batch", "8", "--requests", "8",
              "--prompt-len", "512", "--gen", str(GEN), "--kv-format",
              "kv_fp16", "--seed", "0"]
# (K, N) of one danube layer's quantized GEMMs in step order: wq, wk, wv,
# wo, w_gate, w_up, w_down
LAYER_GEMMS = [(2560, 2560), (2560, 640), (2560, 640), (2560, 2560),
               (2560, 6912), (2560, 6912), (6912, 2560)]
DANUBE_GEMMS = sorted(set(LAYER_GEMMS))
HKV, G, D, PAGE, PAGES = 8, 4, 80, 8, 68      # 68 pages = 544-token window
GEMM_TOL = "|d| <= 2^-7*|plain| + 1e-3"
GEMM_F32_TOL = "|d| <= 1e-5*|plain| + 1e-4"
ATTN_TOL = "|d| <= 2^-7*|plain| + 2e-3; m within 1e-4*(1+|m|), l within " \
    "1e-3*l where the partition has a live key, the same partitions masked"
LOGIT_TOL = 0.25
# the speculative verify step of phase 8: k = 4 drafts, 8 slots x 5 rows
SPEC_K = 4
VERIFY_M = 8 * (SPEC_K + 1)
# the GEMM family's full-width serving runs (phase 4), at FAMILY_LAYERS of
# danube's 24 layers (the main path's run above them keeps all 24)
FAMILY_GEN = 16
FAMILY_LAYERS = 12
FAMILY_ARGV = ["--arch", ARCH, "--batch", "8", "--requests", "8",
               "--prompt-len", "128", "--gen", str(FAMILY_GEN),
               "--page-size", "8", "--prefill-chunk", "32", "--kv-format",
               "kv_fp16", "--seed", "0"]
# (kernel path, its plain GEMM path, the kernels the path must launch)
FAMILY_RUNS = [
    (["--strategy", "decoupled"], ["--strategy", "reference"],
     ("dequant_w4", "dense_gemm", "reduce_partials", "paged_attention")),
    (["--format", "w8a16_channel"],
     ["--format", "w8a16_channel", "--strategy", "reference"],
     ("w8a16_gemm", "paged_attention")),
    (["--format", "w4a8_g128"], ["--format", "w4a8_g128", "--strategy",
                                 "w4a8_xla"],
     ("w4a8_gemm", "w4a8_quantize", "paged_attention")),
]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sm_clock_hz() -> float:
    """The card's maximum SM clock in Hz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def log_built(phase: str, argv, note: str = "") -> None:
    """Name the launcher command whose engine a phase builds
    (``launch.serve.build``) and then steps itself: the command's own run
    (``launch.serve.main``: plan cache, ``engine.run``, report) is not
    what runs."""
    log(phase, "engine of `python -m repro_torch.launch.serve "
        + " ".join(argv) + "` (launch.serve.build), stepped here" + note)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def gemm_case(torch, K, N, M, gen, dev):
    from repro_torch.core.quant import quantize
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    qt = quantize(w.to(torch.bfloat16), out_dtype=torch.bfloat16)
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    return x, qt


def planned_split(x, qt):
    from repro_torch.kernels import planning
    return planning.plan_matmul(planning.MatmulProblem.from_operands(x, qt),
                                use_cache=False).split_k


def kernel_table():
    """name → (CudaKernel, source, the Pallas function it replaces)."""
    from repro_torch.kernels import flash_attention, gemm, paged_attention, \
        w4a8_fused, w4a16_decoupled, w4a16_fused, w8a16_fused
    return {
        "w4a16_gemm": (w4a16_fused.W4A16_GEMM, "w4a16_gemm.cu",
                       "src/repro/kernels/w4a16_fused.py:36"),
        # the same kernel's expert-batched launch (JAX vmaps the pallas_call
        # over an MoE layer's experts)
        "w4a16_gemm_experts": (w4a16_fused.W4A16_GEMM_EXPERTS,
                               "w4a16_gemm.cu",
                               "src/repro/kernels/w4a16_fused.py:36"),
        "paged_attention": (paged_attention.PAGED_ATTENTION,
                            "paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:148"),
        "dense_gemm": (gemm.DENSE_GEMM, "dense_gemm.cu",
                       "src/repro/kernels/gemm.py:21"),
        "dequant_w4": (w4a16_decoupled.DEQUANT_W4, "w4a16_decoupled.cu",
                       "src/repro/kernels/w4a16_decoupled.py:52"),
        "reduce_partials": (w4a16_decoupled.REDUCE_PARTIALS,
                            "w4a16_decoupled.cu",
                            "src/repro/kernels/w4a16_decoupled.py:139"),
        "w8a16_gemm": (w8a16_fused.W8A16_GEMM, "w8a16_gemm.cu",
                       "src/repro/kernels/w8a16_fused.py:29"),
        "w4a8_gemm": (w4a8_fused.W4A8_GEMM, "w4a8_gemm.cu",
                      "src/repro/kernels/w4a8_fused.py:37"),
        "w4a8_quantize": (w4a8_fused.W4A8_QUANTIZE, "w4a8_gemm.cu",
                          "src/repro/kernels/w4a8_fused.py:37"),
        "flash_attention": (flash_attention.FLASH_ATTENTION,
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:81"),
    }


def reset_counts(table):
    for kernel, _, _ in table.values():
        kernel.launches = 0


def read_counts(table):
    return {name: kernel.launches for name, (kernel, _, _) in table.items()}


def family_split(M, N, K):
    """The planner's Split-K for a danube GEMM on this card (the fused,
    decoupled and W4A8 strategies share it)."""
    from repro_torch.kernels import planning
    return planning.choose_split_k(M, N, K,
                                   cores=planning.num_cores("cuda"))


def attn_case(torch, gen, dev, *, fmt_name, kind, null_slot=False,
              hole=False, dtype=None, heads=(HKV, G, D), page=PAGE,
              pages=PAGES, ctx=None):
    """The serving pool at full danube width (545 blocks of 8 tokens, one
    layer) filled with random K/V; per-slot tables of 68 pages; position
    tags for every token a slot holds. Decode: B=8 slots at ragged
    positions around 700 (the 544-token window has wrapped), queries at
    the last position, ``start = pos + 1``. Chunk: B=1, C=32 queries at
    positions 481..512 over a pool holding 0..480. Verify (the speculative
    step at k = 4): B=8 rows of C=5 queries from each slot's frontier,
    ``start`` the first of them; slot b keeps 1 + b % 5 live queries and
    pads the rest with -1, the last slot is inactive (positions and table
    all -1), and every slot's pool holds stale tags of three rejected
    drafts at and above ``start`` (masked by ``kpos < start``). ``hole``:
    slot 0's table entry 5 becomes -1 inside its live pages (the null
    block's tokens are masked). ``dtype``: the compute dtype (bf16 by
    default). ``heads``: (KV heads, group, head dim), danube's by default;
    ``page``/``pages``: the block size and a slot's table length; ``ctx``:
    the last context position (a decode or verify slot's, less 3 a slot)
    in place of 700 (480 for the chunk). ``rows`` marks the live
    queries."""
    dtype = torch.bfloat16 if dtype is None else dtype
    hkv, g, d = heads
    from repro_torch.core.quant import get_kv_format
    from repro_torch.kernels import planning
    from repro_torch.runtime import kvcache as kvc
    B, C = {"decode": (8, 1), "chunk": (1, 32), "verify": (8, 5)}[kind]
    ctx_pos = ctx if ctx is not None else 480 if kind == "chunk" else 700
    cache_len = pages * page
    fmt = get_kv_format(fmt_name)
    pool = kvc.init_pool(1 + 8 * pages, page, hkv, d, dtype, fmt_name,
                         device=dev)
    if fmt.quantized:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev))
        for t in (pool.k_scale, pool.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) / 64)
    else:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tables = (1 + torch.arange(B * pages, device=dev, dtype=torch.int32)
              ).reshape(B, pages)
    flat_pos = pool.page_pos.view(-1)
    last = []
    for b in range(B):
        hi = ctx_pos - 3 * b
        lo = max(0, hi - cache_len + 1)
        if null_slot and b == B - 1:       # 10 live pages, the rest -1
            hi, lo = 10 * page - 1, 0
            tables[b, 10:] = -1
        stale = 3 if kind == "verify" else 0     # rejected drafts
        p = torch.arange(lo, hi + 1 + stale, device=dev)
        off = p % cache_len
        bid = tables[b, off // page].long()
        flat_pos[bid * page + off % page] = p.to(torch.int32)
        last.append(hi)
    if hole:
        tables[0, 5] = -1
    last = torch.tensor(last, device=dev, dtype=torch.int32)
    if kind == "decode":
        positions, start = last[:, None].contiguous(), last + 1
    else:
        positions = (last[:, None] + 1 + torch.arange(
            C, device=dev, dtype=torch.int32)).contiguous()
        if kind == "verify":
            for b in range(B):
                positions[b, 1 + b % C:] = -1
            positions[B - 1] = -1
            tables[B - 1] = -1
        start = positions[:, 0].contiguous()
    q = torch.randn(B, C, hkv * g, d, generator=gen, device=dev)
    qg = (q.reshape(B, C, hkv, g, d) * d ** -0.5).to(dtype)
    Tq = planning.choose_q_block(C, g)
    qk = qg.permute(0, 2, 1, 3, 4).reshape(B, hkv, C // Tq, Tq * g, d) \
        .contiguous()
    planned = planning.choose_kv_partitions(
        B, hkv, pages, q_tiles=C // Tq, cores=planning.num_cores("cuda"))
    return dict(qk=qk, q=q.to(dtype), positions=positions,
                start=start, pool=pool, tables=tables, fmt=fmt, Tq=Tq,
                planned=planned, B=B, C=C, G=g, rows=positions >= 0,
                heads=heads, page=page)


def partial_rows(c):
    """The live-query mask of a case laid out as the kernel's partials
    (B, 1, QT, 1, QG): padded queries are garbage the caller discards, on
    both sides."""
    B, C, Tq, G_ = c["B"], c["C"], c["Tq"], c["G"]
    return c["rows"].reshape(B, C // Tq, Tq, 1).expand(B, C // Tq, Tq, G_) \
        .reshape(B, 1, C // Tq, 1, Tq * G_)


def combine(torch, acc, m, l):
    """Merge raw (B, Hkv, QT, S, QG, ·) partials over S and normalize."""
    alpha = torch.exp(m - m.amax(dim=3, keepdim=True))
    l_tot = (l * alpha).sum(dim=3)
    out = (acc * alpha[..., None]).sum(dim=3)
    return out / l_tot.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# K cases whose slices are multiples of 32 but not of the int rings'
# 128-row stage (2592 = 81 x 32; split 3 leaves 864-row slices in a
# 3-block cluster); group 32 divides them
RAGGED_K = [(2592, 640, 32, (1, 3))]


def check_gemm(torch, dev, gen):
    """W4A16 kernel vs its plain version. Both round the dequantized tile
    to bf16 and accumulate exact bf16 products in fp32; they differ only
    in fp32 summation order, after which the bf16 output can round either
    way: tolerance one bf16 ulp, |d| <= 2^-7·|plain| + 1e-3. The danube
    shapes at M = 1, 8, 32, 40 (the speculative verify step: 8 slots x 5
    positions) and 256 with the planner's split_k and 1, then the ragged K
    cases."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    cases = []
    for K, N in DANUBE_GEMMS:
        for M in (1, 8, 32, VERIFY_M, 256):
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            cases.append((M, K, N, x, qt,
                          sorted({planned_split(x, qt), 1})))
    for K, N, group, splits in RAGGED_K:
        w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
        qt = quantize(w.to(torch.bfloat16), group_size=group)
        for M in (8, 32):
            x = torch.randn(M, K, generator=gen, device=dev) \
                .to(torch.bfloat16)
            cases.append((M, K, N, x, qt, splits))
    worst = 0.0
    for M, K, N, x, qt, splits in cases:
        for s in splits:
            got = w4a16_fused(x, qt, split_k=s).float()
            want = w4a16_fused_plain(x, qt, split_k=s).float()
            err = (got - want).abs()
            bad = bool((err > want.abs() * 2 ** -7 + 1e-3).any())
            worst = max(worst, float(err.max()))
            log("kernels", f"w4a16_gemm M={M} K={K} N={N} split_k={s} "
                f"max|d|={float(err.max()):.3e} "
                f"{'FAIL' if bad else 'ok'} ({GEMM_TOL})")
            if bad:
                raise AssertionError(f"w4a16_gemm disagrees at M={M} "
                                     f"K={K} N={N} split_k={s}")
    return worst


def check_gemm_fp32(torch, dev, gen):
    """The kernel's fp32 variant (CUDA-core FMA) vs its plain version at
    one danube shape: the same fp32 products summed in another order, so
    fp32 rounding only."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    K, N = 2560, 640
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    qt = quantize(w)
    for M in (8, 32):
        x = torch.randn(M, K, generator=gen, device=dev)
        for s in sorted({planned_split(x, qt), 1}):
            got = w4a16_fused(x, qt, split_k=s)
            want = w4a16_fused_plain(x, qt, split_k=s)
            err = (got - want).abs()
            bad = got.dtype != torch.float32 or bool(
                (err > want.abs() * 1e-5 + 1e-4).any())
            log("kernels", f"w4a16_gemm fp32 M={M} K={K} N={N} split_k={s} "
                f"max|d|={float(err.max()):.3e} "
                f"{'FAIL' if bad else 'ok'} ({GEMM_F32_TOL})")
            if bad:
                raise AssertionError(f"w4a16_gemm fp32 disagrees at M={M} "
                                     f"split_k={s}")


# paged-attention phase-3 variants beyond bf16 over whole tables:
# (label, kind, KV format, compute dtype name, a -1 entry inside a live
# partition)
ATTN_EDGES = [("hole", kind, fmt, "bf16", True)
              for kind in ("decode", "chunk")
              for fmt in ("kv_fp16", "kv8_channel")] + [
    ("fp16", "chunk", fmt, "fp16", False)
    for fmt in ("kv_fp16", "kv8_channel")]


def check_attention(torch, dev, gen):
    """Paged-attention kernel vs its plain version: decode (B=8), chunk
    (B=1, C=32) and the speculative verify step (B=8, C=5: padded queries,
    an inactive row, stale rejected-draft tags; only live queries are
    held), both KV formats, the model's 4096 window and a 100-token
    window that masks (whole partitions of it at kv_partitions 4),
    kv_partitions 1 (68 pages, 544 keys a partition), 4 (17 pages, 136
    keys: neither a multiple of the kernel's key stage) and the planner's
    pick, a slot with -1 table entries; then ``ATTN_EDGES``: a -1 entry
    inside a live partition, and fp16 compute at C=32. Both round
    dequantized K/V and the softmax weights to bf16 and accumulate in
    fp32; exp and summation order differ, so a weight may round to the
    neighbouring bf16 value (2^-8 of it). The
    combined outputs are softmax averages over hundreds of keys, about
    0.05 in size, not unit scale: they are held to |d| <= 2^-7·|plain| +
    2e-3 (the worst error measured on the H100 is 1.44e-3; dropping or
    mis-masking one 8-token page moves them by about 1e-2). The raw
    partials are checked too: the same partitions fully masked (m at
    -1e30) on both sides; elsewhere the running max m — an fp32 dot of the
    same bf16 values in another order — within 1e-4·(1 + |m|), and the
    softmax sum l within 1e-3 of itself (one dropped key of a live page
    moves it by more)."""
    worst = 0.0
    variants = [("", kind, fmt, "bf16", False)
                for fmt in ("kv_fp16", "kv8_channel")
                for kind in ("decode", "chunk", "verify")] + ATTN_EDGES
    dtypes = {"bf16": torch.bfloat16, "fp16": torch.float16}
    for label, kind, fmt_name, dt, hole in variants:
        c = attn_case(torch, gen, dev, fmt_name=fmt_name, kind=kind,
                      null_slot=kind == "decode", hole=hole,
                      dtype=dtypes[dt])
        name = f"{label} {kind}" if label else kind
        for window in (4096, 100):
            for parts in sorted({1, 4, c["planned"]}):
                worst = max(worst, hold_partials(torch, c, name, fmt_name,
                                                 dt, window, parts))
    return worst


def hold_partials(torch, c, name, fmt_name, dt, window, parts):
    """One case of ``check_attention``: the kernel's raw partials against
    the plain version's (the combined output, m and l); returns max |d|
    of the combined output."""
    from repro_torch.kernels import paged_attention as pa
    kw = dict(Tq=c["Tq"], G=c["G"], S=parts, window=window, fmt=c["fmt"])
    args = (c["qk"], c["positions"], c["start"], c["pool"], c["tables"])
    got = pa._launch_partials(*args, **kw)
    want = pa.pooled_partials_plain(*args, **kw)
    rows = partial_rows(c)
    out_p = combine(torch, *want)
    d = torch.where(rows[:, :, :, 0, :, None],
                    (combine(torch, *got) - out_p).abs(), 0.0)
    err = float(d.max())
    (_, m_k, l_k), (_, m_p, l_p) = got, want
    live = (m_p > -1e29) & rows
    m_k = torch.where(rows, m_k, torch.full_like(m_k, -1e30))
    dm = ((m_k - m_p).abs() / (1 + m_p.abs()))[live]
    dl = ((l_k - l_p).abs() / l_p)[live]
    dm_max = float(dm.max()) if dm.numel() else 0.0
    dl_max = float(dl.max()) if dl.numel() else 0.0
    bad = bool((d > out_p.abs() * 2 ** -7 + 2e-3).any()
               or (live != (m_k > -1e29)).any()
               or dm_max > 1e-4 or dl_max > 1e-3)
    log("kernels", f"paged_attention {name} B={c['B']} C={c['C']} "
        f"{fmt_name} {dt} window={window} kv_partitions={parts} "
        f"max|d|={err:.3e} (max|out| {float(out_p.abs().max()):.3f}) "
        f"max|dm|/(1+|m|)={dm_max:.2e} max|dl|/l={dl_max:.2e} live "
        f"partitions {int(live.sum())}/{live.numel()} "
        f"{'FAIL' if bad else 'ok'} ({ATTN_TOL})")
    if bad:
        raise AssertionError(f"paged_attention disagrees: {name} {fmt_name} "
                             f"{dt} window={window} kv_partitions={parts}")
    return err


# the MoE archs' paged attention as served in phase 9: (arch, (KV heads,
# group, head dim), page, a slot's pages, window)
MOE_ATTN = [("olmoe", (16, 1, 128), 16, 18, 0),
            ("mixtral", (8, 4, 128), 16, 5, 4096)]


def check_moe_attention(torch, dev, gen):
    """Paged attention at the MoE archs' head shapes (olmoe: 16 query
    over 16 KV heads of 128, full attention, an 18-page table of 16-token
    pages; mixtral: 32 over 8 of 128, window 4096, a 5-page table): decode,
    the 32-token chunk and the verify step, at one partition and the
    planner's pick, held as ``check_attention`` holds danube's."""
    worst = 0.0
    for arch, heads, page, pages, window in MOE_ATTN:
        for kind in ("decode", "chunk", "verify"):
            c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                          heads=heads, page=page, pages=pages)
            for parts in sorted({1, c["planned"]}):
                worst = max(worst, hold_partials(
                    torch, c, f"{arch} {kind}", "kv_fp16", "bf16", window,
                    parts))
    return worst


def held(name, label, got, want, *, f32):
    """Hold a kernel's output against its plain version's: same dtype and
    shape, |d| <= 2^-7·|plain| + 1e-3 in bf16 (one ulp after a reordered
    fp32 sum), 1e-5·|plain| + 1e-4 in fp32 (summation order). Returns
    max |d|."""
    err = (got.float() - want.float()).abs()
    lim = want.float().abs() * (1e-5 if f32 else 2 ** -7) \
        + (1e-4 if f32 else 1e-3)
    bad = got.dtype != want.dtype or got.shape != want.shape \
        or bool((err > lim).any())
    log("kernels", f"{name} {label} max|d|={float(err.max()):.3e} "
        f"{'FAIL' if bad else 'ok'} "
        f"({GEMM_F32_TOL if f32 else GEMM_TOL})")
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}")
    return float(err.max())


def bit_equal(name, label, got, want):
    ok = got.dtype == want.dtype and got.equal(want)
    log("kernels", f"{name} {label} {'bit-equal' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} is not bit-equal to its plain "
                             f"version at {label}")


def check_family(torch, dev, gen):
    """The rest of the GEMM family against their plain versions, bf16 and
    fp32, the four danube (K, N) pairs, M = 8 and 32, the planner's
    split_k and 1; the dense GEMM and W8A16 also at M = 1 and 256 and at
    the ragged K cases. Phase 1 and phase 3 of the decoupled pipeline repeat
    their plain versions' fp32 operations in the same order: bit-equal.
    W4A8: see check_w4a8. Returns each kernel's worst |d| (the bf16 cases
    set it)."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import gemm, w8a16_fused
    from repro_torch.kernels import w4a16_decoupled as dec
    worst = dict.fromkeys(("dense_gemm", "dequant_w4", "reduce_partials",
                           "w4a16_decoupled", "w8a16_gemm", "w4a8_gemm"),
                          0.0)
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        dt = "fp32" if f32 else "bf16"
        for K, N in DANUBE_GEMMS:
            w = (torch.randn(K, N, generator=gen, device=dev)
                 * K ** -0.5).to(dtype)
            qt4 = quantize(w)
            qt8 = quantize(w, "w8a16_channel")
            qta8 = quantize(w, "w4a8_g128")
            ws = dec.dequant_w4(qt4, out_dtype=dtype)
            bit_equal("dequant_w4", f"{dt} K={K} N={N}", ws,
                      dec.dequant_w4_plain(qt4, out_dtype=dtype))
            for M in (8, 32):
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                label = f"{dt} M={M} K={K} N={N}"
                splits = sorted({family_split(M, N, K), 1})
                e = held("dense_gemm", label + " direct", gemm.gemm(x, w),
                         gemm.gemm_plain(x, w), f32=f32)
                worst["dense_gemm"] = max(worst["dense_gemm"], e)
                for sk in splits:
                    lab = f"{label} split_k={sk}"
                    parts = dec.splitk_gemm(x, w, split_k=sk)
                    e = held("dense_gemm", lab + " partials", parts,
                             dec.splitk_gemm_plain(x, w, split_k=sk),
                             f32=True)
                    worst["dense_gemm"] = max(worst["dense_gemm"], e)
                    bit_equal("reduce_partials", lab,
                              dec.reduce_partials(parts, out_dtype=dtype),
                              dec.reduce_partials_plain(parts,
                                                        out_dtype=dtype))
                    e = held("w4a16_decoupled", lab,
                             dec.w4a16_decoupled(x, qt4, split_k=sk),
                             dec.w4a16_decoupled_plain(x, qt4, split_k=sk),
                             f32=f32)
                    worst["w4a16_decoupled"] = max(
                        worst["w4a16_decoupled"], e)
                    e = check_w4a8(torch, lab, x, qta8, sk, f32=f32)
                    worst["w4a8_gemm"] = max(worst["w4a8_gemm"], e)
                e = held("w8a16_gemm", label + " split_k=1",
                         w8a16_fused.w8a16_fused(x, qt8),
                         w8a16_fused.w8a16_fused_plain(x, qt8), f32=f32)
                worst["w8a16_gemm"] = max(worst["w8a16_gemm"], e)
            for M in (1, 256):
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                check_tile_edges(worst, dt, M, K, N, x, w, qt8, f32)
        for K, N, _, _ in RAGGED_K:
            w = (torch.randn(K, N, generator=gen, device=dev)
                 * K ** -0.5).to(dtype)
            qt8 = quantize(w, "w8a16_channel")
            for M in (8, 32):
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                check_tile_edges(worst, dt, M, K, N, x, w, qt8, f32)
    return worst                # dequant_w4, reduce_partials: bit-equal


def check_w4a8(torch, label, x, qt, split_k, *, f32):
    """The W4A8 kernels against their plain versions: the quantize kernel's
    x_q and row scales bit-equal to the CPU's quantize_activations_int8
    (the JAX package's, pinned by the CPU tests), its Σx_q per group equal
    to the sums of the CPU's x_q; the GEMM's int32 group sums are exact, so
    only the fp32 sum over groups differs (held as every GEMM). Returns
    max |d|."""
    from repro_torch.core.quant import quantize_activations_int8
    from repro_torch.kernels import w4a8_fused
    M, K = x.shape
    g = qt.group_size
    xq, xs, tok = w4a8_fused.w4a8_quantize(x, g)
    wq, ws = quantize_activations_int8(x.cpu())
    bit_equal("w4a8_quantize", f"{label} x_q", xq.cpu(), wq)
    bit_equal("w4a8_quantize", f"{label} row scales", xs.cpu(), ws)
    bit_equal("w4a8_quantize", f"{label} group sums", tok.cpu(),
              wq.reshape(M, K // g, g).sum(dim=2, dtype=torch.int32))
    return held("w4a8_gemm", label,
                w4a8_fused.w4a8_fused(x, qt, split_k=split_k),
                w4a8_fused.w4a8_fused_plain(x, qt, split_k=split_k), f32=f32)


# the W4A8 kernel's edges: (M, K, N, group, zero-points, split_k): every
# tile height, a ragged column tile (N = 144), each group, one cluster and
# the partials route beyond it
W4A8_EDGES = [(M, 1024 if sk < 16 else 512, 144, group, zeros, sk)
              for M in (1, 8, 32, 40, 256)
              for group, zeros, sk in ((32, True, 16), (64, False, 4),
                                       (128, True, 1), (128, False, 4))]


def w4a8_edge_rows(torch, x):
    """Rows 0-2 of x (M >= 3) at the quantizer's edges: an all-zero row
    (s = 1e-8), a row holding +amax and -amax, and a row with amax 127/16
    (s = 1/16 exactly) whose other values are exact .5 ties of x / s (round
    half to even)."""
    K = x.shape[1]
    x[0] = 0
    x[1, 0], x[1, 1] = x[1].abs().max(), -x[1].abs().max()
    ties = (2 * (torch.arange(K, device=x.device) % 254 - 127) + 1) / 32.0
    x[2] = ties.to(x.dtype)
    x[2, 0] = 127 / 16
    return x


def check_w4a8_edges(torch, dev, gen):
    """check_w4a8 at W4A8_EDGES in bf16 and fp32, edge rows included."""
    from repro_torch.core.quant import quantize
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        for M, K, N, group, zeros, sk in W4A8_EDGES:
            w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
            qt = quantize(w.to(dtype), "w4a8_g128", group_size=group,
                          symmetric=not zeros)
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            if M >= 3:
                x = w4a8_edge_rows(torch, x)
            e = check_w4a8(torch, f"{dt} M={M} K={K} N={N} group={group} "
                           f"{'zeros' if zeros else 'symmetric'} "
                           f"split_k={sk}", x, qt, sk,
                           f32=dtype == torch.float32)
            if dtype == torch.bfloat16:
                worst = max(worst, e)
    return worst


def check_tile_edges(worst, dt, M, K, N, x, w, qt8, f32):
    """The dense GEMM (direct) and W8A16 at one edge shape of the tile
    loop (M = 1 or 256, or a ragged K), held as in check_family."""
    from repro_torch.kernels import gemm, w8a16_fused
    label = f"{dt} M={M} K={K} N={N}"
    worst["dense_gemm"] = max(worst["dense_gemm"], held(
        "dense_gemm", label + " direct", gemm.gemm(x, w),
        gemm.gemm_plain(x, w), f32=f32))
    worst["w8a16_gemm"] = max(worst["w8a16_gemm"], held(
        "w8a16_gemm", label + " split_k=1", w8a16_fused.w8a16_fused(x, qt8),
        w8a16_fused.w8a16_fused_plain(x, qt8), f32=f32))


FLASH_TOL = {"bf16": 2e-2, "fp32": 1e-5}
FLASH_BF16_TOL = "|d| <= min(2e-2*(1+|plain|), 2^-7*|plain| + 2^-5*rms)"
# (label, B, Sq, Skv, Hq, Hkv, D, causal, window): danube's heads (32/8 of
# 80) at the training shapes (the launcher's 2 x 8192 with its window among
# them) and the edge cases, then D = 128 and 32
FLASH_CASES = [
    ("4x2048 causal", 4, 2048, 2048, 32, 8, 80, True, 4096),
    ("2x8192 window 4096", 2, 8192, 8192, 32, 8, 80, True, 4096),
    ("1x4608 window 4096", 1, 4608, 4608, 32, 8, 80, True, 4096),
    ("2x96 unaligned", 2, 96, 96, 32, 8, 80, True, 4096),
    ("64 x 192 cross", 1, 64, 192, 32, 8, 80, False, 0),
    ("D=128", 1, 320, 320, 8, 2, 128, True, 64),
    ("D=32", 2, 200, 200, 4, 2, 32, True, 0),
    # the edges of the kernel's 128-row query and 64-key tiles
    ("Skv ends mid-tile", 1, 256, 300, 32, 8, 80, False, 0),
    ("300 causal", 1, 300, 300, 32, 8, 80, True, 4096),
    ("Sq=40", 2, 40, 40, 32, 8, 80, True, 4096),
    ("window 100 ends mid-tile", 1, 512, 512, 32, 8, 80, True, 100),
    # whisper-small's encoder: 1500 frames, 12 heads of 64, non-causal
    ("1x1500 non-causal", 1, 1500, 1500, 12, 12, 64, False, 0),
]
# q, k, v as strided views of one fused (B, S, (Hq + 2·Hkv)·D) projection
FLASH_VIEW_CASES = [
    ("fused qkv view", 2, 256, 256, 32, 8, 80, True, 4096),
]


def flash_inputs(torch, gen, dev, B, Sq, Skv, Hq, Hkv, D, dtype,
                 fused=False):
    if fused:
        qkv = torch.randn(B, Sq, (Hq + 2 * Hkv) * D, generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1)
        return (q.unflatten(-1, (Hq, D)), k.unflatten(-1, (Hkv, D)),
                v.unflatten(-1, (Hkv, D)))
    q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dtype)
    return q, k, v


def flash_limit(torch, want, dt):
    """The per-element bound on |kernel - plain| for a flash output.
    fp32: 1e-5·(1 + |plain|) (summation order), the rtol and atol of
    tests/test_flash_attention.py. bf16: that test's 2e-2·(1 + |plain|),
    and also 2^-7·|plain| (one bf16 ulp of the final cast) + 2^-5 of the
    row's RMS over D: p is rounded to bf16 against a running max in the
    kernel and the final max in the plain version, two roundings of each
    term that differ by up to 2^-8 of it, which sum as a random walk to
    ~1e-3 of the row's RMS (a few 1e-3 at the tail of 4e7 elements). A
    long row's |o| is only ~sqrt(e/N) (0.026 at N = 4096), so the 2e-2
    form alone could not see an error in the PV product of late rows."""
    w = want.float()
    if dt == "fp32":
        return 1e-5 * (1 + w.abs())
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    return torch.minimum(2e-2 * (1 + w.abs()),
                         2 ** -7 * w.abs() + 2 ** -5 * rms)


def hold_flash(torch, phase, what, dt, dtype, o, lse, o_p, lse_p):
    """The flash kernel's output within ``flash_limit`` of its plain
    version's, element by element, and the log-sum-exp within 1e-4·(1 +
    |lse|) (an fp32 sum of exps in another order); raises otherwise.
    Returns max|d| of the output."""
    err = (o.float() - o_p.float()).abs()
    share = float((err / flash_limit(torch, o_p, dt)).max())
    dl = float(((lse - lse_p).abs() / (1 + lse_p.abs())).max())
    bad = o.dtype != dtype or share > 1 or dl > 1e-4
    tol = FLASH_BF16_TOL if dt == "bf16" else "|d| <= 1e-5*(1+|plain|)"
    log(phase, f"flash_attention {what}: max|d|={float(err.max()):.3e}, "
        f"max |d|/limit={share:.3f}, max|dlse|/(1+|lse|)={dl:.2e} "
        f"{'FAIL' if bad else 'ok'} ({tol}; lse 1e-4)")
    if bad:
        raise AssertionError(f"flash_attention disagrees at {what}")
    return float(err.max())


def check_flash(torch, dev, gen, cases=None):
    """The flash-attention kernel vs its plain version (one full softmax
    per row in the kernel's rounding order) at every phase-3 shape
    (``FLASH_CASES``, then ``FLASH_VIEW_CASES`` on strided views, then
    phase 14's shard-local shapes, ``MESH_TRAIN_FLASH``), or at
    ``cases`` ((label, B, Sq, Skv, Hq, Hkv, D, causal, window), strided
    views), held by ``hold_flash``. Returns the worst bf16 |d| of the
    output."""
    from repro_torch.kernels import flash_attention as fa
    worst = 0.0
    if cases is None:
        cases = [(c, False) for c in FLASH_CASES] \
            + [(c, True) for c in FLASH_VIEW_CASES] \
            + [((label, B, S, S, *rest), False)
               for label, B, S, *rest in MESH_TRAIN_FLASH]
    for (label, B, Sq, Skv, Hq, Hkv, D, causal, window), fused in cases:
        for dt, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = flash_inputs(torch, gen, dev, B, Sq, Skv, Hq, Hkv, D,
                                   dtype, fused=fused)
            o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                                window=window)
            o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window)
            err = hold_flash(
                torch, "kernels", f"{label} {dt} B={B} Sq={Sq} Skv={Skv} "
                f"Hq={Hq} Hkv={Hkv} D={D} causal={causal} window={window}",
                dt, dtype, o, lse, o_p, lse_p)
            if dt == "bf16":
                worst = max(worst, err)
            del q, k, v, o, o_p, lse, lse_p
    return worst


# the Function's gradients at B = 1, S = 256 (phase 3's first length)
# for danube's heads and each family's training heads, a 64-token
# window where the arch has a window, and whisper's encoder non-causal
# over 1500 frames: (label, S, Hq, Hkv, D, causal, window)
FLASH_GRAD_CASES = [
    ("danube", 256, 32, 8, 80, True, 64),
    ("olmoe", 256, 16, 16, 128, True, 0),
    ("mixtral", 256, 32, 8, 128, True, 64),
    ("hymba", 256, 25, 5, 64, True, 64),
    ("internvl2", 256, 14, 2, 64, True, 0),
    ("starcoder2", 256, 36, 4, 128, True, 0),
    ("granite", 256, 48, 1, 128, True, 0),
    ("whisper decoder", 256, 12, 12, 64, True, 0),
    ("whisper encoder", 1500, 12, 12, 64, False, 0),
]
# the Function's tolerances: fp32 sums; bf16 outputs and p rounded at
# different maxima, on unit-scale gradients
FLASH_GRAD_TOL = {"fp32": 1e-5, "bf16": 2e-2}


def flash_grad_cases():
    """``FLASH_GRAD_CASES``, then the training lengths at B = 1: phase
    7(a)'s 2048 tokens at danube's heads, every phase-12 shape
    (``family_flash_shapes``) and every phase-14 shape
    (``MESH_TRAIN_FLASH``) not already listed. Yields (label, S, Hq,
    Hkv, D, causal, window, at the training length)."""
    seen = set()
    for c in FLASH_GRAD_CASES:
        seen.add(c[1:])
        yield (*c, False)
    train = [("danube 4x2048", 2048, 32, 8, 80, True, 4096)] + [
        (label, S, Hq, Hkv, D, causal, window) for label, _, S, Hq, Hkv, D,
        causal, window in [*family_flash_shapes(), *MESH_TRAIN_FLASH]]
    for c in train:
        if c[1:] not in seen:
            seen.add(c[1:])
            yield (*c, True)


def check_flash_grads(torch, dev, gen, cases=None):
    """The FlashAttention Function's dq, dk, dv (kernel forward, PyTorch
    backward from its lse) vs autograd through the plain version in fp64
    on the same input values (the exact gradient), at every
    ``flash_grad_cases`` shape: |d| <= tol·(1 + |g|) with ``FLASH_GRAD_TOL``.
    The reference is exact because a reference in the inputs' dtype
    spends the bound on its own error once G query heads share a KV head:
    each dK element sums G x S rows, and autograd through the bf16 plain
    version also rounds dP to bf16 (1.01x the bf16 bound off the exact dK
    at granite's G = 48, S = 1024, a CPU reading). At the training
    lengths (S = 1024 to 2048, G up to 48) the fp32 sums alone come near
    1e-5: there fp32 autograd through the plain version is measured
    against the exact gradient on the same inputs, and the fp32 tol is
    the larger of 1e-5 and twice that distance (max over the tensor of
    |plain - exact| / (1 + |exact|)). bf16 keeps its tol everywhere.
    ``cases`` in place of ``flash_grad_cases()``: the same tuples."""
    from repro_torch.kernels import flash_attention as fa
    for label, S, Hq, Hkv, D, causal, window, long in (
            flash_grad_cases() if cases is None else cases):
        for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = flash_inputs(torch, gen, dev, 1, S, S, Hq, Hkv, D,
                                   dtype)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            got = torch.autograd.grad(
                fa.flash_attention(q.requires_grad_(), k.requires_grad_(),
                                   v.requires_grad_(), causal=causal,
                                   window=window),
                (q, k, v), do)
            qf, kf, vf = (t.detach().double().requires_grad_()
                          for t in (q, k, v))
            want = torch.autograd.grad(
                fa.flash_attention_plain(qf, kf, vf, causal=causal,
                                         window=window)[0],
                (qf, kf, vf), do.double())
            plain = [None] * 3
            if long and dt == "fp32":
                qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
                plain = torch.autograd.grad(
                    fa.flash_attention_plain(qp, kp, vp, causal=causal,
                                             window=window)[0],
                    (qp, kp, vp), do)
                del qp, kp, vp
            for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
                scale = 1 + w.abs()
                tol, note = FLASH_GRAD_TOL[dt], ""
                if p is not None:
                    rel = float(((p.double() - w).abs() / scale).max())
                    tol = max(tol, 2 * rel)
                    note = f"; fp32 plain {rel:.3e} off exact"
                err = (g.double() - w).abs()
                share = float((err / (tol * scale)).max())
                bad = g.dtype != dtype or share > 1
                log("kernels", f"flash_attention grad {label} {dt} {name} "
                    f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} causal={causal} "
                    f"window={window}: max|d|={float(err.max()):.3e} (max|g| "
                    f"{float(w.abs().max()):.3f}), max |d|/limit "
                    f"{share:.3f}{note} {'FAIL' if bad else 'ok'} "
                    f"(|d| <= {tol:.3g}*(1+|g|))")
                if bad:
                    raise AssertionError(f"flash_attention {name} {label} "
                                         f"{dt} disagrees with autograd")
            del q, k, v, qf, kf, vf, do, got, want, plain


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve(torch, extra, card, base=SERVE_ARGV):
    from repro_torch.launch import serve as launcher
    argv = base + extra
    log("serve", "python -m repro_torch.launch.serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    DECODE_PEAK.update(base=torch.cuda.memory_allocated(), run=0, step=0)
    t0 = time.perf_counter()
    report = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated(), DECODE_PEAK["run"])
    steps = max(len(report.step_records), 1)
    log("serve", f"{report.decode_tokens} decode tokens in "
        f"{report.decode_s:.3f} s = {report.tokens_per_s:.1f} tok/s, "
        f"{report.decode_s / steps * 1e3:.2f} ms/step over {steps} decode "
        f"steps; prefill {report.prefill_s:.3f} s; run {wall:.1f} s; peak "
        f"device memory {peak / 2**30:.2f} "
        f"GiB [{card}]")
    return report


# the decode steps' peak of a ``serve`` run under ``decode_peaks``: the
# baseline before the launcher, the run's peak folded across the resets,
# the highest decode step's peak and the engine's geometry
DECODE_PEAK = {"base": 0, "run": 0, "step": 0}


@contextlib.contextmanager
def decode_peaks(torch):
    """While on, each engine decode step starts from a reset peak counter
    and the highest step's peak is kept in ``DECODE_PEAK`` (the run's
    peak, folded in before each reset, still prints as before), with the
    engine's batch, cache window, pages and attention plan."""
    from repro_torch.runtime.engine import ServingEngine
    decode = ServingEngine._decode

    def measured(self, *args, **kw):
        torch.cuda.synchronize()
        DECODE_PEAK["run"] = max(DECODE_PEAK["run"],
                                 torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        try:
            return decode(self, *args, **kw)
        finally:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            if peak > DECODE_PEAK["step"]:
                DECODE_PEAK.update(
                    step=peak, B=self.max_batch, cache_len=self.cache_len,
                    page_size=self.page_size,
                    num_blocks=self._state["cache"]["kv"].k_pool.shape[1],
                    kv_format=self.kv_format, attn_path=self.attn_path,
                    kv_partitions=self.kv_partitions)
    ServingEngine._decode = measured
    try:
        yield DECODE_PEAK
    finally:
        ServingEngine._decode = decode


def compare_logits(fused, plain, what, gen_len):
    """Prefill logits of a kernel path within LOGIT_TOL of its plain
    path's; greedy streams of the expected length."""
    d = max(float((fused.prefill_logits[r] - plain.prefill_logits[r])
                  .abs().max()) for r in fused.results)
    scale = max(float(plain.prefill_logits[r].abs().max())
                for r in plain.results)
    toks = [(a == b) for r in fused.results
            for a, b in zip(fused.results[r], plain.results[r])]
    firsts = sum(fused.results[r][0] == plain.results[r][0]
                 for r in fused.results)
    # where the first tokens differ, how far the kernel path's pick sits
    # below the plain path's best logit (random weights give flat logits)
    gaps = [float(plain.prefill_logits[r].max()
                  - plain.prefill_logits[r][fused.results[r][0]])
            for r in fused.results
            if fused.results[r][0] != plain.results[r][0]]
    ok = d <= LOGIT_TOL
    log("serve", f"{what}: prefill logits kernels vs plain: max|d|={d:.3e} "
        f"(max|logit| {scale:.2f}; tolerance {LOGIT_TOL}: bf16 rounding "
        f"of every activation, reordered sums, every layer) "
        f"{'ok' if ok else 'FAIL'}; greedy tokens equal "
        f"{sum(toks)}/{len(toks)} ({sum(toks) / len(toks):.1%}), first "
        f"tokens {firsts}/{len(fused.results)}, plain-path logit gap of "
        f"each differing first token {[f'{g:.3e}' for g in gaps]}")
    if not ok:
        raise AssertionError(f"{what}: prefill logits disagree between the "
                             f"kernel path and the plain path")
    for rid, out in fused.results.items():
        if len(out) != gen_len:
            raise AssertionError(f"{what}: request {rid} produced "
                                 f"{len(out)} tokens")


def check_serve(torch, card, table):
    """Phase 4's main-path run (``trace``: counters set to 0 just before
    and read just after; the peak of its last decode steps, outside the
    timed windows, kept for phase 15), then the plain paths on the same
    requests; returns (the run, launches)."""
    reset_counts(table)
    run = trace(torch, card)
    rec = DECODE_PEAK
    fused = run["rep"]
    launches = read_counts(table)
    PEAKS["danube-serve-8x512 decode step"] = (
        rec["step"] - rec["base"],
        {k: rec[k] for k in ("B", "cache_len", "page_size", "num_blocks",
                             "kv_format", "attn_path", "kv_partitions")})
    log("serve", f"launches during the run: {launches}")
    if not (launches["w4a16_gemm"] and launches["paged_attention"]):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    torch.cuda.empty_cache()
    plain = serve(torch, ["--strategy", "reference", "--attn-path",
                          "gather"], card)
    compare_logits(fused, plain, "kernel path", GEN)
    return run, launches


def gemm_path_run(torch, extra, card, expect):
    """One GEMM path's serving run in the family's cell (``FAMILY_ARGV`` +
    ``extra``) on the serve launcher's engine, through ``decode_trace``:
    the requests prefilled, 8 decode steps timed untraced and 4 under
    ``torch.profiler`` (device busy ms a step: decode steps are
    host-bound, so this, not tok/s, is where a faster GEMM shows end to
    end), each launching ``expect``. Returns the run's report."""
    from repro_torch.launch import serve as launcher
    argv = FAMILY_ARGV + extra
    log_built("serve", argv)
    engine, reqs = launcher.build(launcher.build_args(argv))
    rep = decode_trace(torch, engine, reqs, card,
                       " ".join(extra) or "fused w4a16", phase="serve",
                       expect=expect)
    del engine
    torch.cuda.empty_cache()
    return rep


def serve_family(torch, card, table):
    """The GEMM family's serving runs at full width (``main`` cuts their
    depth to ``FAMILY_LAYERS``): the fused
    W4A16 path as the cell's yardstick; each other kernel path against its
    plain GEMM path (attention on its kernel in both), counters set to 0
    just before each kernel-path run and read just after, its decode steps
    traced (``gemm_path_run``: each launching the path's GEMM kernels once a
    linear, 7 a layer, and paged attention once a layer); then
    ``--no-quant``. Returns each kernel's launches from its run."""
    from repro_torch import configs
    t0 = time.perf_counter()
    L = configs.get_config(ARCH).num_layers
    counts = {}
    runs = [([], None, ("w4a16_gemm", "paged_attention"))] + FAMILY_RUNS
    for kernel_argv, plain_argv, names in runs:
        reset_counts(table)
        got = gemm_path_run(torch, kernel_argv, card, {
            n: L if n == "paged_attention" else 7 * L for n in names})
        launched = read_counts(table)
        log("serve", f"launches during the run: {launched}")
        quiet = [n for n in table if n not in names and launched[n]]
        if not all(launched[n] for n in names) or quiet:
            raise AssertionError(f"{' '.join(kernel_argv)}: the path's "
                                 f"kernels {names} must all launch and no "
                                 f"other GEMM kernel: {launched}")
        counts.update({n: launched[n] for n in names
                       if n not in ("paged_attention", "w4a16_gemm")})
        if plain_argv is not None:
            want = serve(torch, plain_argv, card, FAMILY_ARGV)
            compare_logits(got, want, " ".join(kernel_argv), FAMILY_GEN)
            del want
        del got
        torch.cuda.empty_cache()
    gemm_path_run(torch, ["--no-quant"], card,
                  {"w4a16_gemm": 0, "paged_attention": L})
    log("serve", f"GEMM-family runs took {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of ``fn`` with the L2 flushed before each
    launch (a 256 MB buffer is zeroed, five times the 50 MB L2). A wrapper
    issues several device ops (kernel, Split-K sum, cast); if the host
    issued them while the card waited, its launch gaps would land between
    the events. So the card first sleeps while the host queues every timed
    launch, and the events time the card's work only: four times the host
    time the warm-up iterations took to issue (a lazy first call or a host
    sync inside ``fn`` only lengthens it), at least 5 ms and at most 0.1 s
    (``SLEEP_S``; cycles at the card's reported maximum SM clock,
    :func:`sm_clock_hz`, so longer at a lower clock)."""

    SLEEP_S = (0.005, 0.1)

    def __init__(self, torch, dev, iters=25, warmup=3):
        self.torch, self.iters, self.warmup = torch, iters, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        self.hz = sm_clock_hz()

    def __call__(self, fn, setup=None) -> float:
        """``setup`` (untimed) runs after the flush and before ``fn``."""
        torch = self.torch
        t0 = time.perf_counter()
        for _ in range(self.warmup):
            self.flush.zero_()
            if setup is not None:
                setup()
            fn()
        issue = (time.perf_counter() - t0) / self.warmup
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        torch.cuda.synchronize()
        lo, hi = self.SLEEP_S
        torch.cuda._sleep(int(self.hz * min(hi, max(lo, 4 * issue
                                                    * self.iters))))
        for s, e in ev:
            self.flush.zero_()
            if setup is not None:
                setup()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        ts = sorted(s.elapsed_time(e) for s, e in ev)
        return ts[len(ts) // 2]


def gbs(nbytes, ms):
    """Achieved rate: the bytes the function must move over its time."""
    return f"{nbytes / ms / 1e6:.0f} GB/s"


def time_gemms(torch, dev, gen, timer, card):
    from repro_torch.core import costmodel
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    rows = {}
    # the timer's floor: one trivial kernel (a 4-byte fill) between the
    # events; each of a layer's seven GEMMs carries it
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    rows["floor_ms"] = timer(sink.zero_)
    log("timing", f"the timer's floor, one 4-byte fill kernel: "
        f"{rows['floor_ms']:.4f} ms [{card}]")
    for M in (8, 32, VERIFY_M):
        for K, N in DANUBE_GEMMS:
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            s = planned_split(x, qt)
            nbytes = costmodel.w4a16_gemm_bytes(M, N, K)
            flops = costmodel.w4a16_gemm_flops(M, N, K)
            r = dict(nbytes=nbytes, flops=flops,
                     ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                     plain_ms=timer(lambda: w4a16_fused_plain(x, qt,
                                                              split_k=s)),
                     library_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                     bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                     bound_by=costmodel.bound_by(nbytes, flops), split_k=s)
            rows[(M, K, N)] = r
            log("timing", f"w4a16_gemm M={M} K={K} N={N} split_k={s}: "
                f"kernel {r['ms']:.4f} ms, {gbs(nbytes, r['ms'])}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['bound_ms'] / r['ms']:.1%} of roofline), plain "
                f"{r['plain_ms']:.4f} ms, dequant+matmul "
                f"{r['library_ms']:.4f} ms [{card}]")
    for M in (8, 32, VERIFY_M):
        def total(key):
            return sum(rows[(M, K, N)][key] for K, N in LAYER_GEMMS)
        log("timing", f"w4a16_gemm, one layer's 7 GEMMs at M={M}: kernel "
            f"{total('ms'):.4f} ms, bound {total('bound_ms'):.4f} ms, plain "
            f"{total('plain_ms'):.4f} ms, dequant+matmul "
            f"{total('library_ms'):.4f} ms [{card}]")
    return rows


def time_family(torch, dev, gen, timer, card):
    """Phase 5 for the rest of the GEMM family at the danube shapes, bf16,
    M = 8 and 32, the planner's split_k: kernel, plain version, one library
    call (``torch.matmul`` for the dense GEMM; dequantize + ``torch.matmul``
    for the decoupled pipeline, W8A16 and, as its float yardstick, W4A8),
    and each kernel's bound. The decoupled pipeline's bound is given twice:
    its function's (x · Dequant(W): the fused kernel's bytes) and its
    design's (the sum of its three phases' bounds, workspace and partials
    through device memory). Phase 2 is timed cold (workspace flushed from
    the L2) and warm (right after phase 1 wrote it)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core.quant import quantize, quantize_activations_int8
    from repro_torch.kernels import gemm, ref, w4a8_fused, w8a16_fused
    from repro_torch.kernels import w4a16_decoupled as dec
    rows = {}

    def bound(nbytes, flops, int8=False):
        return (cm.roofline_s(nbytes, flops, int8=int8) * 1e3,
                cm.bound_by(nbytes, flops, int8=int8), nbytes, flops)

    def row(name, M, K, N, fn, plain, library, b, extra=""):
        r = dict(ms=timer(fn), plain_ms=timer(plain),
                 library_ms=None if library is None else timer(library),
                 bound_ms=b[0], bound_by=b[1], nbytes=b[2], flops=b[3])
        rows[(name, M, K, N)] = r
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log("timing", f"{name} M={M} K={K} N={N}{extra}: kernel "
            f"{r['ms']:.4f} ms, {gbs(r['nbytes'], r['ms'])}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of roofline), plain "
            f"{r['plain_ms']:.4f} ms, library {lib} [{card}]")
        return r

    bf16 = torch.bfloat16
    for M in (8, 32):
        for K, N in DANUBE_GEMMS:
            w = (torch.randn(K, N, generator=gen, device=dev)
                 * K ** -0.5).to(bf16)
            x = torch.randn(M, K, generator=gen, device=dev).to(bf16)
            qt4, qt8 = quantize(w), quantize(w, "w8a16_channel")
            qta8 = quantize(w, "w4a8_g128")
            sk = family_split(M, N, K)
            flops = cm.w4a16_gemm_flops(M, N, K)
            row("dense_gemm", M, K, N, lambda: gemm.gemm(x, w),
                lambda: gemm.gemm_plain(x, w), lambda: torch.matmul(x, w),
                bound(cm.dense_gemm_bytes(M, N, K), flops))
            # the decoupled pipeline, whole and phase by phase
            ws = dec.dequant_w4(qt4, out_dtype=bf16)
            parts = dec.splitk_gemm(x, ws, split_k=sk)
            fn_bound = bound(cm.w4a16_gemm_bytes(M, N, K), flops)
            t1, t2, t3 = cm.w4a16_decoupled_phases(M, N, K, split_k=sk)
            r = row("w4a16_decoupled", M, K, N,
                    lambda: dec.w4a16_decoupled(x, qt4, split_k=sk),
                    lambda: dec.w4a16_decoupled_plain(x, qt4, split_k=sk),
                    lambda: ref.w4a16_ref(x, qt4), fn_bound,
                    f" split_k={sk}")
            r["design_bound_ms"] = (t1 + t2 + t3) * 1e3
            log("timing", f"w4a16_decoupled M={M} K={K} N={N}: the design's "
                f"bound (three phases through device memory) "
                f"{r['design_bound_ms']:.4f} ms; the kernel at "
                f"{r['design_bound_ms'] / r['ms']:.1%} of it [{card}]")
            row("dequant_w4", M, K, N,
                lambda: dec.dequant_w4(qt4, out_dtype=bf16),
                lambda: dec.dequant_w4_plain(qt4, out_dtype=bf16), None,
                bound(cm.dequant_w4_bytes(K, N), 0.0))
            r = row("splitk_gemm", M, K, N,
                    lambda: dec.splitk_gemm(x, ws, split_k=sk),
                    lambda: dec.splitk_gemm_plain(x, ws, split_k=sk), None,
                    bound(cm.dense_gemm_bytes(M, N, K, out_bytes=0)
                          + 4 * sk * M * N, flops), f" split_k={sk}")
            # warm: phase 2 reads the workspace that phase 1 has just
            # written after the flush (the setup's own output)
            hold = {}
            r["warm_ms"] = timer(
                lambda: dec.splitk_gemm(x, hold["ws"], split_k=sk),
                setup=lambda: hold.__setitem__(
                    "ws", dec.dequant_w4(qt4, out_dtype=bf16)))
            del hold
            log("timing", f"splitk_gemm M={M} K={K} N={N}: right after "
                f"phase 1 wrote the {K * N * 2 / 1e6:.1f} MB workspace "
                f"{r['warm_ms']:.4f} ms (cold {r['ms']:.4f} ms) [{card}]")
            row("reduce_partials", M, K, N,
                lambda: dec.reduce_partials(parts, out_dtype=bf16),
                lambda: dec.reduce_partials_plain(parts, out_dtype=bf16),
                None, bound(cm.reduce_bytes(M, N, sk), 0.0),
                f" split_k={sk}")
            row("w8a16_gemm", M, K, N,
                lambda: w8a16_fused.w8a16_fused(x, qt8),
                lambda: w8a16_fused.w8a16_fused_plain(x, qt8),
                lambda: ref.w4a16_ref(x, qt8),
                bound(cm.w8a16_gemm_bytes(M, N, K), flops))
            r = row("w4a8_gemm", M, K, N,
                    lambda: w4a8_fused.w4a8_fused(x, qta8, split_k=sk),
                    lambda: w4a8_fused.w4a8_fused_plain(x, qta8,
                                                        split_k=sk),
                    lambda: ref.w4a16_ref(x, qta8),
                    bound(cm.w4a8_gemm_bytes(M, N, K, act_bytes=2), flops,
                          int8=True), f" split_k={sk}")
            # the two launches without the GEMM's early start, then the
            # quantize kernel alone
            r["serial_ms"] = timer(lambda: w4a8_fused._launch(
                x, qta8, sk, bf16, overlap=False))
            row("w4a8_quantize", M, K, N,
                lambda: w4a8_fused.w4a8_quantize(x, qta8.group_size),
                lambda: quantize_activations_int8(x), None,
                bound(cm.w4a8_quantize_bytes(M, K, qta8.group_size,
                                             act_bytes=2), 0.0))
            log("timing", f"w4a8_gemm M={M} K={K} N={N}: "
                f"{r['ms']:.4f} ms with the GEMM started while "
                f"the quantize runs, {r['serial_ms']:.4f} ms one after the "
                f"other [{card}]")
            del ws, parts
    return rows


def attn_bytes_flops(torch, c):
    """What the partials function must move for this data: the mapped
    pages' K/V payload (+ scales) and tags, the tables, the queries, the
    fp32 partials; operations: QKᵀ and PV over every key of the mapped
    pages, per query row."""
    from repro_torch.core import costmodel
    tables, fmt, qk = c["tables"], c["fmt"], c["qk"]
    hkv, _, d = c["heads"]
    page = c["page"]
    mapped = int((tables >= 0).sum())               # (slot, page) pairs
    per_tok = costmodel.kv_bytes_per_token(hkv, d, quantized=fmt.quantized)
    kv = mapped * page * per_tok
    B, _, QT, QG, _ = qk.shape
    q_in = qk.numel() * qk.element_size() + tables.numel() * 4 \
        + c["positions"].numel() * 4
    parts = c["planned"]
    out = B * hkv * QT * parts * QG * (d + 2) * 4
    flops = 4.0 * mapped * page * QT * QG * d * hkv
    return kv + q_in + out, flops


def time_attn_case(torch, timer, c, window, label, card):
    """Phase 5's row for one paged-attention case at the planned
    kv_partitions: the kernel, its plain version, and gather_window +
    SDPA (one library call over the gathered window), beside the bound."""
    import torch.nn.functional as F
    from repro_torch.core import costmodel
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime import kvcache as kvc
    kw = dict(Tq=c["Tq"], G=c["G"], S=c["planned"], window=window,
              fmt=c["fmt"])
    args = (c["qk"], c["positions"], c["start"], c["pool"], c["tables"])
    q = c["q"].permute(0, 2, 1, 3)                       # (B, Hq, C, D)

    def library():
        win = kvc.gather_window(c["pool"], c["tables"], fmt=c["fmt"],
                                out_dtype=torch.bfloat16)
        kp, qp = win.pos[:, None, None, :], c["positions"][:, None, :, None]
        mask = (kp >= 0) & (kp <= qp) \
            & (kp < c["start"][:, None, None, None]) & (kp > qp - window)
        return F.scaled_dot_product_attention(
            q, win.k.permute(0, 2, 1, 3), win.v.permute(0, 2, 1, 3),
            attn_mask=mask, enable_gqa=True)

    nbytes, flops = attn_bytes_flops(torch, c)
    window = window or 1 << 30          # 0: full attention (the mask's)
    r = dict(ms=timer(lambda: pa._launch_partials(*args, **kw)),
             plain_ms=timer(lambda: pa.pooled_partials_plain(*args, **kw)),
             library_ms=timer(library),
             bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
             bound_by=costmodel.bound_by(nbytes, flops),
             kv_partitions=c["planned"])
    log("timing", f"paged_attention {label} B={c['B']} C={c['C']} "
        f"{c['fmt'].name} kv_partitions={c['planned']}: kernel "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{r['bound_ms'] / r['ms']:.1%} of roofline), plain "
        f"{r['plain_ms']:.4f} ms, gather+sdpa {r['library_ms']:.4f} ms "
        f"[{card}]")
    return r


def time_attention(torch, dev, gen, timer, card):
    rows = {}
    for kind in ("decode", "chunk", "verify"):
        c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind)
        rows[kind] = time_attn_case(torch, timer, c, 4096, kind, card)
    return rows


# the training shapes of the flash kernel: phase 7(a)'s and the launcher's
FLASH_TIMED = [("4x2048 causal", 4, 2048), ("2x8192 window 4096", 2, 8192)]


def time_flash(torch, dev, gen, timer, card):
    """Phase 5's flash rows at the two training shapes (danube heads,
    bf16, window 4096): the kernel forward, the Function's forward plus
    backward, the plain version, and ``F.scaled_dot_product_attention``
    (``enable_gqa``; ``is_causal`` where the window does not bite, an
    explicit SWA mask where it does) forward and forward plus backward,
    beside the forward's bound. The SDPA call is timed only: the port
    never calls it."""
    import torch.nn.functional as F
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import flash_attention as fa
    rows = {}
    for label, B, S in FLASH_TIMED:
        q, k, v = flash_inputs(torch, gen, dev, B, S, S, 32, 8, 80,
                               torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        pos = torch.arange(S, device=dev)
        mask = None if S <= 4096 else \
            (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                              - 4096)
        qt, kt, vt = (t.transpose(1, 2) for t in (qg, kg, vg))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        def sdpa_fb():
            return torch.autograd.grad(sdpa(), (qg, kg, vg),
                                       do.transpose(1, 2))

        def fb():
            return torch.autograd.grad(
                fa.flash_attention(qg, kg, vg, causal=True, window=4096),
                (qg, kg, vg), do)

        pairs = cm.attn_pairs(S, S, causal=True, window=4096)
        nbytes = cm.flash_attn_bytes(B, S, S, 32, 8, 80)
        flops = cm.flash_attn_flops(B, 32, 80, pairs)
        r = dict(ms=timer(lambda: fa.flash_attention_forward(
                     q, k, v, causal=True, window=4096)),
                 fb_ms=timer(fb),
                 plain_ms=timer(lambda: fa.flash_attention_plain(
                     q, k, v, causal=True, window=4096)),
                 library_ms=timer(sdpa), library_fb_ms=timer(sdpa_fb),
                 bound_ms=cm.roofline_s(nbytes, flops) * 1e3,
                 bound_by=cm.bound_by(nbytes, flops))
        rows[label] = r
        log("timing", f"flash_attention {label} (B={B}, S={S}, 32/8 heads "
            f"of 80, bf16): kernel forward {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of roofline, "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s); Function forward + "
            f"backward {r['fb_ms']:.4f} ms (backward ~"
            f"{r['fb_ms'] - r['ms']:.4f}); plain {r['plain_ms']:.4f} ms; "
            f"sdpa {r['library_ms']:.4f} ms forward, "
            f"{r['library_fb_ms']:.4f} ms forward + backward [{card}]")
        del q, k, v, do, qg, kg, vg, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return rows


def trace(torch, card):
    """Phase 4's counted run (``SERVE_ARGV`` on the serve launcher's
    engine, driven through the engine's stepper API) with phase 6's
    windows: where a step's time goes. Engine step 0 (pure prefill: one
    32-token chunk for each of 8 slots) runs under ``torch.profiler``;
    steps 1-8 (prefill, the same kind of step) run untraced, timed to a
    sync; then, after the first decode, 10 untraced decode steps are timed
    and the next 4 decode steps are traced; the rest run untraced. The
    profiler slows the host but not the device, so the idle share is the
    traced device busy time per step against the untraced wall time per
    step. The rest of the run (its last, longest decode steps) runs under
    ``decode_peaks``, whose highest step phase 15 reads. Returns the run (its report, first decode step's logits,
    attention path and window), which phase 4 holds against the plain
    paths and phase 16 the ring engine against."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as launcher
    table = kernel_table()
    log_built("serve", SERVE_ARGV, " with phase 6's trace windows")
    torch.cuda.reset_peak_memory_stats()
    DECODE_PEAK.update(base=torch.cuda.memory_allocated(), run=0, step=0)
    t_run = time.perf_counter()
    engine, reqs = launcher.build(launcher.build_args(SERVE_ARGV))
    step0 = first_step_logits(engine)
    engine.start()
    for r in reqs:
        engine.submit(r)

    def run(n, traced=False):
        """Up to ``n`` engine steps, timed to a sync: (steps, ms/step,
        profiler or None, the counters before and after)."""
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if traced \
            else None
        torch.cuda.synchronize()
        done = 0
        n0 = read_counts(table)
        t0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            while done < n and engine.has_work():
                engine.step()
                done += 1
            torch.cuda.synchronize()
        return done, (time.perf_counter() - t0) * 1e3 / max(done, 1), prof, \
            (n0, read_counts(table))

    def report(name, steps, traced_ms, untraced_ms, prof, counts):
        events = prof.key_averages()
        dev = sorted((e for e in events if e.device_type != DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)
        recorded_launches(dev, *counts, name, "trace")
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
        launches = sum(e.count for e in dev) / steps
        w4 = [e for e in dev if "tc_gemm_kernel" in e.key
              and "Int4Ring" in e.key]
        w4_ms = sum(e.self_device_time_total for e in w4) / 1e3 / steps
        w4_n = sum(e.count for e in w4) / steps
        log("trace", f"{name}: device busy {busy:.3f} ms/step over {steps} "
            f"traced steps ({launches:.0f} device ops/step); wall "
            f"{untraced_ms:.3f} ms/step untraced ({traced_ms:.3f} traced) "
            f"-> device idle {1 - busy / untraced_ms:.1%}; the fused W4A16 "
            f"kernel {w4_ms:.3f} ms/step ({w4_ms / max(busy, 1e-9):.1%} "
            f"of device "
            f"time, {w4_n:.0f} of the device ops) [{card}]")
        for e in dev[:6]:
            log("trace", f"  {name} device "
                f"{e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
                f"x{e.count / steps:<6.0f} {e.key[:80]}")
        for e in host[:6]:
            log("trace", f"  {name} host   "
                f"{e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step  "
                f"x{e.count / steps:<6.0f} {e.key[:80]}")

    pf_steps, pf_traced, pf_prof, pf_counts = run(1, traced=True)
    pf_ms = run(8)[1]
    while engine.report.decode_tokens == 0:
        engine.step()
    dec_ms = run(10)[1]
    dec_steps, dec_traced, dec_prof, dec_counts = run(4, traced=True)
    if dec_steps != 4:
        raise AssertionError(f"the traced decode window ran {dec_steps} "
                             f"steps, not 4")
    with decode_peaks(torch):
        rep = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    run = dict(rep=rep, step0=step0, path=engine.attn_path,
               cache_len=engine.cache_len)
    steps = max(len(rep.step_records), 1)
    log("serve", f"{len(rep.results)} requests in {rep.steps} steps, "
        f"{rep.decode_tokens} decode tokens; untraced prefill "
        f"{pf_ms:.1f} ms/step, decode {dec_ms:.2f} ms/step; over the run "
        f"(5 of its steps traced) prefill {rep.prefill_s:.3f} s, decode "
        f"{rep.decode_s / steps * 1e3:.2f} ms/step; pages peak "
        f"{rep.peak_pages}; run with the build {wall:.1f} s [{card}]")
    report("prefill", pf_steps, pf_traced, pf_ms, pf_prof, pf_counts)
    report("decode", dec_steps, dec_traced, dec_ms, dec_prof, dec_counts)
    return run


# ---------------------------------------------------------------------------
# phase 7: train
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 8192
TRAIN_ARGV = ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
PEAK_BF16 = 989e12
# phase 7(a): kernel path vs plain path over 2 steps. Loss and grad norm,
# relative: the two attention orders (the kernel's online softmax vs the
# chunked one's, p rounded at different maxima) differ by bf16 ulps of
# each attention output, which average out in both (readings ~1e-5 and
# ~1e-4, room of 10x). Moments after step 2, per leaf, max|d| normalized
# by the leaf's largest |value|: the bf16 gradients differ by a few bf16
# steps of each element; v squares them. The parameters are not held:
# within warmup (lr scale 0, then 0.01) an update of ~1e-5 sits below a
# bf16 step of the weights, so they could differ only by a rounding flip
# whatever the gradients; m and v hold the gradients instead.
TRAIN_TOL = {"loss": 2e-4, "grad_norm": 2e-3, "m": 5e-2, "v": 1e-1}


def max_rel_diff(torch, got, want):
    """max over leaves of max|got - want| / max|want| (leaves of ``got``
    may lie on the host)."""
    from repro_torch.core.tree import tree_flatten_with_keys
    worst, where = 0.0, ""
    g_leaves = dict(tree_flatten_with_keys(got))
    for key, ref in tree_flatten_with_keys(want):
        ref = ref.float()
        g = g_leaves[key].to(ref.device).float()
        d = float((g - ref).abs().max()) / max(float(ref.abs().max()),
                                               1e-30)
        if d > worst:
            worst, where = d, "/".join(key)
    return worst, where


def train_compare(torch, dev, card, table):
    """Phase 7(a): two train steps (``make_train_step``, B=4 x 2048 tokens,
    full width and depth, the parameters of seed 0, the same batches)
    through the flash kernel and through the plain chunked attention (the
    JAX trainer's), held by phase 12's ``compare_paths``. Any kernel error
    raises here, before the launcher's runner would retry it."""
    from repro_torch import configs
    from repro_torch.data import SyntheticTokenStream
    cfg = configs.get_config(ARCH)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=2048,
                                  batch_size=4, device=dev)
    batches = [stream.batch_at(i) for i in range(FAMILY_STEPS)]
    compare_paths(torch, dev, cfg, batches, table, "danube", phase="train")
    torch.cuda.empty_cache()


def tree_to(torch, tree, device):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _ckpt_bytes(cfg) -> int:
    """One checkpoint of the launcher's run: bf16 params, fp32 m and v."""
    n = cfg.param_count()
    return n * 2 + 2 * n * 4


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("MemAvailable missing from /proc/meminfo")


def run_launcher(torch, card, table, phase, argv):
    """``python -m repro_torch.launch.train`` with ``argv`` (full width
    and depth), checkpoints into a temporary directory that is removed
    afterwards, after checking there is room for two checkpoints on disk
    and one in host RAM. Checks the history (a checkpoint at each step the
    runner saves: every ``--ckpt-every``, and the last), the flash kernel
    alone launching 2 x the attention layers a step (forward and remat
    recompute), finite losses, and each checkpoint at least 10 B a
    parameter (bf16 weights, fp32 m and v). Returns the report, the
    launches and the peak device memory."""
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.launch import train as launcher
    args = launcher.build_args(argv)
    cfg = configs.get_config(args.arch)
    ckpt = _ckpt_bytes(cfg)
    tmp_root = tempfile.gettempdir()
    free, avail = shutil.disk_usage(tmp_root).free, _mem_available()
    log(phase, f"checkpoints of {ckpt / 1e9:.2f} GB each: {free / 1e9:.1f} "
        f"GB free under {tmp_root}, {avail / 1e9:.1f} GB host RAM available")
    if free < 2.2 * ckpt or avail < 1.5 * ckpt:
        raise RuntimeError(
            f"{args.arch} needs room for two {ckpt / 1e9:.1f} GB checkpoints "
            f"({2.2 * ckpt / 1e9:.1f} GB free disk under {tmp_root}) and "
            f"{1.5 * ckpt / 1e9:.1f} GB of host RAM to stage one; found "
            f"{free / 1e9:.1f} GB and {avail / 1e9:.1f} GB")
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = argv + ["--ckpt-dir", d]
        log(phase, "python -m repro_torch.launch.train " + " ".join(argv))
        reset_counts(table)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        report = launcher.main(argv)
        peak = torch.cuda.max_memory_allocated()
        PEAKS[f"{args.arch}-train-{args.batch}x{args.seq} launcher"] = (
            peak - base, dict(B=args.batch, S=args.seq,
                              microbatches=args.microbatches))
        launched = read_counts(table)
        sizes = {name: sum(f.stat().st_size
                           for f in os.scandir(os.path.join(d, name)))
                 for name in sorted(os.listdir(d))}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    saves = [("checkpoint", s) for s in range(args.steps)
             if s % args.ckpt_every == 0 or s == args.steps - 1]
    attn_layers = cfg.num_layers + cfg.encoder_layers
    want = args.steps * 2 * attn_layers
    log(phase, f"{args.arch} launcher: history {report.history}; losses "
        f"{[f'{l:.4f}' for l in report.losses]}; grad norm "
        f"{[f'{g:.3f}' for g in report.grad_norms]}; step ms "
        f"{[f'{t * 1e3:.1f}' for t in report.step_s]}; launches {launched} "
        f"(want {want} flash: 2 x {attn_layers} attention layers a step, "
        f"forward and remat recompute); checkpoints " + "; ".join(
            f"{n} {b / 1e9:.4f} GB" for n, b in sizes.items())
        + f" (at least {ckpt / 1e9:.4f} GB: 10 B x "
        f"{cfg.param_count() / 1e9:.4f} B params); save to the next step's "
        f"start " + "; ".join(f"step {s} {report.after_step_s[s]:.1f} s"
                              for _, s in report.history) + f" [{card}]")
    if report.history != saves or launched["flash_attention"] != want \
            or any(c for n, c in launched.items() if n != "flash_attention"):
        raise AssertionError(f"the {args.arch} launcher's run went other "
                             f"than planned: history must be {saves}, and "
                             f"the flash kernel alone must launch, {want} "
                             f"times")
    if len(report.losses) != args.steps or not all(
            l == l and abs(l) < 1e4 for l in report.losses):
        raise AssertionError(f"losses {report.losses}")
    if len(sizes) != len(saves) or min(sizes.values()) < ckpt:
        raise AssertionError(f"checkpoints {sizes}, each at least {ckpt} B")
    return report, launched, peak


def train_launcher(torch, card, table):
    """Phase 7(b): the port's training launcher (``run_launcher``) at
    full width and depth, 2 x 8192 tokens (danube's long-context length:
    SWA bites), 4 steps, checkpoints at steps 0 and 3. Returns the flash
    kernel's launches in the run."""
    from repro_torch import configs
    from repro_torch.core import costmodel as cm
    cfg = configs.get_config(ARCH)
    report, launched, peak = run_launcher(torch, card, table, "train",
                                          TRAIN_ARGV)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sorted(report.step_s[1:])[len(report.step_s[1:]) // 2]
    pairs = cm.attn_pairs(TRAIN_SEQ, TRAIN_SEQ, causal=True,
                          window=cfg.sliding_window)
    flops = 6.0 * cfg.param_count() * tokens + 12.0 * cfg.num_layers \
        * TRAIN_BATCH * cfg.num_heads * cfg.head_dim * pairs
    log("train", f"{cfg.param_count() / 1e9:.3f} B params, {tokens} tokens "
        f"a step: median of steps 1-3 {step_s * 1e3:.1f} ms = "
        f"{tokens / step_s:.0f} tokens/s, MFU {flops / step_s / PEAK_BF16:.1%}"
        f" of 989 TFLOP/s (6·N·T + 12·L·B·Hq·D·pairs = {flops:.4g} FLOP, "
        f"remat recompute not counted); peak device memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return launched["flash_attention"], step_s


def trace_train(torch, dev, card, step_s):
    """Phase 7(c): where a training step's time goes, at the launcher's
    shape (full width and depth, 2 x 8192 tokens, flash attention): one
    warm-up step, then one step under ``torch.profiler`` (device activity
    only). Device time is grouped into the flash kernel, matrix products
    (kernels named gemm / xmma / cutlass) and the rest; the idle share is
    the traced busy time against the untraced wall time of the same step,
    ``step_s``: the launcher's median step (7(b))."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(configs.get_config(ARCH), attn_impl="flash")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt_cfg)
    step_fn = steps.make_train_step(cfg, opt_cfg)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  device=dev)

    def one(i):
        nonlocal params, state
        params, state, _ = step_fn(params, state,
                                   {"batch": stream.batch_at(i), "step": i})
        torch.cuda.synchronize()

    one(0)
    wall = step_s * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one(1)
    dev_ev = sorted((e for e in prof.key_averages()
                     if e.device_type != DeviceType.CPU),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    groups = {"flash kernel": 0.0, "matrix products": 0.0, "other": 0.0}
    for e in dev_ev:
        key = e.key.lower()
        g = "flash kernel" if "flash_fwd" in key else "matrix products" \
            if any(w in key for w in ("gemm", "xmma", "cutlass")) \
            else "other"
        groups[g] += e.self_device_time_total / 1e3
    ops = sum(e.count for e in dev_ev)
    log("train", f"one step at {TRAIN_BATCH} x {TRAIN_SEQ}: device busy "
        f"{busy:.1f} ms ({ops} device ops) against {wall:.1f} ms untraced "
        f"(the launcher's median step) -> device idle {1 - busy / wall:.1%}; " + "; ".join(
            f"{g} {t:.1f} ms ({t / busy:.1%})" for g, t in groups.items())
        + f" [{card}]")
    for e in dev_ev[:10]:
        log("train", f"  device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")
    del params, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: serve features (speculation, prefix sharing, the front door)
# ---------------------------------------------------------------------------

FEAT_GEN = 16
# phase 8 serves danube's first 12 of 24 layers, paying for phase 14's
# elastic run and phase 15 (every run of the phase is per layer)
FEATURE_LAYERS = 12
FEAT_KW = dict(max_batch=8, max_prompt_len=512, max_new_tokens=FEAT_GEN,
               page_size=8, prefill_chunk=32, kv_format="kv_fp16")


def feature_prompts(shared=384):
    """8 prompts of 512 tokens: a ``shared``-token prefix they all share
    (one 64-token sequence repeated) and a tail of each one's own (a
    64-token sequence repeated). The repeats give the ngram proposer its
    matches, the prefix gives sharing its pages. 384 lies on the 32-token
    chunk grid; 392 does not, so a slot adopting the prefix starts its
    first chunk mid-grid."""
    import numpy as np
    rng = np.random.default_rng(8)
    prefix = np.resize(rng.integers(0, 32000, 64), shared)
    return [np.concatenate([prefix, np.resize(rng.integers(0, 32000, 64),
                                              512 - shared)])
            .astype(np.int32) for _ in range(8)]


def feature_requests(prompts, gen=FEAT_GEN):
    from repro_torch.runtime.engine import Request
    return [Request(rid=i, prompt=p, max_new_tokens=gen)
            for i, p in enumerate(prompts)]


def capture_verify(engine, table, kernels=("w4a16_gemm", "paged_attention")):
    """Record each verify step the engine runs: the active rows' rids, the
    step's tokens, positions, argmax and logits. Returns ``(records,
    quiet)``: ``quiet`` lists the verify steps during which the launch
    count of one of ``kernels`` (the W4A16 GEMM and paged attention) did
    not rise (the verify step itself, not the prefill chunks around it,
    must run them)."""
    records, quiet = [], []
    make = engine._verify_step

    def verify_step(live_pages=None):
        fn = make(live_pages)

        def call(params, state, inputs):
            before = read_counts(table)
            out = fn(params, state, inputs)
            after = read_counts(table)
            idle = [k for k in kernels if after[k] == before[k]]
            if idle:
                quiet.append((len(records), idle))
            rids = [s.req.rid if s is not None and s.phase == "active"
                    else None for s in engine._slots]
            # the compiled step's logits are a static buffer the next
            # verify step overwrites
            records.append((rids, inputs["tokens"].cpu(),
                            inputs["positions"].cpu(), out["next"].cpu(),
                            out["logits"].clone()))
            return out
        return call

    engine._verify_step = verify_step
    return records, quiet


def check_verify_path(engine, records, quiet, what):
    """The verify steps ran the fused attention kernel and the W4A16 GEMM,
    every one of them."""
    log("features", f"{what}: verify attention {engine.verify_attn_path}; "
        f"{len(records) - len(quiet)}/{len(records)} verify steps launched "
        f"both w4a16_gemm and paged_attention "
        f"{'FAIL' if quiet or engine.verify_attn_path != 'fused' else 'ok'}")
    if engine.verify_attn_path != "fused":
        raise AssertionError(f"{what}: verify attention planned "
                             f"{engine.verify_attn_path!r}, not 'fused'")
    if quiet or not records:
        raise AssertionError(f"{what}: verify steps that launched no "
                             f"kernel of the path: {quiet[:8]}")


def capture_draft(torch, engine):
    """Keep the draft proposer's logits by (rid, input position), the
    newest round's winning: the draft's token for position q + 1 is the
    argmax of its row at q."""
    kept = {}
    fn = engine.proposer._step_fn

    def step(params, inputs):
        res = fn(params, inputs)
        pos = inputs["pos"].cpu()
        for i, s in enumerate(engine._slots):
            if s is not None and s.phase == "active":
                kept[(s.req.rid, int(pos[i]))] = res["logits"][i].to(
                    torch.float32, copy=True)
        return res

    engine.proposer._step_fn = step
    return kept


def explain_rejects(records, draft_logits, what):
    """At every rejected draft, how far apart the two choices were: the
    verify step's margin of its own argmax over the draft's token, the
    draft's margin of its token over the verify step's choice, and the
    largest difference between the two logit rows. A reject with both
    margins within LOGIT_TOL is a near-tie that bf16 rounding on either
    path can flip."""
    rows = []
    for rids, tok, pos, nxt, logits in records:
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            n = int((pos[i] >= 0).sum()) - 1
            a = 0
            while a < n and int(tok[i, a + 1]) == int(nxt[i, a]):
                a += 1
            if a == n:
                continue
            q, d, v = int(pos[i, a]), int(tok[i, a + 1]), int(nxt[i, a])
            vl = logits[i, a].float()
            dl = draft_logits[(rid, q)]
            rows.append((rid, q, float(vl[v] - vl[d]), float(dl[d] - dl[v]),
                         float((dl - vl).abs().max())))
    for rid, q, vm, dm, gap in rows[:16]:
        log("features", f"{what} reject at rid {rid} position {q}: verify "
            f"margin {vm:.4f}, draft margin {dm:.4f}, draft vs verify row "
            f"max|d| {gap:.4f}")
    ties = sum(vm <= LOGIT_TOL and dm <= LOGIT_TOL for _, _, vm, dm, _ in rows)
    log("features", f"{what}: {len(rows)} rejects, {ties} of them near-ties "
        f"(both margins <= {LOGIT_TOL}); largest verify margin "
        f"{max((r[2] for r in rows), default=0.0):.4f}, largest draft "
        f"margin {max((r[3] for r in rows), default=0.0):.4f}")


def check_acceptance(records, results, pos0, what, phase="features"):
    """Exact greedy acceptance: every token a request emitted after its
    first (which prefill gives) is the verify step's own argmax at the
    position before it, reached through drafts that each equal the argmax
    before them. Returns {(rid, position): logits} of every cell whose
    inputs were committed tokens (the accepted drafts and the bonus)."""
    argmax, cells = {}, {}
    for rids, tok, pos, nxt, logits in records:
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            n = int((pos[i] >= 0).sum()) - 1          # drafts scored
            a = 0
            while a < n and int(tok[i, a + 1]) == int(nxt[i, a]):
                a += 1
            for c in range(a + 1):
                q = int(pos[i, c])
                argmax[(rid, q + 1 - pos0)] = int(nxt[i, c])
                cells[(rid, q)] = logits[i, c]
    bad = [(rid, j) for rid, out in results.items()
           for j in range(1, len(out)) if argmax.get((rid, j)) != out[j]]
    extra = len(argmax) - sum(len(out) - 1 for out in results.values())
    log(phase, f"{what}: exact acceptance over {len(records)} verify "
        f"steps: {len(argmax)} emitted tokens each the verify step's argmax "
        f"at its position, {len(bad)} not, {extra} unaccounted "
        f"{'ok' if not bad and not extra else 'FAIL'}")
    if bad or extra:
        raise AssertionError(f"{what}: tokens that are not the verify "
                             f"step's argmax: {bad[:8]}")
    return cells


def force_streams(torch, engine, streams):
    """Teacher-force a plain engine onto ``streams`` (rid → tokens): its
    first tokens and each decode step's choices are replaced by the
    streams', and each step's logits kept by (rid, input position)."""
    kept = {}
    flush = engine._flush_first_tokens

    def flush_forced(pending):
        flush(pending)
        for slot, _ in pending:
            slot.tokens[0] = int(streams[slot.req.rid][0])

    make = engine._serve_step

    def serve_step(live_pages=None):
        fn = make(live_pages)

        def call(params, inputs):
            out = fn(params, inputs)
            forced = out["next"].cpu()
            pos = inputs["pos"].cpu()
            for i, s in enumerate(engine._slots):
                if s is not None and s.phase == "active":
                    kept[(s.req.rid, int(pos[i]))] = \
                        out["logits"][i].clone()
                    forced[i] = int(streams[s.req.rid][len(s.tokens)])
            out["next"] = forced.to(out["next"].device)
            return out
        return call

    engine._flush_first_tokens = flush_forced
    engine._serve_step = serve_step
    return kept


def logit_gap(cells, kept):
    """max |d| between verify-cell logits and the replayed decode's."""
    return max(float((cells[key].float() - kept[key].float()).abs().max())
               for key in cells)


def check_sharing(torch, shared, unshared, prompts, what):
    """Shared against unshared runs of the same requests: pages and
    prefill steps saved equal to the CPU count of the same schedule,
    first-token logits within LOGIT_TOL."""
    d = max(float((shared.prefill_logits[r] - unshared.prefill_logits[r])
                  .abs().max()) for r in shared.results)
    saved = (unshared.peak_pages - shared.peak_pages,
             shared.prefill_steps_saved)
    cpu = cpu_page_counts(torch, prompts)
    want = (cpu[False][0] - cpu[True][0], cpu[True][1])
    ok = d <= LOGIT_TOL and saved == want and saved[0] > 0
    log("features", f"prefix sharing, {what}: pages saved {saved[0]} (peak "
        f"{shared.peak_pages} vs {unshared.peak_pages}), prefill steps "
        f"saved {saved[1]}; the CPU count of the same schedule {want}; "
        f"first-token logits shared vs unshared max|d|={d:.3e} "
        f"(tolerance {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"prefix sharing disagrees ({what})")


def cpu_page_counts(torch, prompts):
    """The phase's sharing schedule on the CPU at a tiny width (danube's
    window and serving settings, 1 layer, d_model 64): page bookkeeping
    depends on positions and prompt content, not on width or generated
    tokens. Returns {share_prefix: (peak pages, prefill steps saved)}."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import ServingEngine
    cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=1,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              head_dim=16, d_ff=128, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device="cpu"), cfg,
                               min_size=0)
    out = {}
    for share in (True, False):
        rep = ServingEngine(cfg, params, share_prefix=share, device="cpu",
                            **FEAT_KW).run(feature_requests(prompts))
        out[share] = (rep.peak_pages, rep.prefill_steps_saved)
    return out


def step_times(torch, spec_engine, plain_engine, card):
    """One verify step (8 slots x 5 positions, the GEMMs at M = 40)
    against one decode step (8 x 1, M = 8) at position 512, every slot's
    66 pages mapped on a fresh pool: the device busy time and device ops
    a step from ``torch.profiler`` (phase 6's method), and the median
    time between CUDA events around a step after the card slept ~1.5 s
    while the host queued 5 steps. A step is ~2400–3300 launches, more
    than the host can queue ahead of a sleeping card, so where the event
    time exceeds the busy time the card waited on the host's launches:
    that number is the step's launch-bound time, not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import steps as rsteps
    dev = spec_engine.device
    B, C = 8, SPEC_K + 1
    state = spec_engine._init_state()
    tables = (1 + torch.arange(B * spec_engine.pages_slot, device=dev,
                               dtype=torch.int32)
              ).reshape(B, spec_engine.pages_slot)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tok = torch.randint(0, 32000, (B, C), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = 512 + torch.arange(C, device=dev, dtype=torch.int32).expand(B, C)
    # the engines' own step functions, built afresh (the runs wrapped
    # theirs with host-side recording)
    verify = rsteps.make_verify_step(
        spec_engine.cfg, spec_engine.cache_len, kv_format="kv_fp16",
        attn_path=spec_engine.verify_attn_path,
        kv_partitions=spec_engine.verify_kv_partitions)
    decode = rsteps.make_serve_step(
        plain_engine.cfg, cache_len=plain_engine.cache_len,
        kv_format="kv_fp16", attn_path=plain_engine.attn_path,
        kv_partitions=plain_engine.kv_partitions)
    vin = {"tokens": tok, "positions": pos.contiguous(), "tables": tables}
    din = {"state": state, "tokens": tok[:, 0].contiguous(),
           "pos": pos[:, 0].contiguous(), "tables": tables}
    steps = {"verify": lambda: verify(spec_engine.params, state, vin),
             "decode": lambda: decode(plain_engine.params, din)}
    rows = {}
    with torch.no_grad():
        for name, fn in steps.items():
            for _ in range(2):
                fn()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(5)]
            torch.cuda.synchronize()
            torch.cuda._sleep(3_000_000_000)
            for s, e in ev:
                s.record()
                fn()
                e.record()
            torch.cuda.synchronize()
            ms = sorted(s.elapsed_time(e) for s, e in ev)[2]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            devs = [e for e in prof.key_averages()
                    if e.device_type != DeviceType.CPU]
            busy = sum(e.self_device_time_total for e in devs) / 1e3 / 3
            ops = sum(e.count for e in devs) / 3
            rows[name] = (ms, busy, ops)
            log("features", f"{name} step ({B} slots x "
                f"{C if name == 'verify' else 1} positions at 512): device "
                f"busy {busy:.3f} ms, {ops:.0f} device ops; "
                f"{ms:.3f} ms between CUDA events"
                f"{' (launch-bound)' if ms > 1.2 * busy else ''} [{card}]")
    (vm, vb, vo), (dm, db, do) = rows["verify"], rows["decode"]
    log("features", f"verify / decode step: {vb / db:.2f}x the busy time, "
        f"{vo / do:.2f}x the ops, {vm / dm:.2f}x the event time; busy per "
        f"position scored {vb / (B * C):.3f} vs {db / B:.3f} ms [{card}]")
    return rows


async def _post_sse(port, prompt, gen, *, hang_up=False):
    """One client: POST a prompt, read the SSE stream (or hang up after
    the first token event); returns (status, payload)."""
    import asyncio
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": gen}).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    if hang_up:
        head = await reader.readuntil(b"\r\n\r\n")
        first = await reader.readuntil(b"\r\n\r\n")
        writer.close()
        await writer.wait_closed()
        return int(head.split(b" ", 2)[1]), head + first
    payload = await reader.read()
    writer.close()
    return int(payload.split(b" ", 2)[1]), payload


def front_door(torch, dev, cfg, params, card):
    """(c): the HTTP front door on 127.0.0.1 over a full-width engine: 5
    SSE clients queued before the driver starts (the 4 that stay must
    stream ``engine.run``'s tokens, compared by prefill logits where they
    do not), one hanging up after its first token, a sixth refused with
    429 (queue depth 5), and ``GET /metrics`` against the report."""
    import asyncio
    import numpy as np
    from repro_torch.runtime.engine import Request, ServingEngine
    from repro_torch.runtime.frontdoor import (FrontDoor, QueueSettings,
                                               sse_decode_tokens)
    gen_len, plen = 8, 64
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 32000, plen).astype(np.int32)
               for _ in range(5)]
    engine = ServingEngine(cfg, params, max_batch=8, max_prompt_len=plen,
                           max_new_tokens=gen_len, page_size=8,
                           prefill_chunk=32, admission="priority",
                           device=dev)
    ref = engine.run([Request(rid=i, prompt=p, max_new_tokens=gen_len)
                      for i, p in enumerate(prompts)])
    ref_logits = dict(ref.prefill_logits)
    fd = FrontDoor(engine, settings=QueueSettings(queue_depth=5))

    async def main():
        await fd.serve(start_driver=False)
        tasks = [asyncio.create_task(_post_sse(fd.port, p, gen_len,
                                               hang_up=i == 4))
                 for i, p in enumerate(prompts)]
        while len(fd.queue) < 5:
            await asyncio.sleep(0.01)
        refused = await _post_sse(fd.port, prompts[0], gen_len)
        fd.start_driver()
        outs = await asyncio.gather(*tasks)
        while fd._streams or engine.has_work():
            await asyncio.sleep(0.02)
        metrics = await _post_metrics(fd.port)
        return outs, refused, metrics, await fd.shutdown()

    outs, refused, metrics, report = asyncio.run(
        asyncio.wait_for(main(), 300))
    streams = [sse_decode_tokens(p) for _, p in outs[:4]]
    same = [s == ref.results[i] for i, s in enumerate(streams)]
    log("features", f"front door: {sum(same)}/4 streams equal engine.run's "
        f"tokens; statuses {[s for s, _ in outs]} and {refused[0]} for the "
        f"sixth client; the client that hung up got "
        f"{[len(t) for t in report.cancelled.values()]} tokens")
    if [s for s, _ in outs] != [200] * 5 or refused[0] != 429:
        raise AssertionError(f"front door statuses {outs!r} {refused[0]}")
    for i, ok in enumerate(same):
        if ok:
            continue
        # admission order differs from run's: compare by logits instead
        rid = next(r for r, t in report.results.items()
                   if t == streams[i])
        d = float((report.prefill_logits[rid] - ref_logits[i]).abs().max())
        log("features", f"front door stream {i} differs from run's tokens; "
            f"prefill logits max|d|={d:.3e} (tolerance {LOGIT_TOL})")
        if d > LOGIT_TOL:
            raise AssertionError(f"front door stream {i} disagrees")
    values = {line.split()[0]: float(line.split()[1])
              for line in metrics.splitlines()
              if line and not line.startswith("#") and "{" not in line}
    want = {"engine_admitted_total": report.admitted,
            "frontdoor_rejected_429_total": report.rejected_429,
            "engine_cancelled_total": len(report.cancelled),
            "frontdoor_cancelled_total": len(report.cancelled),
            "engine_tokens_total": sum(map(len, report.results.values()))
            + sum(map(len, report.cancelled.values())),
            "engine_pages_in_use": 0,
            "engine_e2e_seconds_count": len(report.results)}
    off = {k: (values.get(k), v) for k, v in want.items()
           if values.get(k) != v}
    log("features", f"GET /metrics against the report: "
        f"{len(want) - len(off)}/{len(want)} series agree "
        f"{'ok' if not off else f'FAIL {off}'}; admitted {report.admitted}, "
        f"429 x {report.rejected_429}, cancelled {len(report.cancelled)}, "
        f"e2e p50 {report.latency_stats()['p50'] * 1e3:.1f} ms [{card}]")
    if off or report.rejected_429 != 1 or len(report.cancelled) != 1:
        raise AssertionError(f"/metrics disagrees with the report: {off}")
    del engine, fd


async def _post_metrics(port):
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /metrics HTTP/1.1\r\nHost: smoke\r\n\r\n")
    await writer.drain()
    payload = await reader.read()
    writer.close()
    return payload.split(b"\r\n\r\n", 1)[1].decode()


def serve_features(torch, dev, card, table):
    """Phase 8 at full width (the depth ``configs.get_config`` gives:
    ``FEATURE_LAYERS`` in main; W4A16, kv_fp16, 8 slots, 8-token
    pages, 32-token chunks), the 8 prompts of ``feature_prompts``, 16
    generated tokens each:
    (a) ngram speculation at k = 4 (counters set to 0 just before and read
    just after; both kernels must launch), exact acceptance, and its
    verify logits against a plain decode teacher-forced onto its streams
    (that run is (b)'s shared run); then a draft proposer holding the
    target's own weights (acceptance >= 90 %); one verify step against
    one decode step;
    (b) prefix sharing against an unshared run, for the 384-token prefix
    and for a 392-token one off the chunk grid: pages and prefill steps
    saved equal to the CPU count of the same schedule, prefill logits
    within LOGIT_TOL; a warm readmit running zero prefill chunks;
    (c) the front door."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime import speculative as spec
    from repro_torch.runtime.engine import Request, ServingEngine
    t0 = time.perf_counter()
    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=dev), cfg,
                               min_size=0)
    prompts = feature_prompts()
    P = len(prompts[0])
    log("features", f"danube full width, w4a16_g128, 8 prompts of {P} "
        f"tokens sharing a 384-token prefix, {FEAT_GEN} generated each; "
        f"weights built in {time.perf_counter() - t0:.1f} s")

    def run(engine, what, gen_len=FEAT_GEN):
        t = time.perf_counter()
        rep = engine.run(feature_requests(prompts, gen_len))
        torch.cuda.synchronize()
        log("features", f"{what}: {rep.steps} steps, {rep.decode_tokens} "
            f"decode tokens in {rep.decode_s:.3f} s, prefill "
            f"{rep.prefill_s:.3f} s, run {time.perf_counter() - t:.1f} s; "
            f"peak pages {rep.peak_pages}, prefill steps saved "
            f"{rep.prefill_steps_saved} [{card}]")
        for rid, out in rep.results.items():
            if len(out) != gen_len:
                raise AssertionError(f"{what}: request {rid} produced "
                                     f"{len(out)} tokens")
        return rep

    # (a) ngram speculation
    ngram = ServingEngine(cfg, params, speculate="ngram", spec_k=SPEC_K,
                          device=dev, **FEAT_KW)
    vplans = sorted({(p.strategy, p.split_k) for p in ngram.plans.values()})
    log("features", f"speculative engine: verify attention "
        f"{ngram.verify_attn_path} (kv_partitions="
        f"{ngram.verify_kv_partitions}), GEMM plans at M={VERIFY_M}: "
        f"{vplans}")
    records, quiet = capture_verify(ngram, table)
    reset_counts(table)
    a1 = run(ngram, "ngram k=4")
    launched = read_counts(table)
    log("features", f"launches during the ngram run: {launched}")
    check_verify_path(ngram, records, quiet, "ngram")
    log("features", f"ngram: proposed {a1.proposed_tokens}, accepted "
        f"{a1.accepted_tokens} ({a1.acceptance_rate:.1%}), "
        f"{len(records)} verify steps for {a1.decode_tokens} tokens")
    cells = check_acceptance(records, a1.results, P, "ngram")

    # (b) shared plain run, teacher-forced onto the ngram streams
    shared = ServingEngine(cfg, params, device=dev, **FEAT_KW)
    kept = force_streams(torch, shared, a1.results)
    b1 = run(shared, "plain decode, prefix shared, forced onto the ngram "
             "streams")
    gap = logit_gap(cells, kept)
    log("features", f"ngram verify logits vs plain decode replayed on the "
        f"same streams: max|d|={gap:.3e} over {len(cells)} cells "
        f"(tolerance {LOGIT_TOL}) {'ok' if gap <= LOGIT_TOL else 'FAIL'}")
    if gap > LOGIT_TOL or b1.results != a1.results:
        raise AssertionError("verify logits disagree with plain decode")
    step_times(torch, ngram, shared, card)
    del records, cells, kept, ngram
    torch.cuda.empty_cache()

    unshared = ServingEngine(cfg, params, share_prefix=False, device=dev,
                             **FEAT_KW)
    b2 = run(unshared, "plain decode, no sharing")
    check_sharing(torch, b1, b2, prompts, "384-token prefix")
    # a prefix off the chunk grid: adopters' first chunks start mid-grid
    off_grid = feature_prompts(shared=392)
    b3, b4 = (ServingEngine(cfg, params, share_prefix=share, device=dev,
                            **FEAT_KW).run(feature_requests(off_grid))
              for share in (True, False))
    check_sharing(torch, b3, b4, off_grid, "392-token prefix")
    del unshared, b3, b4

    warm = ServingEngine(cfg, params, warm_cache_mb=64, device=dev, **FEAT_KW)
    chunks = []
    advance = warm._advance_prefill

    def counted(i, slot, pending):
        chunks.append(slot.req.rid)
        advance(i, slot, pending)

    warm._advance_prefill = counted
    wrep = warm.run([Request(rid=0, prompt=prompts[0], max_new_tokens=4),
                     Request(rid=1, prompt=prompts[0], max_new_tokens=4,
                             arrival_step=40)])
    log("features", f"warm readmit: {chunks.count(0)} prefill chunks for "
        f"the first admit, {chunks.count(1)} for the readmit; warm hits "
        f"{wrep.warm_hits}, misses {wrep.warm_misses}; readmit tokens "
        f"{'equal' if wrep.results[1] == wrep.results[0] else 'DIFFER'}")
    if chunks.count(1) or wrep.warm_hits != 1 \
            or wrep.results[1] != wrep.results[0]:
        raise AssertionError("the warm readmit ran prefill or differs")
    del warm, shared
    torch.cuda.empty_cache()

    # (a) the draft proposer with the target's own weights
    oracle = ServingEngine(cfg, params,
                           speculate=spec.DraftModelProposer(cfg, params),
                           spec_k=SPEC_K, device=dev, **FEAT_KW)
    records, quiet = capture_verify(oracle, table)
    draft_logits = capture_draft(torch, oracle)
    a2 = run(oracle, "draft (the target's own weights) k=4")
    check_verify_path(oracle, records, quiet, "draft")
    check_acceptance(records, a2.results, P, "draft")
    explain_rejects(records, draft_logits, "draft")
    log("features", f"draft: proposed {a2.proposed_tokens}, accepted "
        f"{a2.accepted_tokens} ({a2.acceptance_rate:.1%}; at least 90 % "
        f"required), {len(records)} verify steps against "
        f"{len(b1.step_records)} plain decode steps")
    if a2.acceptance_rate < 0.9:
        raise AssertionError(f"the target's own weights as the draft "
                             f"accepted {a2.acceptance_rate:.1%}")
    del oracle, records, draft_logits
    torch.cuda.empty_cache()

    front_door(torch, dev, cfg, params, card)
    del params
    torch.cuda.empty_cache()
    log("features", f"phase 8 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the MoE family: phase 3's and phase 5's expert-batched GEMM rows, phase 9
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_GEN = 32
# olmoe keeps 8 of its 16 layers, paying for phase 14's elastic run and
# phase 15 (every serving run of the phase is per layer)
MOE_LAYERS = 8
MOE_ARGV = ["--arch", MOE_ARCH, "--batch", "8", "--requests", "8",
            "--prompt-len", "256", "--gen", str(MOE_GEN), "--prefill-chunk",
            "32", "--kv-format", "kv_fp16", "--seed", "0"]
# (label, E, M, K, N): olmoe's stacks at its capacity (8 at decode, at the
# 32-token chunk and at the k = 4 verify step: top-8 sets the floor) and a
# 16-row tile, then mixtral's at its decode and chunk capacities 2 and 10
OLMOE_STACKS = [("w_gate/w_up", 64, 2048, 1024), ("w_down", 64, 1024, 2048)]
MIXTRAL_STACKS = [("w_gate/w_up", 8, 4096, 14336), ("w_down", 8, 14336, 4096)]
MOE_CASES = [(lbl, E, M, K, N) for lbl, E, K, N in OLMOE_STACKS
             for M in (8, 10)] + \
    [(lbl, E, M, K, N) for lbl, E, K, N in MIXTRAL_STACKS for M in (2, 10)]
# phase 9(b): mixtral-8x7b at full width and depth through the serve
# launcher, which builds it streamed (93 GB of bf16 weights, 25 GB packed);
# 16 tokens give decode_trace its 12 decode steps
MIXTRAL_PROMPT, MIXTRAL_GEN = 64, 16
MIXTRAL_ARGV = ["--arch", "mixtral-8x7b", "--batch", "8", "--requests", "8",
                "--prompt-len", str(MIXTRAL_PROMPT), "--gen",
                str(MIXTRAL_GEN), "--page-size", "16", "--prefill-chunk", "32",
                "--kv-format", "kv_fp16", "--seed", "0"]
# phase 9(b)'s run of the launcher's own command at its defaults (4
# requests of 32 + 16 tokens), the full-depth serve a user would type
MIXTRAL_MAIN_ARGV = ["--arch", "mixtral-8x7b"]


def expert_stack(torch, E, K, N, gen, dev, fmt="w4a16_g128"):
    """An (E, K, N) random bf16 expert stack quantized slice-wise."""
    from repro_torch.models import layers
    w = (torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5) \
        .to(torch.bfloat16)
    return layers.quantize_tree({"moe": {"w": {"kernel": w}}}, format=fmt,
                                min_size=0)["moe"]["w"]["kernel"]


def stack_split(x, qt):
    """The planner's split_k for the whole stack (batch = E)."""
    from repro_torch.kernels import planning
    return planning.plan_matmul(planning.MatmulProblem.from_operands(
        x[0], qt.layer(0), batch=x.shape[0]), use_cache=False).split_k


def check_moe_gemms(torch, dev, gen):
    """Phase 3, the expert-batched kernels against their plain versions
    (expert by expert): W4A16 at olmoe's and mixtral's expert shapes, the
    planned split_k and 1, and split 2 into fp32 partials (the wrapper's
    slice-order sum); one expert's rows all zero in every stack (an expert
    no token chose); W8A16 at olmoe's shapes; the fp32 variant at a reduced
    stack. Each launch must count once on the kernel and once on its
    expert-batched form. Returns (W4A16 worst |d|, W8A16 worst |d|)."""
    from repro_torch.kernels import w4a16_fused as wf
    from repro_torch.kernels import w8a16_fused as w8
    worst = 0.0
    for lbl, E, M, K, N in MOE_CASES:
        qt = expert_stack(torch, E, K, N, gen, dev)
        x = torch.randn(E, M, K, generator=gen, device=dev) \
            .to(torch.bfloat16)
        x[E // 2] = 0
        s = stack_split(x, qt)
        for split, out_dtype in sorted({(s, None), (1, None),
                                        (2, torch.float32)},
                                       key=lambda c: (c[0], str(c[1]))):
            n0 = (wf.W4A16_GEMM.launches, wf.W4A16_GEMM_EXPERTS.launches)
            got = wf.w4a16_fused(x, qt, split_k=split, out_dtype=out_dtype)
            if (wf.W4A16_GEMM.launches - n0[0],
                    wf.W4A16_GEMM_EXPERTS.launches - n0[1]) != (1, 1):
                raise AssertionError("an expert stack must be one launch")
            want = wf.w4a16_fused_plain(x, qt, split_k=split,
                                        out_dtype=out_dtype)
            worst = max(worst, held(
                "w4a16_gemm_experts", f"{lbl} E={E} M={M} K={K} N={N} "
                f"split_k={split}{' fp32 partials' if out_dtype else ''} "
                f"(planned {s})", got, want, f32=False))
            if torch.count_nonzero(got[E // 2]):
                raise AssertionError("an expert with zero rows gave "
                                     "non-zero outputs")
        del qt, x
    w8_worst = 0.0
    for lbl, E, K, N in OLMOE_STACKS:
        qt = expert_stack(torch, E, K, N, gen, dev, "w8a16_channel")
        x = torch.randn(E, 8, K, generator=gen, device=dev) \
            .to(torch.bfloat16)
        w8_worst = max(w8_worst, held(
            "w8a16_gemm", f"expert stack {lbl} E={E} M=8 K={K} N={N}",
            w8.w8a16_fused(x, qt), w8.w8a16_fused_plain(x, qt), f32=False))
    w = torch.randn(8, 128, 64, generator=gen, device=dev)
    from repro_torch.models import layers
    qt = layers.quantize_tree({"moe": {"w": {"kernel": w}}},
                              min_size=0)["moe"]["w"]["kernel"]
    x = torch.randn(8, 5, 128, generator=gen, device=dev)
    held("w4a16_gemm_experts", "fp32 E=8 M=5 K=128 N=64",
         wf.w4a16_fused(x, qt), wf.w4a16_fused_plain(x, qt), f32=True)
    return worst, w8_worst


# the GEMM strategies that take an expert stack expert by expert through
# their 2-D kernels (planning.execute): (format, strategy)
EXPERT_LOOPS = [("w4a16_g128", "decoupled"), ("w4a8_g128", "w4a8_fused")]


def expert_loop_case(torch, dev, gen, fmt, strategy):
    """olmoe's w_gate stack (E = 64, 2048 -> 1024) in ``fmt``, x at M = 8,
    and the stack's plan for ``strategy``."""
    from repro_torch.kernels import planning
    qt = expert_stack(torch, 64, 2048, 1024, gen, dev, fmt)
    x = torch.randn(64, 8, 2048, generator=gen, device=dev) \
        .to(torch.bfloat16)
    plan = planning.plan_matmul(planning.MatmulProblem.from_operands(
        x[0], qt.layer(0), batch=64), strategy=strategy, use_cache=False)
    return qt, x, plan


def check_expert_loops(torch, dev, gen):
    """The decoupled pipeline and W4A8 on an expert stack (E launches of
    their 2-D kernels through ``planning.execute``), once at olmoe's
    w_gate stack, against their plain versions expert by expert."""
    from repro_torch.kernels import planning, w4a8_fused, w4a16_decoupled
    plains = {"decoupled": w4a16_decoupled.w4a16_decoupled_plain,
              "w4a8_fused": w4a8_fused.w4a8_fused_plain}
    for fmt, strategy in EXPERT_LOOPS:
        plain = plains[strategy]
        qt, x, plan = expert_loop_case(torch, dev, gen, fmt, strategy)
        held(strategy, f"expert stack, expert by expert: E=64 M=8 K=2048 "
             f"N=1024 split_k={plan.split_k}",
             planning.execute(plan, x, qt),
             torch.stack([plain(x[e], qt.layer(e), split_k=plan.split_k)
                          for e in range(x.shape[0])]), f32=False)


def dequant_bmm(torch, x, qt):
    """The library yardstick for an expert stack: the whole stack
    dequantized in PyTorch (vectorized over the experts), then one
    ``torch.bmm``."""
    u = qt.packed.view(torch.uint8)
    lo = (u << 4).view(torch.int8) >> 4
    hi = qt.packed.view(torch.int8) >> 4
    E, K2, N = qt.packed.shape
    q = torch.stack([lo, hi], dim=2).reshape(E, 2 * K2, N)
    s = qt.scales.repeat_interleave(qt.group_size, dim=1)
    return torch.bmm(x, (q.float() * s).to(x.dtype))


def time_moe_gemms(torch, dev, gen, timer, card):
    """Phase 5, the expert-batched W4A16 GEMM: one olmoe layer's three
    expert stacks at M = 8 (the decode capacity) and mixtral's w_down at E
    = 8, M = 2, L2 flushed: the kernel, its bound (E GEMMs' bytes), the
    plain version (expert by expert), dequant + ``torch.bmm``, and the
    per-expert loop of the 2-D kernel (E launches). Returns the olmoe
    layer's sums."""
    from repro_torch.core import costmodel
    from repro_torch.kernels import w4a16_fused as wf
    rows = {}
    cases = [("olmoe " + lbl, E, 8, K, N) for lbl, E, K, N in OLMOE_STACKS] \
        + [("mixtral w_down", 8, 2, 14336, 4096)]
    for lbl, E, M, K, N in cases:
        qt = expert_stack(torch, E, K, N, gen, dev)
        x = torch.randn(E, M, K, generator=gen, device=dev) \
            .to(torch.bfloat16)
        s = stack_split(x, qt)
        s2 = planned_split(x[0], qt.layer(0))
        lib = dequant_bmm(torch, x, qt)
        held("dequant+bmm", f"{lbl} (the yardstick computes the same "
             f"function)", lib, wf.w4a16_fused_plain(x, qt), f32=False)
        nbytes = E * costmodel.w4a16_gemm_bytes(M, N, K)
        flops = E * costmodel.w4a16_gemm_flops(M, N, K)
        r = dict(nbytes=nbytes, flops=flops,
                 ms=timer(lambda: wf.w4a16_fused(x, qt, split_k=s)),
                 plain_ms=timer(lambda: wf.w4a16_fused_plain(x, qt)),
                 library_ms=timer(lambda: dequant_bmm(torch, x, qt)),
                 loop_ms=timer(lambda: [wf.w4a16_fused(x[e], qt.layer(e),
                                                       split_k=s2)
                                        for e in range(E)]),
                 bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                 bound_by=costmodel.bound_by(nbytes, flops))
        rows[lbl] = r
        log("timing", f"w4a16_gemm_experts {lbl} E={E} M={M} K={K} N={N} "
            f"split_k={s}: one launch {r['ms']:.4f} ms, "
            f"{gbs(nbytes, r['ms'])}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of roofline); "
            f"the 2-D kernel looped over the {E} experts (split_k={s2}) "
            f"{r['loop_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
            f"dequant+bmm {r['library_ms']:.4f} ms [{card}]")
        del qt, x, lib
    from repro_torch.kernels import planning
    for fmt, strategy in EXPERT_LOOPS:
        qt, x, plan = expert_loop_case(torch, dev, gen, fmt, strategy)
        ms = timer(lambda: planning.execute(plan, x, qt))
        rows[strategy] = ms
        log("timing", f"{strategy} on olmoe's w_gate stack, expert by "
            f"expert (E=64 M=8 K=2048 N=1024 split_k={plan.split_k}): "
            f"{ms:.4f} ms, against {rows['olmoe w_gate/w_up']['ms']:.4f} "
            f"ms for the batched W4A16 launch [{card}]")
        del qt, x
    layer = ["olmoe w_gate/w_up", "olmoe w_gate/w_up", "olmoe w_down"]
    tot = {k: sum(rows[n][k] for n in layer)
           for k in ("ms", "plain_ms", "library_ms", "loop_ms", "bound_ms",
                     "nbytes", "flops")}
    rate = gbs(tot["nbytes"], tot["ms"])
    log("timing", f"w4a16_gemm_experts, one olmoe layer's 3 expert stacks "
        f"at M=8: {tot['ms']:.4f} ms in 3 launches ({rate}), bound "
        f"{tot['bound_ms']:.4f} ms, the 2-D kernel "
        f"per expert {tot['loop_ms']:.4f} ms in 192 launches, plain "
        f"{tot['plain_ms']:.4f} ms, dequant+bmm {tot['library_ms']:.4f} ms "
        f"[{card}]")
    return tot


# a replayed expert choice may differ from the plain path's own only at a
# near-tie: its k-th and (k+1)-th gates (fp32 softmax outputs) within this
ROUTE_TIE = 2 ** -5


class Routing:
    """The expert choices of one serving run, dispatch call by call
    (``models/moe.py:stable_top_k``), and their replay in a run of the
    same schedule on the other path. The kernel and plain paths' hidden
    states differ by bf16 rounding, so a token whose k-th and (k+1)-th
    gates nearly tie can take another expert on each path; one such flip
    moves that token's FFN output by a whole expert's share, and later
    tokens route on the changed states, so a free-running comparison
    measures the ties rather than the kernels. The replaying run computes
    its own gates, keeps them as the weights of the replayed experts, and
    counts the rows whose own choice differs, with its margin there."""

    def __init__(self):
        self.calls, self.next = [], 0
        self.rows = self.differ = 0
        self.margin = 0.0

    @contextlib.contextmanager
    def _patched(self, pick):
        from repro_torch.models import moe
        orig = moe.stable_top_k
        moe.stable_top_k = lambda gates, k: pick(orig, gates, k)
        try:
            yield self
        finally:
            moe.stable_top_k = orig

    def recording(self):
        def pick(orig, gates, k):
            vals, idx = orig(gates, k)
            self.calls.append(idx)
            return vals, idx
        return self._patched(pick)

    def replaying(self):
        import torch

        def pick(orig, gates, k):
            if self.next >= len(self.calls):
                raise AssertionError("the replaying run routes more often "
                                     "than the recorded one")
            idx = self.calls[self.next]
            self.next += 1
            if tuple(idx.shape) != (gates.shape[0], k):
                raise AssertionError(f"routing call {self.next}: recorded "
                                     f"{tuple(idx.shape)}, replaying "
                                     f"{(gates.shape[0], k)}")
            _, own = orig(gates, k)
            differ = (torch.sort(own, -1).values
                      != torch.sort(idx, -1).values).any(-1)
            self.rows += differ.numel()
            n = int(differ.sum())
            if n:
                self.differ += n
                top = torch.topk(gates[differ], k + 1, dim=-1).values
                self.margin = max(self.margin,
                                  float((top[:, k - 1] - top[:, k]).max()))
            return torch.gather(gates, -1, idx), idx
        return self._patched(pick)

    def check(self, what):
        ok = self.margin <= ROUTE_TIE
        log("moe", f"{what}: the plain path replayed the kernel path's "
            f"expert choices over {self.next} dispatch calls; its own top-k "
            f"set differs in {self.differ} of {self.rows} rows, largest "
            f"own gate margin there {self.margin:.3e} (near-ties: <= "
            f"{ROUTE_TIE}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what}: a replayed expert choice is not "
                                 f"a near-tie on the plain path")


def moe_engine(torch, cfg, params, dev, **kw):
    """A serving engine as the launcher builds it (the arch's presets:
    16-token pages), over ``params``."""
    from repro_torch.runtime.engine import ServingEngine
    base = dict(max_batch=8, max_prompt_len=256, max_new_tokens=MOE_GEN,
                page_size=16, prefill_chunk=32, kv_format="kv_fp16",
                device=dev)
    base.update(kw)
    return ServingEngine(cfg, params, **base)


def device_rows(prof, n):
    """A profiler window's device events, costliest first, and its device
    busy ms and device ops, per one of its ``n`` steps."""
    from torch.autograd import DeviceType
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    return dev, busy, sum(e.count for e in dev) / n


def recorded_launches(events, before, after, what, phase):
    """Print the launches the card recorded in a profiler window
    (``events``: its device rows) of each counted kernel's device function
    (named by its ``device``) beside the counters' growth over the window
    (``before``, ``after``: :func:`read_counts`). CUPTI's records of the
    W4A16 kernel fall 1–3 short in some windows, eager and compiled
    alike, so this is no check: a capture holds its counted launches
    against its graph's kernel nodes exactly (``steps.CompiledStep``)."""
    from repro_torch.kernels import build
    got, short = {}, []
    for name, (kernel, _, _) in kernel_table().items():
        if not isinstance(kernel, build.CudaKernel):
            continue            # a launch form counts on its kernel too
        counted = after[name] - before[name]
        ran = sum(e.count for e in events
                  if all(part in e.key for part in kernel.device))
        if counted or ran:
            got[name] = ran
            if counted != ran:
                short.append(f"{name} {ran} of {counted}")
    log(phase, f"{what}: launches the profiler recorded {got}; the "
        f"counters' growth over the window "
        + ("the same" if not short else "differs: " + ", ".join(short)))


def decode_trace(torch, engine, reqs, card, what, *, phase="moe",
                 expect=None, trace_prefill=False):
    """Serve ``reqs`` on ``engine``; once every slot has prefilled, 8
    decode steps run untraced, timed to a sync, then 4 under
    ``torch.profiler`` (device busy ms and device ops a step; the idle
    share is busy against the untraced wall time), then the rest.
    ``expect``: {kernel name: launches} that every one of those 12 steps
    must make. ``trace_prefill``: first, one prefill chunk of the first
    request alone runs under the profiler (the engine is then restarted).
    Returns the run's report."""
    from torch.profiler import ProfilerActivity, profile
    table = kernel_table()
    expect = expect or {}
    if trace_prefill:
        engine.start()
        engine.submit(reqs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.step()
            torch.cuda.synchronize()
        rows, busy, ops = device_rows(prof, 1)
        log(phase, f"{what}: one prefill chunk of {engine.prefill_chunk} "
            f"tokens: device busy {busy:.3f} ms in {ops:.0f} device ops "
            f"[{card}]")
        for e in rows[:3]:
            log(phase, f"  {what} prefill device "
                f"{e.self_device_time_total / 1e3:8.3f} ms/chunk  "
                f"x{e.count:<6.0f} {e.key[:80]}")
    engine.start()
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.report.decode_tokens == 0:
        engine.step()
    torch.cuda.synchronize()
    pf_steps = -(-engine.pos0(reqs[0]) // engine.prefill_chunk) * len(reqs)
    log(phase, f"{what}: prefill of {len(reqs)} requests "
        f"{time.perf_counter() - t0:.2f} s wall, "
        f"{engine.report.prefill_s:.2f} s in {pf_steps} prefill chunks "
        f"({engine.report.prefill_s / pf_steps * 1e3:.1f} ms a chunk) "
        f"[{card}]")
    counts = []

    def step():
        n0 = {k: table[k][0].launches for k in expect}
        engine.step()
        counts.append(tuple(table[k][0].launches - n0[k] for k in expect))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 8
    n0 = read_counts(table)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step()
        torch.cuda.synchronize()
    dev, busy, ops = device_rows(prof, 4)
    recorded_launches(dev, n0, read_counts(table), f"{what} decode", phase)
    gemm = [e for e in dev if "Int4Ring" in e.key]
    gemm_ms = sum(e.self_device_time_total for e in gemm) / 1e3 / 4
    log(phase, f"{what}: decode device busy {busy:.3f} ms/step "
        f"({ops:.0f} device ops/step), wall {wall:.3f} ms/step untraced -> "
        f"device idle {1 - busy / wall:.1%}; W4A16 kernel {gemm_ms:.3f} "
        f"ms/step; launches per decode step of {list(expect)}: "
        f"{sorted(set(counts))} [{card}]")
    for e in dev[:5]:
        log(phase, f"  {what} device "
            f"{e.self_device_time_total / 1e3 / 4:8.3f} ms/step  "
            f"x{e.count / 4:<6.0f} {e.key[:80]}")
    if expect and set(counts) != {tuple(expect.values())}:
        raise AssertionError(f"{what}: decode steps launched {list(expect)} "
                             f"{counts} times, not {list(expect.values())} "
                             f"each")
    rep = engine.drain()
    for rid, out in rep.results.items():
        if len(out) != reqs[0].max_new_tokens:
            raise AssertionError(f"{what}: request {rid} produced "
                                 f"{len(out)} tokens")
    return rep


def moe_serve(torch, dev, card, table):
    """Phase 9. (a) olmoe-1b-7b at full width (the depth ``configs.
    get_config`` gives: ``MOE_LAYERS`` in main) through the serve
    launcher's build (W4A16, kv_fp16, 8 slots, 8 requests of 256 + 32
    tokens, 32-token chunks, random weights from seed 0), counters set to
    0 just before and read just after, its decode steps traced
    (``decode_trace``), each launching the W4A16 kernel L x (4 + 3) times
    (the router and the head stay dense); the same weights on the plain
    paths, replaying the kernel run's expert choices (``Routing``: every
    choice the plain path would make otherwise is a near-tie), prefill
    logits within LOGIT_TOL; ngram speculation (verify routes B·(k+1)
    rows); the dense bf16 weights (``--no-quant``, the paper's FP16
    yardstick). (b) mixtral-8x7b at full width and depth
    (:func:`mixtral_serve`). Returns the launches of (a)'s main-path
    run."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import w4a16_fused as wf
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    log("moe", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.experts_per_token} of d_ff {cfg.d_ff}, "
        f"{cfg.param_count() / 1e9:.2f} B params "
        f"({cfg.active_param_count() / 1e9:.2f} B active)")
    # the expert choices are recorded and replayed in Python, between the
    # ops: these two runs step eagerly (phase 17 holds olmoe compiled)
    argv = MOE_ARGV + ["--eager"]
    log_built("moe", argv)
    engine, reqs = launcher.build(launcher.build_args(argv))
    cfg = dataclasses.replace(engine.cfg, w4a16_plan=None)
    layer_launches = cfg.num_layers * (4 + 3)
    route = Routing()
    reset_counts(table)
    with route.recording():
        kernel_rep = decode_trace(torch, engine, reqs, card,
                                  f"{cfg.name} w4a16",
                                  expect={"w4a16_gemm": layer_launches})
    launches = read_counts(table)
    log("moe", f"launches during the run: {launches}")
    if not all(launches[n] for n in ("w4a16_gemm", "w4a16_gemm_experts",
                                     "paged_attention")):
        raise AssertionError(f"a kernel of the MoE path never launched: "
                             f"{launches}")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    reqs = lambda: launcher.make_requests(cfg, 8, 256, MOE_GEN, 0)  # noqa
    plain_cfg = dataclasses.replace(cfg, w4a16_strategy="reference")
    t1 = time.perf_counter()
    # the plain paths are compared on prefill logits: 2 tokens suffice
    with route.replaying():
        plain = moe_engine(torch, plain_cfg, params, dev,
                           attn_path="gather", compiled=False) \
            .run(launcher.make_requests(cfg, 8, 256, 2, 0))
    torch.cuda.synchronize()
    log("moe", f"plain paths (--strategy reference --attn-path gather) "
        f"served in {time.perf_counter() - t1:.1f} s")
    route.check(cfg.name)
    compare_logits(kernel_rep, plain, f"{cfg.name} kernel path", MOE_GEN)
    del plain
    torch.cuda.empty_cache()

    spec = moe_engine(torch, cfg, params, dev, speculate="ngram",
                      spec_k=SPEC_K)
    n0 = (wf.W4A16_GEMM_EXPERTS.launches, wf.W4A16_GEMM.launches)
    t1 = time.perf_counter()
    rep = spec.run(reqs())
    torch.cuda.synchronize()
    vsteps = sum(1 for r in rep.step_records if "emitted" in r)
    log("moe", f"{cfg.name} ngram k={SPEC_K}: {rep.accepted_tokens}/"
        f"{rep.proposed_tokens} drafts accepted, {vsteps} verify steps "
        f"(each routes {8 * (SPEC_K + 1)} rows), {rep.decode_tokens} "
        f"tokens in {rep.decode_s:.3f} s; W4A16 launches "
        f"{wf.W4A16_GEMM.launches - n0[1]} (expert stacks "
        f"{wf.W4A16_GEMM_EXPERTS.launches - n0[0]}); run "
        f"{time.perf_counter() - t1:.1f} s [{card}]")
    if not vsteps or any(len(v) != MOE_GEN for v in rep.results.values()):
        raise AssertionError(f"{cfg.name} ngram: {vsteps} verify steps, "
                             f"lengths {[len(v) for v in rep.results.values()]}")
    del spec, rep, params
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    argv = MOE_ARGV + ["--no-quant"]
    log_built("moe", argv)
    engine, dense_reqs = launcher.build(launcher.build_args(argv))
    rep = decode_trace(torch, engine, dense_reqs, card,
                       f"{cfg.name} --no-quant", expect={"w4a16_gemm": 0})
    log("moe", f"{cfg.name} --no-quant (dense bf16 experts, torch.bmm): "
        f"{rep.decode_tokens} decode tokens in {rep.decode_s:.3f} s = "
        f"{rep.tokens_per_s:.1f} tok/s (4 of its steps traced); run "
        f"{time.perf_counter() - t1:.1f} s [{card}]")
    del engine, rep
    torch.cuda.empty_cache()

    mixtral_serve(torch, dev, card, table)
    log("moe", f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches


def full_depth_engine(torch, argv, phase, card, mode):
    """The serve launcher's engine and requests for ``argv`` at the arch's
    full depth (``launch.serve.build``: the build ``plan_build`` picks from
    the shapes, which must be ``mode``), the build's peak device memory
    (``max_memory_allocated`` after a reset, less what was allocated
    before; the engine's KV pool included) printed beside the reckoned
    one, held within PEAK_REL or PEAK_ABS as phase 15 holds its cells (a
    miss printed). Returns (engine, requests, its config without the
    engine's plans)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launcher
    args = launcher.build_args(argv)
    cfg = configs.get_config(args.arch)
    dev = torch.device("cuda")
    plan = launcher.plan_build(
        cfg, kv_bytes=launcher.kv_pool_bytes(
            cfg, batch=args.batch, prompt_len=int(args.prompt_len),
            gen=args.gen, page_size=args.page_size,
            kv_format=args.kv_format), have=launcher.device_bytes(dev))
    if plan.mode != mode:
        raise AssertionError(f"{cfg.name}: the launcher's build is "
                             f"{plan.mode}, not {mode}")
    log_built(phase, argv)
    # an earlier run's engine freed by the collector during the build would
    # hide part of its peak below ``base``
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, reqs = launcher.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    est, gib = plan.bytes, 2 ** 30
    off = peak - plan.peak
    ok = abs(off) <= max(PEAK_REL * peak, PEAK_ABS)
    log(phase, f"{cfg.name}: all {cfg.num_layers} layers at full width "
        f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, {cfg.mlp_type} d_ff {cfg.d_ff}"
        + (f", {cfg.num_experts} experts top-{cfg.experts_per_token}"
           if cfg.family == "moe" else "")
        + f", vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.2f} B "
        f"params, {est.dense / gib:.2f} GiB dense): {plan.mode} build and "
        f"engine in {build_s:.1f} s, peak {peak / gib:.3f} GiB measured vs "
        f"{plan.peak / gib:.3f} GiB reckoned ({off / 2**20:+.0f} MiB = "
        f"{off / max(peak, 1):+.1%} {'ok' if ok else 'MISS'}, within "
        f"{PEAK_REL:.0%} or {PEAK_ABS // 2**20} MiB), {est.packed / gib:.3f} "
        f"GiB packed, the KV pool {plan.kv / gib:.3f} GiB; the whole build "
        f"reckoned {est.whole / gib:.3f} GiB"
        + ("" if est.streamed is None else
           f", the streamed {est.streamed / gib:.3f} GiB")
        + f"; the card {plan.have / gib:.2f} GiB [{card}]")
    if peak > plan.have:
        raise AssertionError(f"{cfg.name}: the build's peak passed the card")
    return engine, reqs, dataclasses.replace(engine.cfg, w4a16_plan=None)


def mixtral_main(torch, card, table):
    """``python -m repro_torch.launch.serve --arch mixtral-8x7b`` as a user
    types it (``launch.serve.main``: the streamed build, ``engine.run``,
    the report), counters set to 0 just before and read just after: the
    W4A16 kernel, its expert-batched form and paged attention must
    launch, and no other kernel; every request gets its tokens."""
    from repro_torch.launch import serve as launcher
    log("moe", "python -m repro_torch.launch.serve "
        + " ".join(MIXTRAL_MAIN_ARGV))
    gc.collect()
    torch.cuda.empty_cache()
    want = ("w4a16_gemm", "w4a16_gemm_experts", "paged_attention")
    reset_counts(table)
    t0 = time.perf_counter()
    report = launcher.main(MIXTRAL_MAIN_ARGV)
    torch.cuda.synchronize()
    launches = read_counts(table)
    args = launcher.build_args(MIXTRAL_MAIN_ARGV)
    steps = max(len(report.step_records), 1)
    log("moe", f"mixtral-8x7b (launch.serve.main, its defaults): "
        f"{len(report.results)} requests, {report.decode_tokens} decode "
        f"tokens, {report.decode_s / steps * 1e3:.2f} ms a decode step; "
        f"the command {time.perf_counter() - t0:.1f} s; launches "
        f"{launches} [{card}]")
    quiet = {k for k, v in launches.items() if v and k not in want}
    if quiet or not all(launches[k] for k in want):
        raise AssertionError(f"mixtral-8x7b main: launched {launches}, the "
                             f"path's kernels are {want}")
    if len(report.results) != args.batch or any(
            len(v) != args.gen for v in report.results.values()):
        raise AssertionError(f"mixtral-8x7b main: {report.results}")
    del report
    gc.collect()
    torch.cuda.empty_cache()


def mixtral_compiled(torch, dev, card, table, cfg, params, shape, reqs,
                     eager, eager_launches):
    """mixtral-8x7b's default compiled steps at full depth: an engine of
    the same shape (``shape``) on the same weights and plans (``cfg``, the
    eager engine's) serves the same requests, counters set to 0 just
    before and read just after, held against the eager routed run
    (``eager``, its launches) on tokens, first-token logits and launches
    (``hold_compiled``)."""
    from repro_torch.launch import serve as launcher
    from repro_torch.runtime.engine import ServingEngine
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, device=dev, **shape)
    reset_counts(table)
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts(table).items() if v}
    steps = max(len(rep.step_records), 1)
    log("compiled", f"{cfg.name} {cfg.num_layers}L: "
        f"{launcher.steps_line(engine)}; decode "
        f"{rep.decode_s / steps * 1e3:.2f} ms/step compiled (host clock); "
        f"run {time.perf_counter() - t0:.1f} s [{card}]")
    hold_compiled(rep, eager, f"{cfg.name} ({cfg.num_layers} layers)",
                  (launches, eager_launches))
    del engine, rep
    gc.collect()
    torch.cuda.empty_cache()


def mixtral_serve(torch, dev, card, table):
    """Phase 9(b): mixtral-8x7b at full width and depth (32 layers):
    first the launcher's own command at its defaults
    (:func:`mixtral_main`); then the launcher's engine (``MIXTRAL_ARGV``:
    W4A16, built streamed since the whole build's reckoning passes the
    card; 8 requests of 64 + 16 tokens) run eagerly, counters set to 0
    just before and read just after, every decode step launching the
    W4A16 kernel 7 a layer (3 of them the expert-batched form) and paged
    attention once a layer; the same weights and requests through the
    default compiled steps, held against it (:func:`mixtral_compiled`);
    its routing recorded and replayed by the plain paths on the same
    weights (2 tokens a request), prefill logits within LOGIT_TOL."""
    from repro_torch.launch import serve as launcher
    mixtral_main(torch, card, table)
    # eager, as phase 9(a)'s routed pair
    engine, reqs, cfg = full_depth_engine(torch, MIXTRAL_ARGV + ["--eager"],
                                          "moe", card, "streamed")
    L = cfg.num_layers
    want = {"w4a16_gemm": 7 * L, "w4a16_gemm_experts": 3 * L,
            "paged_attention": L}
    route = Routing()
    reset_counts(table)
    with route.recording():
        got = decode_trace(torch, engine, reqs, card,
                           f"{cfg.name} {L}L w4a16", expect=want)
    launches = read_counts(table)
    log("moe", f"{cfg.name}: launches during the run: {launches}")
    quiet = {k for k, v in launches.items() if v and k not in want}
    if quiet or not all(launches[k] for k in want):
        raise AssertionError(f"{cfg.name}: launched {launches}, the path's "
                             f"kernels are {sorted(want)}")
    params, planned = engine.params, engine.cfg
    shape = dict(max_batch=engine.max_batch,
                 max_prompt_len=engine.max_prompt_len,
                 max_new_tokens=engine.max_new_tokens,
                 page_size=engine.page_size,
                 prefill_chunk=engine.prefill_chunk,
                 kv_format=engine.kv_format)
    del engine
    mixtral_compiled(torch, dev, card, table, planned, params, shape, reqs,
                     got, {k: v for k, v in launches.items() if v})
    t1 = time.perf_counter()
    with route.replaying():
        plain = moe_engine(
            torch, dataclasses.replace(cfg, w4a16_strategy="reference"),
            params, dev, attn_path="gather", max_prompt_len=MIXTRAL_PROMPT,
            max_new_tokens=MIXTRAL_GEN, compiled=False).run(
                launcher.make_requests(cfg, 8, MIXTRAL_PROMPT, 2, 0))
    torch.cuda.synchronize()
    log("moe", f"{cfg.name}: plain paths (--strategy reference --attn-path "
        f"gather) served in {time.perf_counter() - t1:.1f} s")
    route.check(f"{cfg.name} ({L} layers)")
    compare_logits(got, plain, f"{cfg.name} ({L} layers) kernel path",
                   MIXTRAL_GEN)
    del params, got, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the carry families: phase 3's and phase 5's rows at their shapes, phase 10
# ---------------------------------------------------------------------------

# (arch, K, N, group, leaves a layer) of every W4A16 GEMM shape of a
# carry-family decode step: rwkv6-7b's six 4096 x 4096 time-mix projections
# and its channel-mix pair; hymba-1.5b's attention, SSM and MLP projections,
# the K = 1600 leaves at group 64 (1600 is not a multiple of 128)
CARRY_GEMMS = [("rwkv", 4096, 4096, 128, 6), ("rwkv", 4096, 14336, 128, 1),
               ("rwkv", 14336, 4096, 128, 1),
               ("hymba", 1600, 1600, 64, 2), ("hymba", 1600, 320, 64, 2),
               ("hymba", 1600, 3200, 64, 2), ("hymba", 1600, 5504, 64, 2),
               ("hymba", 3200, 1600, 128, 1), ("hymba", 5504, 1600, 128, 1)]
# hymba's paged attention: 5 KV heads, a group of 5, head dim 64, 16-token
# pages, a 64-page (1024-token) slot window; context at 1500, so the ring
# has wrapped and the 1024 window masks the oldest keys of a chunk's
# later queries
HYMBA_HEADS, HYMBA_PAGE, HYMBA_PAGES, HYMBA_WINDOW = (5, 5, 64), 16, 64, 1024
HYMBA_CTX = 1500
CARRY_PROMPT, CARRY_GEN = 256, 32
CARRY_ARGV = ["--batch", "8", "--requests", "8", "--prompt-len",
              str(CARRY_PROMPT), "--gen", str(CARRY_GEN), "--page-size", "16",
              "--prefill-chunk", "32", "--kv-format", "kv_fp16", "--seed",
              "0"]
HYMBA_LONG = (1200, 8)          # one request whose context passes 1024
# the launcher's first 4 requests are held against the plain paths and
# drive the oracle-draft run: their prefill is the phase's slowest step
CARRY_HELD = 4


def carry_gemm_case(torch, K, N, group, M, gen, dev, dtype):
    from repro_torch.core.quant import quantize
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    qt = quantize(w.to(dtype), group_size=group, out_dtype=dtype)
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    return x, qt


def check_carry_gemms(torch, dev, gen):
    """The W4A16 kernel against its plain version at every carry-family
    shape (hymba's K = 1600 at group 64: a 128-row stage holds parts of
    three groups, and 1600 is not a multiple of the stage), M = 1, 8, 32
    (a prefill chunk) and 40 (the k = 4 verify step), bf16 and fp32, the
    planner's split_k at that M, the engine's plans (made at M = 8, or 40
    when speculating, and reused by every step) and 1; ``held``'s
    tolerances. Returns the worst bf16 |d|."""
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for arch, K, N, group, _ in CARRY_GEMMS:
            plans = set()
            for M in (1, 8, 32, VERIFY_M):
                x, qt = carry_gemm_case(torch, K, N, group, M, gen, dev,
                                        dtype)
                if M in (8, VERIFY_M):
                    plans.add(planned_split(x, qt))
                dt = "fp32" if f32 else "bf16"
                for s in sorted(plans | {planned_split(x, qt), 1}):
                    err = held("w4a16_gemm", f"{arch} {dt} M={M} K={K} "
                               f"N={N} group={group} split_k={s}",
                               w4a16_fused(x, qt, split_k=s),
                               w4a16_fused_plain(x, qt, split_k=s), f32=f32)
                    if not f32:
                        worst = max(worst, err)
    return worst


def check_carry_attention(torch, dev, gen):
    """Paged attention at hymba's heads (25 query over 5 KV heads of 64,
    G = 5: 5 rows a decode block, 80 for the 32-token chunk, 25 for the
    verify step), 16-token pages, a 64-page table, context past the 1024
    window: decode, chunk and verify in both KV formats, the 1024 window
    and a 100-token one, one partition and the planner's pick; a -1 table
    entry at the tail (decode's last slot) and inside a live partition;
    fp32 compute at the chunk. Held as ``check_attention`` holds
    danube's."""
    worst = 0.0
    variants = [("", kind, fmt, "bf16", False)
                for fmt in ("kv_fp16", "kv8_channel")
                for kind in ("decode", "chunk", "verify")] + [
        ("hole", "decode", "kv_fp16", "bf16", True),
        ("hole", "chunk", "kv8_channel", "bf16", True),
        ("fp32", "chunk", "kv_fp16", "fp32", False)]
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for label, kind, fmt_name, dt, hole in variants:
        c = attn_case(torch, gen, dev, fmt_name=fmt_name, kind=kind,
                      null_slot=kind == "decode", hole=hole,
                      dtype=dtypes[dt], heads=HYMBA_HEADS, page=HYMBA_PAGE,
                      pages=HYMBA_PAGES, ctx=HYMBA_CTX)
        name = f"hymba {label} {kind}" if label else f"hymba {kind}"
        for window in (HYMBA_WINDOW, 100):
            for parts in sorted({1, c["planned"]}):
                worst = max(worst, hold_partials(torch, c, name, fmt_name,
                                                 dt, window, parts))
    return worst


def time_carry(torch, dev, gen, timer, card, floor_ms):
    """Phase 5's carry-family rows: the W4A16 kernel at rwkv's three
    shapes and hymba's six (M = 8, bf16, the planner's split_k) beside its
    bound, the timer's floor, its plain version and dequant +
    ``torch.matmul``; each arch's decode-step sum (every layer's GEMMs);
    paged attention at hymba's decode and chunk shapes beside gather +
    SDPA."""
    from repro_torch.core import costmodel
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    rows = {}
    for arch, K, N, group, n in CARRY_GEMMS:
        x, qt = carry_gemm_case(torch, K, N, group, 8, gen, dev,
                                torch.bfloat16)
        s = planned_split(x, qt)
        nbytes = costmodel.w4a16_gemm_bytes(8, N, K, group=group)
        flops = costmodel.w4a16_gemm_flops(8, N, K)
        r = dict(ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                 plain_ms=timer(lambda: w4a16_fused_plain(x, qt, split_k=s)),
                 library_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                 bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                 nbytes=nbytes, n=n)
        rows[(arch, K, N)] = r
        log("timing", f"w4a16_gemm {arch} M=8 K={K} N={N} group={group} "
            f"split_k={s}: kernel {r['ms']:.4f} ms, {gbs(nbytes, r['ms'])}, "
            f"bound {r['bound_ms']:.4f} ms ({costmodel.bound_by(nbytes, flops)}"
            f"; {r['bound_ms'] / r['ms']:.1%} of roofline; the timer's floor "
            f"{floor_ms:.4f}), plain {r['plain_ms']:.4f} ms, dequant+matmul "
            f"{r['library_ms']:.4f} ms [{card}]")
    for arch, L in (("rwkv", 32), ("hymba", 32)):
        def total(key):
            return L * sum(r[key] * r["n"] for (a, _, _), r in rows.items()
                           if a == arch)
        log("timing", f"w4a16_gemm, {arch}'s decode step ({L} layers' "
            f"GEMMs at M=8): kernel {total('ms'):.3f} ms, bound "
            f"{total('bound_ms'):.3f} ms ({total('nbytes') / 1e9:.2f} GB), "
            f"plain {total('plain_ms'):.3f} ms, dequant+matmul "
            f"{total('library_ms'):.3f} ms [{card}]")
    for kind in ("decode", "chunk"):
        c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                      heads=HYMBA_HEADS, page=HYMBA_PAGE, pages=HYMBA_PAGES,
                      ctx=HYMBA_CTX)
        rows[("attn", kind)] = time_attn_case(
            torch, timer, c, HYMBA_WINDOW, f"hymba {kind}", card)
    time_scans(torch, dev, gen, timer, card)
    return rows


def time_scans(torch, dev, gen, timer, card):
    """The sequential recurrences of a 32-token prefill chunk, one layer
    (``rwkv.wkv_scan`` over 64 heads of 64 x 64, ``ssm.ssm_scan`` over
    3200 x 16; fp32, every position valid): the card's time (``Timer``)
    and the wall time of a call ended by a sync, each also x 32 layers,
    beside the chunk step's own times (the ``one prefill chunk`` and
    ``ms a chunk`` lines of phase 10)."""
    from repro_torch.models import rwkv, ssm
    f32 = dict(device=dev, dtype=torch.float32)
    cases = {
        "rwkv wkv_scan": (rwkv.wkv_scan, (
            torch.zeros(1, 64, 64, 64, **f32),
            torch.rand(1, 32, 64, 64, generator=gen, **f32),
            torch.randn(1, 32, 64, 64, 64, generator=gen, **f32))),
        "hymba ssm_scan": (ssm.ssm_scan, (
            torch.zeros(1, 3200, 16, **f32),
            torch.rand(1, 32, 3200, 16, generator=gen, **f32),
            torch.randn(1, 32, 3200, 16, generator=gen, **f32)))}
    valid = torch.ones(1, 32, dtype=torch.bool, device=dev)
    for label, (fn, args) in cases.items():
        ms = timer(lambda: fn(*args, valid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn(*args, valid)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
        log("timing", f"{label}, a 32-token chunk, one layer: device "
            f"{ms:.4f} ms, wall {wall:.3f} ms to a sync; x 32 layers: device "
            f"{32 * ms:.3f} ms, wall {32 * wall:.1f} ms [{card}]")


def clone_state(tree):
    """A deep copy of a decode state (dicts, the pool's named tuples,
    tensors)."""
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(clone_state(t) for t in tree))
    return None if tree is None else tree.clone()


def eager(step):
    """The eager step behind a compiled one (``steps.CompiledStep.fn``)."""
    return getattr(step, "fn", step)


def accepted_drafts(tok, pos, nxt, i):
    n = int((pos[i] >= 0).sum()) - 1
    a = 0
    while a < n and int(tok[i, a + 1]) == int(nxt[i, a]):
        a += 1
    return a


def capture_carry_verify(torch, engine, table, kernels):
    """``capture_verify``, and for each verify step: (i) before it runs, a
    decode step of the engine's own path replayed on a copy of the state
    the step starts from, at each active row's first position (its last
    emitted token): the largest |d| between its logits and the verify
    step's there; (ii) the carry commit held to checkpoint 1 + accepted
    drafts (0 for inactive rows) of the stack the step returned, row by
    row, exactly. Returns (records, quiet, stats)."""
    records, quiet = capture_verify(engine, table, kernels)
    stats = {"replay_max": 0.0, "replayed": 0, "commits": 0, "bad": [],
             "sel": {}}
    capture = engine._verify_step

    def verify_step(live_pages=None):
        fn = capture(live_pages)

        def call(params, state, inputs):
            positions = inputs["positions"]
            live = positions[:, 0] >= 0
            dec = {"state": clone_state(state),
                   "tokens": inputs["tokens"][:, 0].contiguous(),
                   "pos": positions[:, 0].clamp_min(0).contiguous(),
                   "active": live}
            if "tables" in inputs:
                dec["tables"] = inputs["tables"]
            # the eager step: a compiled one would take the copy for the
            # engine's own (donated) state
            want = eager(engine._serve_step(None))(params, dec)["logits"]
            del dec
            out = fn(params, state, inputs)
            d = (out["logits"][:, 0] - want).abs().amax(-1)[live]
            stats["replay_max"] = max(stats["replay_max"], float(d.max()))
            stats["replayed"] += int(live.sum())
            return out
        return call

    orig = engine._apply_carry_selection

    def commit(carries, sel):
        rids, tok, pos, nxt, _ = records[-1]
        want = [0 if rid is None else 1 + accepted_drafts(tok, pos, nxt, i)
                for i, rid in enumerate(rids)]
        if [int(v) for v in sel] != want:
            stats["bad"].append(("selection", list(sel), want))
        for c in want:
            stats["sel"][c] = stats["sel"].get(c, 0) + 1
        orig(carries, sel)
        cache = engine._state["cache"]
        for name, stack in carries.items():
            for b, c in enumerate(want):
                if not torch.equal(cache[name][:, b], stack[:, b, c]):
                    stats["bad"].append((name, b, c))
        stats["commits"] += 1

    engine._verify_step = verify_step
    engine._apply_carry_selection = commit
    return records, quiet, stats


def oracle_proposer(torch, reqs, streams):
    """A proposer whose drafts are a plain decode's own tokens (``streams``:
    rid → tokens of ``reqs``), the next k after what the slot has emitted,
    while the slot's stream still equals the plain one (a near-tie the two
    steps round apart ends it): a verify step accepts them unless its
    argmax differs there."""
    from repro_torch.runtime import speculative as spec
    prompts = [[int(t) for t in r.prompt] for r in reqs]

    class Oracle(spec.Proposer):
        name = "ngram"

        def propose(self, views, k):
            out = {}
            for v in views:
                ctx = list(v.context)
                rid = next(i for i, p in enumerate(prompts)
                           if ctx[:len(p)] == p)
                done = len(ctx) - len(prompts[rid])
                if ctx[len(prompts[rid]):] == list(streams[rid][:done]):
                    out[v.slot] = list(streams[rid][done:done + k])
            return out

    return Oracle()


def speculate_checked(torch, engine, reqs, table, kernels, what, card):
    """Serve ``reqs`` speculatively on ``engine`` (k = SPEC_K) with every
    verify step wrapped by ``capture_carry_verify``: exact acceptance, the
    replayed decode's logits within LOGIT_TOL, every carry commit equal to
    its checkpoint. Returns {checkpoint: commits} over the rows."""
    records, quiet, stats = capture_carry_verify(torch, engine, table,
                                                 kernels)
    t1 = time.perf_counter()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    gen = reqs[0].max_new_tokens
    log("carry", f"{what} k={SPEC_K}: {rep.accepted_tokens}/"
        f"{rep.proposed_tokens} drafts accepted, {len(records)} verify "
        f"steps ({len(records) - len(quiet)} launching {list(kernels)}), "
        f"{rep.decode_tokens} tokens in {rep.decode_s:.3f} s; run "
        f"{time.perf_counter() - t1:.1f} s [{card}]")
    if quiet or not records or any(len(v) != gen
                                   for v in rep.results.values()):
        raise AssertionError(f"{what}: {len(records)} verify steps, quiet "
                             f"{quiet[:4]}, lengths "
                             f"{[len(v) for v in rep.results.values()]}")
    check_acceptance(records, rep.results, len(reqs[0].prompt), what,
                     phase="carry")
    ok = not stats["bad"] and stats["commits"] == len(records) \
        and stats["replay_max"] <= LOGIT_TOL
    log("carry", f"{what}: {stats['commits']} carry commits, each row's "
        f"carry checkpoint 1 + accepted of its verify step's stack (0 for "
        f"inactive rows; rows per checkpoint {dict(sorted(stats['sel'].items()))}"
        f"), mismatches {stats['bad'][:4]}; verify logits at each row's "
        f"first position vs a decode step replayed from the same carry: "
        f"max|d|={stats['replay_max']:.3e} over {stats['replayed']} rows "
        f"(tolerance {LOGIT_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: verify carries or logits disagree")
    return stats["sel"]


def repeat_prompts(vocab, n=8, plen=64, period=16, seed=9, gen=CARRY_GEN):
    """``n`` requests' prompts of ``plen`` tokens, each a ``period``-token
    random sequence repeated: prompt lookup has matches to propose (64
    tokens, not the cell's 256: the run checks the verify path, and its
    prefill is the carry families' slowest step); ``gen`` tokens each."""
    import numpy as np
    from repro_torch.runtime.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=np.resize(rng.integers(0, vocab, period),
                                            plen).astype(np.int32),
                    max_new_tokens=gen) for i in range(n)]


def first_requests(rep, n):
    """``rep``'s results and prefill logits of its first ``n`` requests."""
    import types
    keep = sorted(rep.results)[:n]
    return types.SimpleNamespace(
        results={r: rep.results[r] for r in keep},
        prefill_logits={r: rep.prefill_logits[r] for r in keep})


def fp32_params(torch, tree):
    """``tree`` with fp32 activations: quantized leaves keep their bytes
    and dequantize to fp32, dense leaves are cast (a mesh rank's "tp"
    marks kept)."""
    from repro_torch.core.quant import QuantizedTensor
    if isinstance(tree, dict):
        return {k: fp32_params(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):          # the engine's per-layer dicts
        return [fp32_params(torch, v) for v in tree]
    if isinstance(tree, str):
        return tree
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.packed, tree.scales, tree.zeros,
                               tree.group_size, torch.float32, tree.format)
    return tree.float()


def max_gap(a, b):
    return max(float((a.prefill_logits[r].float()
                      - b.prefill_logits[r].float()).abs().max())
               for r in a.results)


def rwkv_fp32_logits(torch, engine, cfg, params, kernel16, plain16, reqs):
    """rwkv6-7b's paths held in fp32. With random weights its bf16 logits
    move by more than LOGIT_TOL under bf16 rounding alone: the bf16 plain
    path sits as far from the fp32 plain path as the bf16 kernel path
    does, both printed here. So the same quantized weights run with fp32
    activations (the W4A16 kernel's fp32 variant against the plain path in
    fp32), and those logits are held within LOGIT_TOL."""
    import dataclasses
    p32 = fp32_params(torch, params)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    t1 = time.perf_counter()
    n0 = kernel_table()["w4a16_gemm"][0].launches
    k32 = engine(c32, p32).run(reqs())
    launched = kernel_table()["w4a16_gemm"][0].launches - n0
    p32r = engine(dataclasses.replace(c32, w4a16_strategy="reference"),
                  p32, attn_path="gather").run(reqs())
    torch.cuda.synchronize()
    log("carry", f"{cfg.name}: bf16 rounding alone: kernel vs plain path "
        f"max|d|={max_gap(kernel16, plain16):.3e}, plain bf16 vs plain fp32 "
        f"{max_gap(plain16, p32r):.3e}, kernel bf16 vs plain fp32 "
        f"{max_gap(kernel16, p32r):.3e} (LOGIT_TOL {LOGIT_TOL}); the fp32 "
        f"paths ({launched} W4A16 launches) served in "
        f"{time.perf_counter() - t1:.1f} s")
    if not launched:
        raise AssertionError("rwkv fp32: the W4A16 kernel never launched")
    compare_logits(k32, p32r, f"{cfg.name} kernel path in fp32", 2)


def carry_arch(torch, dev, card, table, arch):
    """Phase 10 for one arch at full width and the depth ``configs.
    get_config`` gives (``depth_cut``): the serve launcher
    (W4A16, 8 slots, 8 requests of 256 + 32 tokens, 32-token chunks;
    counters set to 0 just before and read just after), the same weights
    on the plain paths (the first CARRY_HELD requests' prefill logits
    within LOGIT_TOL; rwkv's in fp32, ``rwkv_fp32_logits``), hymba's one
    request of 1200 + 8 tokens (its window bites) against its plain path,
    a traced prefill chunk and 4 traced decode steps with every decode step
    launching each kernel its exact count, speculation at k = 4 with
    drafts that are the plain decode's own tokens (carries committed past
    checkpoint 1; the first CARRY_HELD requests) and with ngram on 64-token
    prompts (``speculate_checked``: exact acceptance,
    the verify logits at each row's first position against a replayed
    decode step, every carry commit against its checkpoint), and the dense
    bf16 weights (``--no-quant``). Returns the launches of the launcher's
    run."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve as launcher
    from repro_torch.runtime.engine import ServingEngine
    t0 = time.perf_counter()
    cfg = configs.get_config(arch)
    L = cfg.num_layers
    gemms = sum(n for a, _, _, _, n in CARRY_GEMMS if arch.startswith(a))
    attn = 0 if cfg.attn_free else L
    log("carry", f"{cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}" + (f", SSM d_inner {cfg.d_inner} state "
                         f"{cfg.ssm_state}, SWA {cfg.sliding_window}"
                         if cfg.family == "hybrid" else "")
        + f", vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.2f} B "
        f"params; {gemms} W4A16 GEMMs and {attn // L} paged-attention "
        f"launch a layer")
    argv = ["--arch", arch] + CARRY_ARGV
    log_built("carry", argv)
    engine_k, reqs8 = launcher.build(launcher.build_args(argv))
    cfg = dataclasses.replace(engine_k.cfg, w4a16_plan=None)
    reset_counts(table)
    kernel_rep = decode_trace(
        torch, engine_k, reqs8, card, f"{cfg.name} w4a16", phase="carry",
        expect={"w4a16_gemm": L * gemms, "paged_attention": attn},
        trace_prefill=True)
    launches = read_counts(table)
    log("carry", f"launches during the run: {launches}")
    others = [k for k, v in launches.items()
              if v and k not in ("w4a16_gemm", "paged_attention")]
    if not launches["w4a16_gemm"] or bool(launches["paged_attention"]) \
            != bool(attn) or others:
        raise AssertionError(f"{arch}: the path's kernels did not launch as "
                             f"they must: {launches}")
    params = engine_k.params
    del engine_k
    torch.cuda.empty_cache()

    def engine(config, weights, **kw):
        base = dict(max_batch=8, max_prompt_len=CARRY_PROMPT,
                    max_new_tokens=CARRY_GEN, page_size=16, prefill_chunk=32,
                    kv_format="kv_fp16", device=dev)
        base.update(kw)
        return ServingEngine(config, weights, **base)

    plain_cfg = dataclasses.replace(cfg, w4a16_strategy="reference")
    t1 = time.perf_counter()
    # the plain paths are compared on prefill logits: 2 tokens suffice
    reqs2 = lambda: launcher.make_requests(  # noqa
        cfg, CARRY_HELD, CARRY_PROMPT, 2, 0)
    plain = engine(plain_cfg, params, attn_path="gather").run(reqs2())
    torch.cuda.synchronize()
    log("carry", f"plain paths (--strategy reference --attn-path gather) "
        f"served the first {CARRY_HELD} requests in "
        f"{time.perf_counter() - t1:.1f} s")
    held = first_requests(kernel_rep, CARRY_HELD)
    if cfg.attn_free:
        rwkv_fp32_logits(torch, engine, cfg, params, held, plain, reqs2)
    else:
        compare_logits(held, plain, f"{cfg.name} kernel path", CARRY_GEN)
    del plain
    if cfg.family == "hybrid":
        P, G_ = HYMBA_LONG
        kw = dict(max_prompt_len=P, max_new_tokens=G_)
        reqs = lambda: launcher.make_requests(cfg, 1, P, G_, 1)  # noqa
        long_k = engine(cfg, params, **kw)
        got = long_k.run(reqs())
        want = engine(plain_cfg, params, attn_path="gather", **kw).run(reqs())
        log("carry", f"{cfg.name}: one request of {P} + {G_} tokens, "
            f"cache_len {long_k.cache_len} (window {cfg.sliding_window}): "
            f"{got.steps} steps")
        compare_logits(got, want, f"{cfg.name} {P}-token prompt", G_)
        del long_k, got, want
    torch.cuda.empty_cache()

    kernels = ("w4a16_gemm", "paged_attention") if attn else ("w4a16_gemm",)
    # drafts that mostly pass: the kernel run's own tokens; the verify
    # steps commit carries past checkpoint 1
    oracle_reqs = reqs8[:CARRY_HELD]
    oracle = engine(cfg, params, speculate=oracle_proposer(
        torch, oracle_reqs, kernel_rep.results), spec_k=SPEC_K)
    sel = speculate_checked(torch, oracle, oracle_reqs, table, kernels,
                            f"{cfg.name} oracle drafts", card)
    if not any(c > 1 for c in sel):
        raise AssertionError(f"{cfg.name}: no verify step accepted a draft")
    del oracle
    spec = engine(cfg, params, speculate="ngram", spec_k=SPEC_K)
    speculate_checked(torch, spec, repeat_prompts(cfg.vocab_size), table,
                      kernels, f"{cfg.name} ngram", card)
    del spec, params, kernel_rep
    torch.cuda.empty_cache()

    argv = argv + ["--no-quant"]
    log_built("carry", argv)
    dense_k, dense_reqs = launcher.build(launcher.build_args(argv))
    rep = decode_trace(torch, dense_k, dense_reqs, card,
                       f"{cfg.name} --no-quant", phase="carry",
                       expect={"w4a16_gemm": 0, "paged_attention": attn})
    log("carry", f"{cfg.name} --no-quant (dense bf16 weights, torch.matmul):"
        f" {rep.decode_tokens} decode tokens in {rep.decode_s:.3f} s = "
        f"{rep.tokens_per_s:.1f} tok/s (4 of its steps traced)")
    del dense_k, rep
    torch.cuda.empty_cache()
    log("carry", f"{cfg.name} took {time.perf_counter() - t0:.1f} s")
    return launches


# phase 10's depth cuts: hymba keeps 4 of its 32 layers (every step of
# its host-bound serving runs is per layer: 125.6 s at 32 layers on an
# H100 80GB HBM3 at 700 W), paying with phase 12's cut for phases 13 and
# 14's carry-family and whisper runs and, with rwkv's 8 of 32 (68.2 s at
# 32), for phase 14's elastic run and phase 15
CARRY_LAYERS = {"rwkv6-7b": 8, "hymba-1.5b": 4}


@contextlib.contextmanager
def depth_cut(arch, layers, phase="carry"):
    """``configs.get_config(arch)`` at ``layers`` decoder layers for the
    block (the launcher and the engines read it), the cut printed with
    its byte counts under ``phase``; nothing changes for ``layers``
    None."""
    from repro_torch import configs
    if layers is None:
        yield
        return
    get = configs.get_config
    full = get(arch)
    cut = dataclasses.replace(full, num_layers=layers)
    log(phase, f"{arch}: depth cut to {layers} of {full.num_layers} "
        f"layers, full width: {cut.param_count() / 1e9:.3f} B params, "
        f"{cut.param_count() * 2 / 2**30:.2f} GiB in bf16 (all "
        f"{full.num_layers}: {full.param_count() / 1e9:.3f} B, "
        f"{full.param_count() * 2 / 2**30:.2f} GiB)")
    configs.get_config = lambda a: cut if a == arch else get(a)
    try:
        yield
    finally:
        configs.get_config = get


def carry_serve(torch, dev, card, table):
    """Phase 10: rwkv6-7b, then hymba-1.5b (``carry_arch``; depth cuts
    ``CARRY_LAYERS``)."""
    t0 = time.perf_counter()
    for arch in ("rwkv6-7b", "hymba-1.5b"):
        with depth_cut(arch, CARRY_LAYERS.get(arch)):
            carry_arch(torch, dev, card, table, arch)
    log("carry", f"phase 10 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the encoder-decoder and vision-prefix families and the remaining dense
# configs: phase 3's and phase 5's rows at their shapes, phase 11
# ---------------------------------------------------------------------------

# phase 11's archs; (c)'s depth cut keeps every layer shape as served
P11_ARCHS = ("whisper-small", "internvl2-1b", "starcoder2-7b", "granite-20b")
# whisper's encoder layers and cross-K/V projections run at admit over the
# 1500 frames of one request
ENCODER_M = 1500
# the rows every served W4A16 leaf is held at: 1 (a lone decode row), 8
# (decode), 32 (a prefill chunk), 40 (the k = 4 verify step)
P11_M = (1, 8, 32, VERIFY_M)
# a vocab-wide N off the served path (internvl2-1b's padded vocab: its
# lm_head stays dense, as in the JAX package), held and timed at M = 8
OFF_PATH_GEMM = ("internvl2 vocab, off-path", 896, 151808)
# granite's K >> N projection: the kernel at every Split-K the planner may
# pick (group-aligned powers of two) against data-parallel (split_k 1)
SPLITK_SHAPE, SPLITK_M = (6144, 128), (1, 8, 16)
# paged attention at the phase-11 archs' heads, as served: (arch, (KV
# heads, group, head dim), page, a slot's pages); whisper 160 tokens a
# slot (128 + 32), internvl2 416 (256 patches + 128 + 32), starcoder2 and
# granite 144 (128 + 16); full attention (no window)
P11_ATTN = [("whisper", (12, 1, 64), 16, 10),
            ("internvl2", (2, 7, 64), 16, 26),
            ("starcoder2", (4, 9, 128), 16, 9),
            ("granite", (1, 48, 128), 16, 9)]
# phase 11's serving cells: 8 slots, 8 requests, 16-token pages, 32-token
# chunks, kv_fp16, W4A16 weights from seed 0
P11_ARGV = ["--batch", "8", "--requests", "8", "--page-size", "16",
            "--prefill-chunk", "32", "--kv-format", "kv_fp16", "--seed", "0"]
P11_PROMPT, P11_GEN = 128, 32
# (c): starcoder2-7b and granite-20b at full width and depth through the
# serve launcher, each built as the launcher chooses from the shapes:
# granite's whole build (95.7 GiB reckoned) passes the card, so it is
# streamed; starcoder2's (28.5 GiB) fits, so it is built whole
DENSE_GEN = 16
DENSE_BUILD = {"starcoder2-7b": "whole", "granite-20b": "streamed"}
# the first requests held against the plain paths
P11_HELD = 4
# the flash encoder (kernel attention) against the chunked encoder (plain
# attention), the same W4A16 GEMMs: both round every activation to bf16
# in a different order for 12 residual layers, then a LayerNorm; held
# within a bf16-scale share of the output's largest value
ENC_TOL = 2 ** -5


def p11_attn_ctx(kind, pages, page):
    """The last context position of an ``attn_case`` at a slot window of
    ``pages`` pages: decode and verify near the window's end, the chunk's
    32 queries ending 8 before it."""
    cache_len = pages * page
    return cache_len - 40 if kind == "chunk" else cache_len - 12


def p11_splits(K, N, M):
    """The Split-K degrees the planner may pick for (M, K, N): every
    group-aligned power of two up to its pick at M = 1, with the pick at
    M and at the engine's M = 8 and 40 plans (which the encoder's M = 1500
    GEMMs reuse)."""
    from repro_torch.kernels import planning
    top = planning.choose_split_k(1, N, K, cores=planning.num_cores("cuda"))
    picks = {planning.choose_split_k(m, N, K,
                                     cores=planning.num_cores("cuda"))
             for m in (M, 8, VERIFY_M)}
    return sorted({1 << i for i in range(top.bit_length())} | picks)


def served_gemms(torch, arch):
    """Every W4A16 GEMM phase 11's engine launches for ``arch``, read from
    the quantized leaves of its full config as the launcher quantizes them
    (the tree built on the meta device: shapes only, no memory):
    {(K, N, group): runs at admit}, the last True for whisper's encoder
    layers and cross K/V projections (M = 1500 as well)."""
    from repro_torch import configs
    from repro_torch.kernels.planning import _quantized_paths
    from repro_torch.models import transformer as T
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=1,
                              encoder_layers=min(full.encoder_layers, 1))
    gen = torch.Generator()
    params = T.quantize_params(T.init_params(gen, cfg, device="meta"), cfg,
                               min_size=0)
    out = {}
    for names, leaf in _quantized_paths(params):
        admit = names[0] == "encoder" or (
            "cross" in names and names[-2] in ("wk", "wv"))
        key = (int(leaf.K), int(leaf.N), int(leaf.group_size))
        out[key] = out.get(key, False) or admit
    return out


def check_p11_gemms(torch, dev, gen):
    """The W4A16 kernel against its plain version (``held``'s tolerances)
    at every shape phase 11's engines launch (``served_gemms``): M = 1, 8,
    32 and 40, and 1500 for the leaves whisper runs at admit; bf16 and
    fp32; at the engine's plans (made at M = 8, or 40 when speculating,
    and reused at every M), the planner's split_k at M and 1, and at
    granite's (6144, 128) every split the planner may pick. Then the
    vocab-wide ``OFF_PATH_GEMM`` at M = 8. Returns the worst bf16 |d|."""
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    worst, n = 0.0, 0
    for arch in P11_ARCHS:
        for (K, N, group), admit in served_gemms(torch, arch).items():
            Ms = P11_M + ((ENCODER_M,) if admit else ())
            for dtype in (torch.bfloat16, torch.float32):
                f32 = dtype == torch.float32
                dt = "fp32" if f32 else "bf16"
                x, qt = carry_gemm_case(torch, K, N, group, max(Ms), gen,
                                        dev, dtype)
                plans = {planned_split(x[:m], qt) for m in (8, VERIFY_M)}
                for M in Ms:
                    xm = x[:M].contiguous()
                    splits = plans | {planned_split(xm, qt), 1}
                    if (K, N) == SPLITK_SHAPE:
                        splits |= set(p11_splits(K, N, M))
                    for s in sorted(splits):
                        err = held("w4a16_gemm", f"{arch} {dt} M={M} K={K} "
                                   f"N={N} group={group} split_k={s}",
                                   w4a16_fused(xm, qt, split_k=s),
                                   w4a16_fused_plain(xm, qt, split_k=s),
                                   f32=f32)
                        n += 1
                        if not f32:
                            worst = max(worst, err)
                del x, qt
    what, K, N = OFF_PATH_GEMM
    x, qt = gemm_case(torch, K, N, 8, gen, dev)
    for s in p11_splits(K, N, 8):
        worst = max(worst, held(
            "w4a16_gemm", f"{what} M=8 K={K} N={N} split_k={s}",
            w4a16_fused(x, qt, split_k=s),
            w4a16_fused_plain(x, qt, split_k=s), f32=False))
        n += 1
    del x, qt
    torch.cuda.empty_cache()
    log("kernels", f"w4a16_gemm at phase 11's served shapes: {n} cases "
        f"held, worst bf16 max|d|={worst:.3e} ok")
    return worst


def check_p11_attention(torch, dev, gen):
    """Paged attention at the phase-11 archs' heads (G = 1, 7, 9 and 48;
    D = 64 and 128): decode, the 32-token chunk and the k = 4 verify step,
    full attention, one partition and the planner's pick, kv_fp16 (and
    kv8_channel at granite's G = 48); held as ``check_attention`` holds
    danube's."""
    worst = 0.0
    for arch, heads, page, pages in P11_ATTN:
        fmts = ("kv_fp16", "kv8_channel") if arch == "granite" \
            else ("kv_fp16",)
        for fmt_name in fmts:
            for kind in ("decode", "chunk", "verify"):
                c = attn_case(torch, gen, dev, fmt_name=fmt_name, kind=kind,
                              heads=heads, page=page, pages=pages,
                              ctx=p11_attn_ctx(kind, pages, page))
                for parts in sorted({1, c["planned"]}):
                    worst = max(worst, hold_partials(
                        torch, c, f"{arch} G={heads[1]} D={heads[2]} {kind}",
                        fmt_name, "bf16", 0, parts))
    return worst


def time_p11(torch, dev, gen, timer, card, floor_ms):
    """Phase 5's rows of phase 11 (bf16, L2 flushed): the W4A16 kernel at
    every served shape (``served_gemms``) at M = 8, whisper's admit shapes
    at M = 1500 and ``OFF_PATH_GEMM`` at M = 8, at the planned split_k,
    beside its bound, the timer's floor,
    its plain version and dequant + ``torch.matmul`` (row 1d); Split-K
    against data-parallel at granite's (6144, 128), M = 1, 8 and 16 (the
    paper's K >> N regime); paged attention at granite's G = 48 (decode and
    chunk) and whisper's G = 1 decode (rows 4c) beside gather + SDPA; the
    flash kernel non-causal at whisper's encoder shape (row 7b) beside its
    plain version and SDPA; and whisper's decode-step cross-attention (12
    layers of 8 queries over 1500 frames, plain PyTorch as in the JAX
    package) beside its bound and SDPA. Returns the rows."""
    import torch.nn.functional as F
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm import (gemm_geometry, sm_count,
                                          sums_in_kernel)
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    from repro_torch.models import attention
    rows = {}
    cases = []
    for arch in P11_ARCHS:
        gemms = served_gemms(torch, arch)
        cases += [(arch, K, N, 8) for K, N, _ in gemms]
        cases += [(f"{arch} encoder", K, N, ENCODER_M)
                  for (K, N, _), admit in gemms.items() if admit]
    what, K, N = OFF_PATH_GEMM
    cases.append((what, K, N, 8))
    for arch, K, N, M in cases:
        x, qt = gemm_case(torch, K, N, M, gen, dev)
        s = planned_split(x, qt)
        nbytes = cm.w4a16_gemm_bytes(M, N, K)
        flops = cm.w4a16_gemm_flops(M, N, K)
        r = dict(ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                 plain_ms=timer(lambda: w4a16_fused_plain(x, qt, split_k=s)),
                 library_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                 bound_ms=cm.roofline_s(nbytes, flops) * 1e3,
                 bound_by=cm.bound_by(nbytes, flops), split_k=s)
        rows[(arch, M, K, N)] = r
        log("timing", f"w4a16_gemm {arch} M={M} K={K} N={N} split_k={s}: "
            f"kernel {r['ms']:.4f} ms, {gbs(nbytes, r['ms'])}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of roofline; the timer's floor "
            f"{floor_ms:.4f}), plain {r['plain_ms']:.4f} ms, dequant+matmul "
            f"{r['library_ms']:.4f} ms [{card}]")
        del x, qt
    K, N = SPLITK_SHAPE
    for M in SPLITK_M:
        x, qt = gemm_case(torch, K, N, M, gen, dev)
        nbytes = cm.w4a16_gemm_bytes(M, N, K)
        bound = cm.roofline_s(nbytes, cm.w4a16_gemm_flops(M, N, K)) * 1e3
        # the launch each split makes: the kernel splits K further inside a
        # cluster while the grid is small, so several plan splits can share
        # one launch; each distinct launch is timed once
        launches = {}
        for s in p11_splits(K, N, M):
            geo = gemm_geometry("int4", M, N, K, s, torch.bfloat16,
                                direct=sums_in_kernel(s, torch.bfloat16,
                                                      torch.bfloat16),
                                group=128, sms=sm_count(dev))
            launches.setdefault((geo.ks, geo.cluster, geo.grid), []).append(s)
        times = {}
        for (ks, cl, grid), splits in launches.items():
            t = timer(lambda: w4a16_fused(x, qt, split_k=splits[0]))
            times[splits[0]] = t
            log("timing", f"w4a16_gemm granite K={K} N={N} M={M} split_k "
                f"{splits}: one launch of {grid[0] * grid[1] * grid[2]} "
                f"blocks (grid {grid}), {ks} along K in clusters of {cl}"
                f"{'' if cl == ks else ', fp32 partials summed after'}: "
                f"{t:.4f} ms, bound {bound:.4f} ms ({bound / t:.1%}) "
                f"[{card}]")
        pick = planned_split(x, qt)
        rows[("splitk", M)] = dict(times=times, pick=pick, bound_ms=bound)
        log("timing", f"w4a16_gemm granite K={K} N={N} M={M}: the planner "
            f"picks split_k={pick}; split_k=1 (the narrowest launch the "
            f"kernel makes: 2 column tiles with K split 8 ways in one "
            f"cluster) over the widest Split-K "
            f"{times[1] / times[max(times)]:.2f}x [{card}]")
        del x, qt
    for arch, heads, page, pages in P11_ATTN:
        kinds = ("decode", "chunk") if arch == "granite" else \
            ("decode",) if arch == "whisper" else ()
        for kind in kinds:
            c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                          heads=heads, page=page, pages=pages,
                          ctx=p11_attn_ctx(kind, pages, page))
            rows[("attn", arch, kind)] = time_attn_case(
                torch, timer, c, 0, f"{arch} G={heads[1]} D={heads[2]} "
                f"{kind}", card)
    # flash non-causal at whisper's encoder: B = 1, 1500 frames, 12 heads
    S, H, D = 1500, 12, 64
    q, k, v = flash_inputs(torch, gen, dev, 1, S, S, H, H, D, torch.bfloat16)
    pairs = cm.attn_pairs(S, S, causal=False, window=0)
    nbytes = cm.flash_attn_bytes(1, S, S, H, H, D)
    flops = cm.flash_attn_flops(1, H, D, pairs)
    qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    r = dict(ms=timer(lambda: fa.flash_attention_forward(
                 q, k, v, causal=False, window=0)),
             plain_ms=timer(lambda: fa.flash_attention_plain(
                 q, k, v, causal=False, window=0)),
             library_ms=timer(lambda: F.scaled_dot_product_attention(
                 qt_, kt, vt)),
             bound_ms=cm.roofline_s(nbytes, flops) * 1e3,
             bound_by=cm.bound_by(nbytes, flops))
    rows["flash encoder"] = r
    log("timing", f"flash_attention whisper encoder (B=1, S={S}, {H} heads "
        f"of {D}, non-causal, bf16): kernel {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{r['bound_ms'] / r['ms']:.1%} of roofline), plain "
        f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms [{card}]")
    # whisper's decode-step cross-attention, one layer, x 12
    L, B = 12, 8
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = cm.flash_attn_bytes(B, 1, S, H, H, D)
    flops = cm.flash_attn_flops(B, H, D, S)
    r = dict(ms=L * timer(lambda: attention.chunked_attention(
                 q, k, v, causal=False, window=0)),
             library_ms=L * timer(lambda: F.scaled_dot_product_attention(
                 qt_, kt, vt)),
             bound_ms=L * cm.roofline_s(nbytes, flops) * 1e3,
             nbytes=L * nbytes)
    rows["cross"] = r
    log("timing", f"whisper cross-attention a decode step ({L} layers x "
        f"{B} queries over {S} frames, {H} heads of {D}; plain PyTorch "
        f"chunked_attention as served): {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['nbytes'] / 1e6:.0f} MB of K/V; "
        f"{r['bound_ms'] / r['ms']:.1%} of roofline), sdpa "
        f"{r['library_ms']:.4f} ms [{card}]")
    del q, k, v, qt_, kt, vt
    torch.cuda.empty_cache()
    return rows


def p11_engine(torch, cfg, params, dev, **kw):
    """A serving engine as phase 11's launcher runs build it (8 slots,
    16-token pages, 32-token chunks, kv_fp16), over ``params``."""
    from repro_torch.runtime.engine import ServingEngine
    base = dict(max_batch=8, max_prompt_len=P11_PROMPT,
                max_new_tokens=P11_GEN, page_size=16, prefill_chunk=32,
                kv_format="kv_fp16", device=dev)
    base.update(kw)
    return ServingEngine(cfg, params, **base)


def launcher_engine(torch, argv, what):
    """The serve launcher's engine and requests for ``argv``
    (``launch.serve.build``: weights drawn from the seed and quantized on
    the card). Returns (engine, requests, its config without the engine's
    plans, for the phase's other engines to plan their own)."""
    from repro_torch.launch import serve as launcher
    log_built("phase11", argv, f" ({what})")
    engine, reqs = launcher.build(launcher.build_args(argv))
    return engine, reqs, dataclasses.replace(engine.cfg, w4a16_plan=None)


def served_run(torch, engine, reqs, table, card, what, expect):
    """Phase 11's counted run: every count set to 0 just before, read just
    after; the requests served with 4 decode steps traced
    (``decode_trace``, each step launching ``expect``; one prefill chunk
    traced first, except for encdec, whose first step also runs the
    encoder at admit: ``encoder_check`` times that); only the path's
    kernels may launch. Returns (report, launches)."""
    reset_counts(table)
    rep = decode_trace(torch, engine, reqs, card, what, phase="phase11",
                       expect=expect,
                       trace_prefill=engine.cfg.family != "encdec")
    launches = read_counts(table)
    log("phase11", f"{what}: launches during the run: {launches}")
    want = {k for k, v in expect.items() if v}
    if engine.cfg.family == "encdec":
        want.add("flash_attention")
    got = {k for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launched {sorted(got)}, the path's "
                             f"kernels are {sorted(want)}")
    return rep, launches


def plain_held(torch, dev, cfg, params, reqs, rep, what, gen_len, **kw):
    """The first P11_HELD requests on the plain paths (``--strategy
    reference --attn-path gather``, chunked attention), 2 tokens each,
    their prefill logits held within LOGIT_TOL of ``rep``'s."""
    plain_cfg = dataclasses.replace(cfg, w4a16_strategy="reference",
                                    attn_impl="chunked")
    t0 = time.perf_counter()
    held_reqs = [dataclasses.replace(r, max_new_tokens=2)
                 for r in reqs[:P11_HELD]]
    plain = p11_engine(torch, plain_cfg, params, dev, attn_path="gather",
                       **kw).run(held_reqs)
    torch.cuda.synchronize()
    log("phase11", f"{what}: plain paths served the first {P11_HELD} requests "
        f"in {time.perf_counter() - t0:.1f} s")
    compare_logits(first_requests(rep, P11_HELD), plain, what, gen_len)


def speculate_ngram(torch, engine, reqs, table, what, card, accept=False):
    """Speculation at k = 4 (ngram, or ``engine``'s own proposer): every
    verify step launches the W4A16 kernel and paged attention (planned
    fused), every emitted token the verify step's own argmax
    (``check_acceptance``); with ``accept``, at least one draft accepted."""
    records, quiet = capture_verify(engine, table)
    t0 = time.perf_counter()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    check_verify_path(engine, records, quiet, what)
    check_acceptance(records, rep.results, engine.pos0(reqs[0]), what,
                     phase="phase11")
    log("phase11", f"{what}: {rep.accepted_tokens}/{rep.proposed_tokens} "
        f"drafts accepted over {len(records)} verify steps, "
        f"{rep.decode_tokens} tokens in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    if accept and not rep.accepted_tokens:
        raise AssertionError(f"{what}: no verify step accepted a draft")
    return rep


def sharing_tables(torch, engine, reqs):
    """Serve ``reqs`` (all admitted at step 0) and return each slot's block
    table as it stands when every slot has prefilled, and the report."""
    engine.start()
    for r in reqs:
        engine.submit(r)
    while engine.report.decode_tokens < len(reqs):
        engine.step()
    tables = engine._tables.copy()
    return tables, engine.drain()


def shared_pages(a, b):
    """Leading table entries two slots share (the same live block)."""
    n = 0
    while n < len(a) and a[n] >= 0 and a[n] == b[n]:
        n += 1
    return n


def check_shared(tables, pairs, what):
    """``pairs``: (slot, slot, pages they must share); beyond those pages
    the two tables hold no common block."""
    out = []
    for i, j, want in pairs:
        n = shared_pages(tables[i], tables[j])
        later = set(int(x) for x in tables[i][n:] if x >= 0) \
            & set(int(x) for x in tables[j] if x >= 0)
        out.append((i, j, n, want, sorted(later)))
    ok = all(n == want and not later for _, _, n, want, later in out)
    log("phase11", f"{what}: pages shared (slot, slot, shared, required, "
        f"common blocks past them): {out} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: prefix sharing differs: {out}")


def whisper_requests(cfg, prompts, audios, gen):
    from repro_torch.runtime.engine import Request
    return [Request(rid=i, prompt=p, max_new_tokens=gen, audio_embeds=a)
            for i, (p, a) in enumerate(zip(prompts, audios))]


def encoder_check(torch, cfg, engine, req, card):
    """The flash encoder against the chunked one on one request's frames
    (the same W4A16 GEMMs): the encoder output and the cross K/V within
    ENC_TOL of the largest chunked value; and the encoder's time a request
    at admit (``_insert_enc_kv``: the encoder and 12 layers' cross K/V),
    host clock to a sync and device time under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    audio = engine._audio_embeds(req)[None]
    chunked = dataclasses.replace(engine.cfg, attn_impl="chunked")
    flash = dataclasses.replace(engine.cfg, attn_impl="flash")
    gaps = []
    for name, f, c in (
            ("encoder output", T._encoder_forward(engine.params, flash, audio),
             T._encoder_forward(engine.params, chunked, audio)),
            ("cross K", *[T.encode_cross_kv(engine.params, m, audio)[0]
                          for m in (flash, chunked)]),
            ("cross V", *[T.encode_cross_kv(engine.params, m, audio)[1]
                          for m in (flash, chunked)])):
        d = float((f.float() - c.float()).abs().max())
        scale = float(c.float().abs().max())
        gaps.append((name, d, scale))
    ok = all(d <= ENC_TOL * s for _, d, s in gaps)
    log("phase11", f"whisper encoder, flash vs chunked attention: "
        + "; ".join(f"{n} max|d|={d:.3e} (max|chunked| {s:.2f})"
                    for n, d, s in gaps)
        + f" {'ok' if ok else 'FAIL'} (|d| <= 2^-5 x max|chunked|: bf16 "
        f"rounding of every activation in another order over 12 layers)")
    if not ok:
        raise AssertionError("whisper: the flash encoder disagrees with the "
                             "chunked encoder")
    engine.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine._insert_enc_kv(0, req)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine._insert_enc_kv(0, req)
        torch.cuda.synchronize()
    rows, busy, ops = device_rows(prof, 1)
    log("phase11", f"whisper encoder a request at admit (12 layers over 1500 "
        f"frames, then 12 layers' cross K/V): {wall:.2f} ms wall to a sync, "
        f"device busy {busy:.3f} ms in {ops:.0f} device ops [{card}]")
    for e in rows[:4]:
        log("phase11", f"  encoder device "
            f"{e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5.0f} "
            f"{e.key[:80]}")


def cpu_share_replica(torch, arch, reqs_fn):
    """The page bookkeeping of a sharing schedule on the CPU at a tiny
    width (``arch``'s family and serving settings, 1 layer, d_model 64,
    fp32): it depends on positions and the content's equality pattern, not
    on width. ``reqs_fn(cfg)`` gives the requests. Returns {share: (peak
    pages, prefill steps saved)}."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import ServingEngine
    cfg = dataclasses.replace(
        configs.get_config(arch), num_layers=1, d_model=64, num_heads=4,
        num_kv_heads=2 if arch != "whisper-small" else 4, head_dim=16,
        d_ff=128, encoder_layers=1, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device="cpu"), cfg,
                               min_size=0)
    out = {}
    for share in (True, False):
        rep = p11_engine(torch, cfg, params, "cpu", share_prefix=share,
                         max_new_tokens=8).run(reqs_fn(cfg))
        out[share] = (rep.peak_pages, rep.prefill_steps_saved)
    return out


def whisper_sharing(torch, engine, cfg, card):
    """Two pairs of 128-token prompts sharing a 64-token prefix: pair A over
    one audio must share the prefix's 4 pages, pair B over two audios none
    (the audio seeds the page keys). Against ``share_prefix=False``: first-
    token logits within LOGIT_TOL, pages and prefill steps saved equal to a
    CPU replica of the schedule."""
    import numpy as np
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 64)])
               .astype(np.int32) for _ in range(4)]

    def audios(c):
        a = [np.random.default_rng([12, i]).standard_normal(
            (c.encoder_seq, c.d_model), dtype=np.float32) for i in range(3)]
        return [a[0], a[0], a[1], a[2]]

    def reqs(c):
        return whisper_requests(c, prompts, audios(c), 8)

    kw = dict(max_new_tokens=8)
    tables, shared = sharing_tables(torch, p11_engine(
        torch, cfg, engine.params, engine.device, **kw), reqs(cfg))
    check_shared(tables, [(0, 1, 4), (2, 3, 0), (0, 2, 0)], "whisper, "
                 "the same audio (slots 0, 1) and different audio (slots 2, "
                 "3; 0 and 2)")
    unshared = p11_engine(torch, cfg, engine.params, engine.device,
                          share_prefix=False, **kw).run(reqs(cfg))
    check_replica(torch, shared, unshared, cpu_share_replica(
        torch, "whisper-small", reqs), "whisper")


def check_replica(torch, shared, unshared, cpu, what):
    d = max(float((shared.prefill_logits[r] - unshared.prefill_logits[r])
                  .abs().max()) for r in shared.results)
    saved = (unshared.peak_pages - shared.peak_pages,
             shared.prefill_steps_saved)
    want = (cpu[False][0] - cpu[True][0], cpu[True][1])
    ok = d <= LOGIT_TOL and saved == want and saved[0] > 0
    log("phase11", f"{what} prefix sharing: pages saved {saved[0]} (peak "
        f"{shared.peak_pages} vs {unshared.peak_pages}), prefill steps "
        f"saved {saved[1]}; the CPU replica {want}; first-token logits "
        f"shared vs unshared max|d|={d:.3e} (tolerance {LOGIT_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: prefix sharing disagrees")


def whisper_serve(torch, dev, card, table):
    """Phase 11(a): whisper-small at full width and depth (12 + 12 layers,
    d_model 768, 12 heads of 64, d_ff 3072, vocab 51865, 1500 frames)
    through the serve launcher's engine (W4A16, 8 slots, 8 requests of 128
    + 32 tokens, each with its own 1500 x 768 frames): the counted run
    with 4 traced decode steps each launching 96 W4A16 GEMMs (8 a layer:
    q, k, v, o, cross q and o, w_up, w_down) and 12 paged-attention calls,
    the encoder's flash launches at admit; the plain paths on the first
    requests; the flash encoder against the chunked one and its time a
    request; sharing over the same and different audio; ngram at k = 4."""
    import numpy as np
    t0 = time.perf_counter()
    argv = ["--arch", "whisper-small", "--prompt-len", str(P11_PROMPT),
            "--gen", str(P11_GEN)] + P11_ARGV
    engine, reqs, cfg = launcher_engine(torch, argv, "whisper-small")
    log("phase11", f"whisper-small: {cfg.num_layers} + {cfg.encoder_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.encoder_seq} frames; {cfg.param_count() / 1e9:.3f} B params; "
        f"attention {cfg.attn_impl}")
    rep, launches = served_run(torch, engine, reqs, table, card,
                               "whisper-small w4a16",
                               {"w4a16_gemm": 8 * cfg.num_layers,
                                "paged_attention": cfg.num_layers})
    plain_held(torch, dev, cfg, engine.params, reqs, rep, "whisper-small "
               "kernel path", P11_GEN)
    encoder_check(torch, cfg, engine, reqs[0], card)
    whisper_sharing(torch, engine, cfg, card)
    rng = np.random.default_rng(13)
    prompts = [np.resize(rng.integers(0, cfg.vocab_size, 16), 64)
               .astype(np.int32) for _ in range(8)]
    spec = p11_engine(torch, cfg, engine.params, dev,
                      speculate="ngram", spec_k=SPEC_K)
    speculate_ngram(torch, spec, whisper_requests(
        cfg, prompts, [r.audio_embeds for r in reqs], P11_GEN), table,
        "whisper-small ngram", card)
    del spec, engine
    torch.cuda.empty_cache()
    log("phase11", f"whisper-small took {time.perf_counter() - t0:.1f} s")
    return launches


def vision_requests(cfg, prompts, patches, gen):
    from repro_torch.runtime.engine import Request
    return [Request(rid=i, prompt=p, max_new_tokens=gen, prefix_embeds=pe)
            for i, (p, pe) in enumerate(zip(prompts, patches))]


def vision_sharing(torch, engine, cfg, card):
    """Three requests over one 128-token prompt prefix: slots 0 and 1 with
    identical patches and the same 64-token prompt prefix share the 16
    patch pages and the prefix's 4; slot 2's patches differ from slot 0's
    in row 100 (page 6), so it shares pages 0-5 only. Against
    ``share_prefix=False``, as ``whisper_sharing``."""
    import numpy as np
    rng = np.random.default_rng(14)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 64)])
               .astype(np.int32) for _ in range(2)]
    prompts.append(prompts[0])

    def patches(c):
        p = np.random.default_rng(15).standard_normal(
            (c.vision_prefix, c.d_model), dtype=np.float32)
        q = p.copy()
        q[100] += 1.0
        return [p, p, q]

    def reqs(c):
        return vision_requests(c, prompts, patches(c), 8)

    kw = dict(max_new_tokens=8)
    tables, shared = sharing_tables(torch, p11_engine(
        torch, cfg, engine.params, engine.device, **kw), reqs(cfg))
    check_shared(tables, [(0, 1, 20), (0, 2, 6)], "internvl2, the same "
                 "patches and prompt prefix (slots 0, 1), patch row 100 "
                 "differing (slots 0, 2)")
    unshared = p11_engine(torch, cfg, engine.params, engine.device,
                          share_prefix=False, **kw).run(reqs(cfg))
    check_replica(torch, shared, unshared, cpu_share_replica(
        torch, "internvl2-1b", reqs), "internvl2")


def vision_front_door(torch, engine, req, card):
    """One request with its 256 x 896 patches as ``prefix_embeds`` over
    HTTP on 127.0.0.1: the SSE stream equals ``engine.run``'s tokens for
    the same request."""
    import asyncio
    import numpy as np
    from repro_torch.runtime.frontdoor import FrontDoor, sse_decode_tokens
    ref = engine.run([req])

    async def main():
        fd = FrontDoor(engine)
        await fd.serve()
        body = json.dumps({
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": req.max_new_tokens,
            "prefix_embeds": np.asarray(req.prefix_embeds,
                                        np.float32).tolist()}).encode()
        reader, writer = await asyncio.open_connection("127.0.0.1", fd.port)
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        payload = await reader.read()
        writer.close()
        await fd.shutdown()
        return int(payload.split(b" ", 2)[1]), payload, len(body)

    status, payload, nbytes = asyncio.run(asyncio.wait_for(main(), 300))
    got = sse_decode_tokens(payload)
    ok = status == 200 and got == ref.results[req.rid]
    log("phase11", f"internvl2 front door: one request with prefix_embeds "
        f"({nbytes / 1e6:.1f} MB of JSON): status {status}, "
        f"{len(got)} tokens, equal to engine.run's "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError(f"internvl2 front door: {status} {got} vs "
                             f"{ref.results[req.rid]}")


# internvl2 keeps 12 of its 24 layers, paying for phase 14's elastic run
# and phase 15
VISION_LAYERS = 12


def vision_serve(torch, dev, card, table):
    """Phase 11(b): internvl2-1b at full width (the depth ``configs.
    get_config`` gives: ``VISION_LAYERS`` in ``p11_serve``; 24 layers,
    d_model 896, 14/2 heads of 64, d_ff 4864, vocab 151655 padded to
    151808) through the serve launcher's engine (W4A16, 8 slots, 8
    requests of 256 patches + 128 + 32 tokens): the counted run with 4
    traced decode steps each launching 168 W4A16 GEMMs and 24
    paged-attention calls; the plain paths on the first requests;
    sharing by patches; ngram at k = 4, and oracle drafts (the counted
    run's tokens) that must be accepted; one request through the front
    door."""
    import numpy as np
    t0 = time.perf_counter()
    argv = ["--arch", "internvl2-1b", "--prompt-len", str(P11_PROMPT),
            "--gen", str(P11_GEN)] + P11_ARGV
    engine, reqs, cfg = launcher_engine(torch, argv, "internvl2-1b")
    log("phase11", f"internvl2-1b: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.vision_prefix} patches; "
        f"{cfg.param_count() / 1e9:.3f} B params")
    rep, launches = served_run(torch, engine, reqs, table, card,
                               "internvl2-1b w4a16",
                               {"w4a16_gemm": 7 * cfg.num_layers,
                                "paged_attention": cfg.num_layers})
    plain_held(torch, dev, cfg, engine.params, reqs, rep, "internvl2-1b "
               "kernel path", P11_GEN)
    vision_sharing(torch, engine, cfg, card)
    rng = np.random.default_rng(16)
    prompts = [np.resize(rng.integers(0, cfg.vocab_size, 16), 64)
               .astype(np.int32) for _ in range(8)]
    spec = p11_engine(torch, cfg, engine.params, dev,
                      speculate="ngram", spec_k=SPEC_K)
    speculate_ngram(torch, spec, vision_requests(
        cfg, prompts, [r.prefix_embeds for r in reqs], P11_GEN), table,
        "internvl2-1b ngram", card)
    # drafts that mostly pass (random weights continue no prompt): the
    # counted run's own tokens, so accepted drafts are committed at
    # positions past the 256 patches
    oracle_reqs = reqs[:P11_HELD]
    spec = p11_engine(torch, cfg, engine.params, dev,
                      speculate=oracle_proposer(torch, oracle_reqs,
                                                rep.results),
                      spec_k=SPEC_K)
    speculate_ngram(torch, spec, oracle_reqs, table,
                    "internvl2-1b oracle drafts", card, accept=True)
    del spec
    vision_front_door(torch, p11_engine(torch, cfg, engine.params,
                                        dev, max_new_tokens=8,
                                        admission="priority"),
                      dataclasses.replace(reqs[0], max_new_tokens=8), card)
    del engine
    torch.cuda.empty_cache()
    log("phase11", f"internvl2-1b took {time.perf_counter() - t0:.1f} s")
    return launches


def dense_serve(torch, dev, card, table, arch):
    """Phase 11(c): ``arch`` at full width and depth through the serve
    launcher, built as ``DENSE_BUILD`` expects the launcher to choose
    (W4A16, 8 slots, 8 requests of 128 + 16): the counted run with 4 traced decode steps, each
    launching the W4A16 kernel 7 (SwiGLU) or 6 (GELU) times a layer and
    paged attention once a layer; the plain paths on the first requests."""
    t0 = time.perf_counter()
    argv = ["--arch", arch] + P11_ARGV + [
        "--prompt-len", str(P11_PROMPT), "--gen", str(DENSE_GEN)]
    engine, reqs, cfg = full_depth_engine(torch, argv, "phase11", card,
                                          DENSE_BUILD[arch])
    L = cfg.num_layers
    per_layer = 7 if cfg.mlp_type == "swiglu" else 6
    rep, launches = served_run(torch, engine, reqs, table, card,
                               f"{arch} {L}L w4a16",
                               {"w4a16_gemm": per_layer * L,
                                "paged_attention": L})
    params = engine.params
    del engine
    plain_held(torch, dev, cfg, params, reqs, rep, f"{arch} {L}L kernel "
               f"path", DENSE_GEN, max_new_tokens=DENSE_GEN)
    del params
    torch.cuda.empty_cache()
    log("phase11", f"{arch} took {time.perf_counter() - t0:.1f} s")
    return launches


def p11_serve(torch, dev, card, table):
    """Phase 11: (a) whisper-small, (b) internvl2-1b, (c) starcoder2-7b and
    granite-20b at full depth (granite built streamed)."""
    t0 = time.perf_counter()
    launches = whisper_serve(torch, dev, card, table)
    with depth_cut("internvl2-1b", VISION_LAYERS, "phase11"):
        vision_serve(torch, dev, card, table)
    for arch in ("starcoder2-7b", "granite-20b"):
        dense_serve(torch, dev, card, table, arch)
    log("phase11", f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: train the families
# ---------------------------------------------------------------------------

# (arch, decoder layers kept (None: all), rows, text tokens a row): full
# width, random weights from seed 0, the full configs' remat; the vision
# prefix adds its 256 patches to every row, whisper's encoder its 1500
# frames. Depth is cut where 80 GB forces it: mixtral keeps 1 layer, since
# 2 would hold 75.3 GiB at the update's peak (``launch.train.train_bytes``);
# and where the script's time does: hymba keeps 4 of its 32 layers (its
# stepped SSM scan made its steps 8.4-12.3 s each at 32), paying for
# phases 13 and 14's carry-family and whisper runs; internvl2 keeps 12 of
# its 24, paying with phases 8, 9 and 11's cuts for phase 14's elastic
# run and phase 15
FAMILY_TRAIN = [
    ("whisper-small", None, 4, 448),
    ("internvl2-1b", 12, 2, 1792),
    ("hymba-1.5b", 4, 2, 1280),
    ("olmoe-1b-7b", 4, 2, 1024),
    ("mixtral-8x7b", 1, 1, 1024),
    ("rwkv6-7b", 8, 2, 512),
    ("starcoder2-7b", 4, 1, 1024),
    ("granite-20b", 4, 1, 1024),
]
# steps of each path held against the other; the flash run goes on to
# FAMILY_TIMED steps, and its step time is the median of steps 1 to 3
FAMILY_STEPS = 2
FAMILY_TIMED = 4
# hymba's paths are held in fp32: in bf16 two plain attention orders
# alone (chunks of 1024 and of 512) move its m by 4.36e-2 to 6.30e-2 over
# seeds 0-3 against the 5e-2 bound (SSM projections), and the kernel's
# order by 4.64e-2 to 6.33e-2, one spread (scripts/hymba_bf16_spread.py;
# an H100 80GB HBM3 at 700 W). Its bf16 flash steps are timed, and the
# kernel is held at its bf16 shape by ``check_family_flash`` and
# ``check_flash_grads``.
FP32_HELD = {"hymba-1.5b"}
TRAIN_MEM_CAP = 70 * 2 ** 30
FAMILY_LAUNCH_ARGV = ["--arch", "whisper-small", "--steps", "3", "--batch",
                      "4", "--seq", "448", "--ckpt-every", "2"]


def family_config(arch, layers):
    """The full config at ``layers`` decoder layers, the cut printed; its
    training state (``launch.train.train_bytes``) must stay under
    ``TRAIN_MEM_CAP``."""
    from repro_torch import configs
    from repro_torch.launch.train import (LEAF_TEMP_BYTES,
                                          TRAIN_BYTES_PER_PARAM, train_bytes)
    full = configs.get_config(arch)
    cfg = full if layers is None else \
        dataclasses.replace(full, num_layers=layers)
    if cfg.num_layers < full.num_layers:
        more = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
        log("train-families", f"{arch}: depth cut to {cfg.num_layers} of "
            f"{full.num_layers} layers, full width: all {full.num_layers} "
            f"would hold {train_bytes(full) / 2**30:.1f} GiB at the "
            f"update's peak, {more.num_layers} "
            f"{train_bytes(more) / 2**30:.1f} GiB ({TRAIN_BYTES_PER_PARAM} B "
            f"a parameter + {LEAF_TEMP_BYTES} B an element of the largest "
            f"leaf)")
    if train_bytes(cfg) > TRAIN_MEM_CAP:
        raise AssertionError(f"{arch}: {train_bytes(cfg)} B of training "
                             f"state pass {TRAIN_MEM_CAP}")
    return cfg


def train_flops(cfg, B, S) -> float:
    """6·N·T (N the active parameters, embedding included, as phase 7
    counts) plus 12·B·Hq·D per attention pair a layer (QKᵀ and PV, the
    backward twice the forward); whisper's encoder and cross K/V
    projections run over its frames, its cross-attention over S x frames
    pairs. Remat recompute and the scans are not counted."""
    from repro_torch.core import costmodel as cm
    St = S + cfg.vision_prefix
    n = cfg.active_param_count()
    if cfg.family == "rwkv":
        return 6.0 * n * B * St
    per_pair = 12.0 * B * cfg.num_heads * cfg.head_dim
    flops = per_pair * cfg.num_layers * cm.attn_pairs(
        St, St, causal=True, window=cfg.sliding_window)
    if cfg.family != "encdec":
        return flops + 6.0 * n * B * St
    d, T = cfg.d_model, cfg.encoder_seq
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    mlp = 2 * d * cfg.d_ff
    n_frames = cfg.encoder_layers * (attn + mlp) \
        + cfg.num_layers * 2 * d * cfg.kv_dim
    return flops + 6.0 * n_frames * B * T + 6.0 * (n - n_frames) * B * S \
        + per_pair * (cfg.encoder_layers * T * T + cfg.num_layers * S * T)


def family_run(torch, dev, cfg, impl, batches, table, routing=None,
               replay=False, seed=0, keep=True):
    """One step of ``make_train_step`` through ``impl`` per batch, from
    the parameters of ``seed`` (drawn anew, so no copy is held), with the
    counts set to 0 just before and read just after; MoE expert choices
    recorded into ``routing`` (the first ``FAMILY_STEPS`` steps' only),
    or replayed from it with ``replay``. Returns the (loss, grad norm,
    seconds) per step, the moments after ``FAMILY_STEPS`` steps (with
    ``keep``; on the host if more steps follow), the counts."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import steps
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = T.init_params(gen, cfg, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt_cfg)
    step_fn = steps.make_train_step(
        dataclasses.replace(cfg, attn_impl=impl), opt_cfg)
    ctx = contextlib.nullcontext() if routing is None else \
        routing.replaying() if replay else routing.recording()
    metrics, held, n_calls = [], None, 0
    torch.cuda.synchronize()
    reset_counts(table)
    with ctx:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state,
                                       {"batch": batch, "step": i})
            torch.cuda.synchronize()
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            time.perf_counter() - t0))
            if i + 1 == FAMILY_STEPS and keep:
                held = {"m": state["m"], "v": state["v"]}
                if len(batches) > FAMILY_STEPS:
                    held = tree_to(torch, held, "cpu")
                n_calls = len(routing.calls) if routing is not None else 0
    launched = read_counts(table)
    if impl == "flash" and not replay:
        # the peak since train_family's reset, less what was there before
        # this run's weights: the flash run's own (phase 15)
        B, S = batches[0]["tokens"].shape
        PEAKS[f"{cfg.name}-train-{B}x{S} flash {dtype_name(cfg)}"] = (
            torch.cuda.max_memory_allocated() - base,
            dict(B=B, S=S, layers=cfg.num_layers))
    if routing is not None and not replay:
        del routing.calls[n_calls:]
    del params, state
    return metrics, held, launched


def dtype_name(cfg) -> str:
    return str(cfg.dtype).split(".")[-1]


def median_step_s(metrics) -> float:
    """The median seconds of the steps after the first."""
    times = sorted(t for _, _, t in metrics[1:])
    return times[len(times) // 2]


def hold_family(torch, phase, label, mk, tk, mp, tp):
    """Loss and grad norm per step over the first ``FAMILY_STEPS`` steps,
    m and v after them, within ``TRAIN_TOL``."""
    bad = []
    for i in range(FAMILY_STEPS):
        for j, name in enumerate(("loss", "grad_norm")):
            d = abs(mk[i][j] - mp[i][j]) / abs(mp[i][j])
            ok = d <= TRAIN_TOL[name]
            bad += [] if ok else [f"step {i} {name}"]
            log(phase, f"{label} step {i} {name}: flash {mk[i][j]:.6f} vs "
                f"chunked {mp[i][j]:.6f}, |d|/|chunked| {d:.2e} "
                f"{'ok' if ok else 'FAIL'} ({TRAIN_TOL[name]})")
    for name in ("m", "v"):
        d, where = max_rel_diff(torch, tk[name], tp[name])
        ok = d <= TRAIN_TOL[name]
        bad += [] if ok else [name]
        log(phase, f"{label} after step {FAMILY_STEPS}, {name}: max|d| / "
            f"max|chunked| per leaf {d:.3e} (worst {where}) "
            f"{'ok' if ok else 'FAIL'} ({TRAIN_TOL[name]:.3g})")
    if bad:
        raise AssertionError(f"{label}: the flash and chunked training paths "
                             f"disagree: {bad}")


def compare_paths(torch, dev, cfg, batches, table, label, *,
                  phase="train-families", plain=True):
    """One flash step per batch, then (with ``plain``, and but for an
    attention-free arch) ``FAMILY_STEPS`` through the chunked attention
    from the same weights and batches, held by ``hold_family``; MoE
    expert choices of the flash run replayed in the chunked run. The flash
    kernel must launch 2 x the attention layers a step (forward and remat
    recompute, the encoder's included) and nothing else must. Returns the
    flash run's (loss, grad norm, seconds) per step."""
    attn_layers = 0 if cfg.attn_free else \
        cfg.num_layers + cfg.encoder_layers
    want = len(batches) * 2 * attn_layers
    plain = plain and not cfg.attn_free
    routing = Routing() if cfg.family == "moe" and plain else None
    mk, tk, launched = family_run(torch, dev, cfg, "flash", batches, table,
                                  routing, keep=plain)
    others = {n: c for n, c in launched.items()
              if c and n != "flash_attention"}
    log(phase, f"{label} flash: " + "; ".join(
        f"step {i} loss {l:.6f} grad-norm {g:.6f} ({t * 1e3:.1f} ms)"
        for i, (l, g, t) in enumerate(mk))
        + f"; flash launches {launched['flash_attention']} (want {want}: "
        f"2 x {attn_layers} attention layers a step)")
    if launched["flash_attention"] != want or others:
        raise AssertionError(f"{label}: expected {want} flash launches and "
                             f"no other kernel: {launched}")
    if not all(l == l and g == g and abs(l) < 1e4 for l, g, _ in mk):
        raise AssertionError(f"{label}: losses or grad norms not finite "
                             f"{mk}")
    if not plain:
        return mk
    tk = tree_to(torch, tk, "cpu")
    torch.cuda.empty_cache()
    mp, tp, counts = family_run(torch, dev, cfg, "chunked",
                                batches[:FAMILY_STEPS], table, routing,
                                replay=True)
    log(phase, f"{label} chunked: " + "; ".join(
        f"step {i} ({t * 1e3:.1f} ms)" for i, (_, _, t) in enumerate(mp))
        + f"; launches {sum(counts.values())}")
    if any(counts.values()):
        raise AssertionError(f"{label}: the chunked run launched {counts}")
    if routing is not None:
        routing.check(f"{label} training")
        if routing.next != len(routing.calls):
            raise AssertionError(f"{label}: replayed {routing.next} of "
                                 f"{len(routing.calls)} routing calls")
    hold_family(torch, phase, label, mk, tk, mp, tp)
    del tk, tp, routing
    torch.cuda.empty_cache()
    return mk


def train_family(torch, dev, card, table, arch, layers, B, S):
    """One arch of phase 12 (``compare_paths``) at full width, in bf16,
    ``FAMILY_TIMED`` flash steps; an arch in ``FP32_HELD`` runs its bf16
    flash steps alone (times, launches, finite values) and is held by a
    pair of ``FAMILY_STEPS``-step runs in fp32 on the same (unrounded)
    weights. Returns the row of the summary."""
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.launch import train as launcher
    cfg = family_config(arch, layers)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    extra = launcher.extra_inputs(cfg, B, gen, dev)
    batches = [{**stream.batch_at(i), **extra} for i in range(FAMILY_TIMED)]
    shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in extra.items())
    log("train-families", f"{arch}: {cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params "
        f"({cfg.active_param_count() / 1e9:.3f} B active), B = {B} x {S} "
        f"tokens{'; ' + shapes if shapes else ''}; training state "
        f"~{launcher.train_bytes(cfg) / 2**30:.1f} GiB at the update's peak")
    torch.cuda.reset_peak_memory_stats()
    mk = compare_paths(torch, dev, cfg, batches, table, arch,
                       plain=arch not in FP32_HELD)
    peak = torch.cuda.max_memory_allocated()
    if arch in FP32_HELD:
        compare_paths(torch, dev, dataclasses.replace(
            cfg, dtype=torch.float32), batches[:FAMILY_STEPS], table,
            f"{arch} fp32")
    del batches, extra
    torch.cuda.empty_cache()
    step_s = median_step_s(mk)
    tokens = B * (S + cfg.vision_prefix)
    flops = train_flops(cfg, B, S)
    row = dict(arch=arch, layers=cfg.num_layers, step_ms=step_s * 1e3,
               tokens=tokens, mfu=flops / step_s / PEAK_BF16, peak=peak)
    log("train-families", f"{arch}: flash, bf16, median of steps 1-"
        f"{len(mk) - 1} {row['step_ms']:.1f} ms (steps "
        f"{', '.join(f'{t * 1e3:.1f}' for _, _, t in mk[1:])}) for {tokens} "
        f"tokens = {tokens / step_s:.0f} tokens/s, MFU {row['mfu']:.2%} of "
        f"989 TFLOP/s ({flops:.4g} FLOP: 6·N_active·T + 12·B·Hq·D·pairs a "
        f"layer, remat recompute not counted); peak device memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    if peak >= 80e9:
        raise AssertionError(f"{arch}: peak {peak} B is not under 80 GB")
    return row


def family_launcher(torch, card, table):
    """Phase 12's launcher run (``run_launcher``): ``python -m
    repro_torch.launch.train --arch whisper-small`` at full width and
    depth, 4 x 448 tokens over 4 x 1500 frames that must come from the
    launcher's own ``extra_inputs``, 3 steps, checkpoints at steps 0 and
    2, each at least 10 B a parameter (the encoder's included)."""
    from repro_torch import configs
    from repro_torch.launch import train as launcher
    cfg = configs.get_config("whisper-small")
    drawn = []
    draw = launcher.extra_inputs
    launcher.extra_inputs = lambda *a: drawn.append(draw(*a)) or drawn[-1]
    try:
        run_launcher(torch, card, table, "train-families", FAMILY_LAUNCH_ARGV)
    finally:
        launcher.extra_inputs = draw
    audio = [(tuple(ex["audio_embeds"].shape), ex["audio_embeds"].dtype)
             for ex in drawn]
    log("train-families", f"whisper-small launcher: audio drawn {audio}")
    if audio != [((4, cfg.encoder_seq, cfg.d_model), cfg.dtype)]:
        raise AssertionError(f"the launcher's audio: {audio}")


def family_flash_shapes():
    """The flash kernel's shapes in phase 12's training runs: (label, B,
    S, Hq, Hkv, D, causal, window) per arch with attention, and whisper's
    encoder over its frames."""
    from repro_torch import configs
    for arch, _, B, S in FAMILY_TRAIN:
        cfg = configs.get_config(arch)
        if cfg.attn_free:
            continue
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        yield (arch, B, S + cfg.vision_prefix, *heads, True,
               cfg.sliding_window)
        if cfg.family == "encdec":
            yield (f"{arch} encoder", B, cfg.encoder_seq, *heads, False, 0)


def check_family_flash(torch, dev, gen, card):
    """Row 7c: the flash kernel's forward at each family's training shape
    (``family_flash_shapes``: hymba's window and whisper's encoder among
    them) held against its plain version by ``hold_flash`` in fp32 and in
    bf16, then timed in bf16 (L2 flushed, phase 5's ``Timer``) beside its
    bound (bytes: q, k, v read and o, lse written once; operations: 4·D a
    visible pair and query head at 989 TFLOP/s), its plain version and
    ``F.scaled_dot_product_attention`` (``enable_gqa``; an explicit mask
    where the window bites). The SDPA call is timed only. Returns the
    rows and the worst bf16 |d| of the output."""
    from repro_torch.kernels import flash_attention as fa
    timer = Timer(torch, dev, iters=10)
    rows, worst = {}, 0.0
    for label, B, S, Hq, Hkv, D, causal, window in family_flash_shapes():
        for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = flash_inputs(torch, gen, dev, B, S, S, Hq, Hkv, D,
                                   dtype)
            o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                                window=window)
            o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window)
            err = hold_flash(
                torch, "train-families", f"{label} {dt} B={B} S={S} "
                f"{Hq}/{Hkv} heads of {D} causal={causal} window={window}",
                dt, dtype, o, lse, o_p, lse_p)
            del o, lse, o_p, lse_p
        worst = max(worst, err)
        rows[label] = time_flash_shape(torch, timer, q, k, v, label, causal,
                                       window, card, "train-families")
        del q, k, v
    del timer
    torch.cuda.empty_cache()
    return rows, worst


def time_flash_shape(torch, timer, q, k, v, label, causal, window, card,
                     phase):
    """The flash kernel's forward on bf16 ``q, k, v`` timed (``timer``,
    L2 flushed) beside its bound (bytes: q, k, v read and o, lse written
    once; operations: 4·D a visible pair and query head at 989 TFLOP/s),
    its plain version and ``F.scaled_dot_product_attention``
    (``enable_gqa``; an explicit mask where the window bites; timed
    only). Returns the row."""
    import torch.nn.functional as F
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import flash_attention as fa
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    pos = torch.arange(S, device=q.device)
    bites = bool(window) and window < S
    mask = None if not bites else \
        (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                          - window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = cm.attn_pairs(S, S, causal=causal, window=window)
    nbytes = cm.flash_attn_bytes(B, S, S, Hq, Hkv, D)
    flops = cm.flash_attn_flops(B, Hq, D, pairs)
    r = dict(
        ms=timer(lambda: fa.flash_attention_forward(
            q, k, v, causal=causal, window=window)),
        plain_ms=timer(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not bites,
            enable_gqa=True)),
        bound_ms=cm.roofline_s(nbytes, flops) * 1e3,
        bound_by=cm.bound_by(nbytes, flops))
    log(phase, f"flash_attention {label} (B={B}, S={S}, {Hq}/{Hkv} heads "
        f"of {D}, causal={causal}, window={window}, bf16): kernel "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of roofline, "
        f"{flops / r['ms'] / 1e9:.1f} TFLOP/s); plain {r['plain_ms']:.4f} "
        f"ms; sdpa {r['library_ms']:.4f} ms [{card}]")
    return r


def train_families(torch, dev, card, table):
    """Phase 12: every family trains at full width (``FAMILY_TRAIN``),
    the whisper launcher run, and row 7c (``check_family_flash``).
    Returns the flash kernel's worst bf16 |d| there."""
    t0 = time.perf_counter()
    rows = [train_family(torch, dev, card, table, *c) for c in FAMILY_TRAIN]
    log("train-families", "summary: " + "; ".join(
        f"{r['arch']} ({r['layers']} layers) {r['step_ms']:.1f} ms a step, "
        f"MFU {r['mfu']:.2%}, peak {r['peak'] / 2**30:.2f} GiB"
        for r in rows) + f" [{card}]")
    family_launcher(torch, card, table)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    _, worst = check_family_flash(torch, dev, gen, card)
    log("train-families", f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return worst


# template arguments of the attention and GEMM kernels as nvcc mangles
# them
# ---------------------------------------------------------------------------
# phase 13: serving on a (data, model) mesh of ranks sharing the one card
# ---------------------------------------------------------------------------

# the shard-local W4A16 leaves phase 13 runs: (label, K, N, a layer's
# launches of that shape)
MESH_GEMMS = [("llama tp4 wq", 16384, 4096, 1), ("llama tp4 wk/wv", 16384,
                                                 256, 2),
              ("llama tp4 wo", 4096, 16384, 1),
              ("llama tp4 w_gate/w_up", 16384, 13312, 2),
              ("llama tp4 w_down", 13312, 16384, 1),
              ("danube tp2 wq", 2560, 1280, 1),
              ("danube tp2 wk/wv", 2560, 320, 2),
              ("danube tp2 wo", 1280, 2560, 1),
              ("danube tp2 w_gate/w_up", 2560, 3456, 2),
              ("danube tp2 w_down", 3456, 2560, 1)]
# a rank's paged attention: (label, (KV heads, group, head dim), window)
MESH_ATTN = [("llama tp4", (2, 16, 128), 0),
             ("danube tp2", (4, 4, 80), 4096)]
MESH_PROMPT, MESH_GEN, MESH_REQS = 128, 8, 4
# attention forced to the kernel: at llama's G = 16 the planner's cost
# model sends the 32-token chunk to the plain gather path (PERF.md §7),
# where row 4d times the kernel 4.5x faster than gather + SDPA
MESH_KW = dict(max_batch=4, max_prompt_len=MESH_PROMPT,
               max_new_tokens=MESH_GEN, page_size=16, prefill_chunk=32,
               kv_format="kv_fp16", attn_path="fused")
MESH_PAGE, MESH_PAGES = 16, 9       # a slot's 144-token window
# danube's layers in phase 13 (12 of 24, for the script's time), and in
# its fsdp_serve pair (4: that run gathers each layer, the embedding and
# the head through host memory every step; the same mesh without the flag
# at the same depth beside it)
MESH_DANUBE_LAYERS, MESH_FSDP_LAYERS = 12, 4
# (arch, depth cut or None, meshes, ranks draw one after the other, what
# else the run does: "fp32" activations on the quantized weights, "ngram"
# speculation with every verify step's carry commit checked, "fsdp" the
# weight-gathered layers of JAX's fsdp_serve: each rank keeps its shares
# over "data" of its slice and gathers a layer at a time, held against one
# process as every run is and against the same mesh without the flag)
MESH_RUNS = [("h2o-danube-1.8b", MESH_DANUBE_LAYERS, [(1, 2), (2, 2)], False,
              ""),
             ("h2o-danube-1.8b", MESH_FSDP_LAYERS, [(2, 2)], False, ""),
             ("h2o-danube-1.8b", MESH_FSDP_LAYERS, [(2, 2)], False,
              "fsdp"),
             ("llama3-405b", 2, [(1, 4)], True, ""),
             # rwkv's bf16 logits are chaotic on random weights (phase 10):
             # its mesh run is held with fp32 activations
             ("rwkv6-7b", 4, [(1, 4)], False, "fp32"),
             ("hymba-1.5b", 8, [(1, 2), (1, 5)], False, ""),
             ("hymba-1.5b", 8, [(1, 2)], False, "ngram"),
             ("whisper-small", None, [(2, 2)], False, "")]
# the engine's plan M at each mesh (4 slots over the data axis)
MESH_M = (1, 2, 4, 8)
# launches a forward of one request's tokens, per layer: (W4A16, paged
# attention); at each admit, the encoder's (W4A16 and flash per encoder
# layer) and every decoder layer's cross K/V projections (W4A16)
MESH_LAYER_LAUNCHES = {"dense": (7, 1), "rwkv": (8, 0), "hybrid": (10, 1),
                       "encdec": (8, 1)}
ENC_LAYER_GEMMS, CROSS_KV_GEMMS = 6, 2
# the W4A16 leaves the carry-family and whisper runs execute on a rank:
# (label, K, N, group, activation dtype, a layer's launches of that
# shape, Ms: decode rows, the 32-token chunk, [the k = 4 verify step's
# 4 x 5 rows] [whisper's 1500 frames at admit])
MESH_FAMILY_GEMMS = [
    ("rwkv tp4 tm_r/k/v/g/w", 4096, 1024, 128, "fp32", 5, (1, 2, 4, 8, 32)),
    ("rwkv tp4 tm_o", 1024, 4096, 128, "fp32", 1, (1, 2, 4, 8, 32)),
    ("rwkv tp4 cm_k", 4096, 3584, 128, "fp32", 1, (1, 2, 4, 8, 32)),
    ("rwkv tp4 cm_v", 3584, 4096, 128, "fp32", 1, (1, 2, 4, 8, 32)),
    ("hymba tp2 wq/wo/in/dt_proj", 1600, 1600, 64, "bf16", 4,
     (1, 2, 4, 8, 20, 32)),
    ("hymba tp2 wk/wv", 1600, 320, 64, "bf16", 2, (1, 2, 4, 8, 20, 32)),
    ("hymba tp2 out_proj (gathered)", 3200, 1600, 128, "bf16", 1,
     (1, 2, 4, 8, 20, 32)),
    ("hymba tp2 w_gate/w_up", 1600, 2752, 64, "bf16", 2,
     (1, 2, 4, 8, 20, 32)),
    ("hymba tp2 w_down (gathered)", 5504, 1600, 128, "bf16", 1,
     (1, 2, 4, 8, 20, 32)),
    ("hymba tp5 wq", 1600, 320, 64, "bf16", 1, (1, 2, 4, 8, 32)),
    ("hymba tp5 wk/wv", 1600, 64, 64, "bf16", 2, (1, 2, 4, 8, 32)),
    ("hymba tp5 wo", 320, 1600, 64, "bf16", 1, (1, 2, 4, 8, 32)),
    ("hymba tp5 in/dt_proj", 1600, 640, 64, "bf16", 2, (1, 2, 4, 8, 32)),
    ("hymba tp5 out_proj", 640, 1600, 128, "bf16", 1, (1, 2, 4, 8, 32)),
    ("hymba tp5 w_gate/w_up (whole)", 1600, 5504, 64, "bf16", 2,
     (1, 2, 4, 8, 32)),
    ("hymba tp5 w_down (whole)", 5504, 1600, 128, "bf16", 1,
     (1, 2, 4, 8, 32)),
    ("whisper tp2 wq/wk/wv, cross wq", 768, 384, 128, "bf16", 4,
     (1, 2, 4, 8, 32, 1500)),
    ("whisper tp2 wo, cross wo", 384, 768, 128, "bf16", 2,
     (1, 2, 4, 8, 32, 1500)),
    ("whisper tp2 w_up", 768, 1536, 128, "bf16", 1, (1, 2, 4, 8, 32, 1500)),
    ("whisper tp2 w_down", 1536, 768, 128, "bf16", 1,
     (1, 2, 4, 8, 32, 1500)),
]
# (arch label, layers a rank's decode step runs, decode rows, the labels'
# prefix)
MESH_FAMILY_STEPS = [("rwkv 1x4 (4 layers)", 4, 4, "rwkv tp4"),
                     ("hymba 1x2 (8 layers)", 8, 4, "hymba tp2"),
                     ("hymba 1x5 (8 layers)", 8, 4, "hymba tp5"),
                     ("whisper 2x2 (12 layers)", 12, 2, "whisper tp2")]
# a rank's paged attention: hymba at 1x5 (5 query over 1 KV head of 64,
# window 1024) and whisper at 2x2 (6 over 6 of 64)
MESH_FAMILY_ATTN = [("hymba tp5", (1, 5, 64), 1024),
                    ("whisper tp2", (6, 1, 64), 0)]
# the flash kernel at a whisper 2x2 rank's heads: the encoder over 1500
# frames (at admit, and in training) and the decoder's 448 tokens
# (training): (label, B, S, Hq, Hkv, D, causal, window)
MESH_FAMILY_FLASH = [
    ("whisper tp2 encoder", 1, 1500, 6, 6, 64, False, 0),
    ("whisper tp2 decoder", 1, 448, 6, 6, 64, True, 0)]


def check_mesh_gemms(torch, dev, gen):
    """The W4A16 kernel against its plain version at every shard-local
    leaf phase 13 runs (llama3-405b at TP=4, danube at TP=2), bf16, M = 1,
    2 and 4 (the engines' plans: 4 slots over 2 data ranks, or one) and 8,
    the planner's split_k and 1; ``held``'s tolerance."""
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    worst = 0.0
    for label, K, N, _ in MESH_GEMMS:
        for M in MESH_M:
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            for s in sorted({planned_split(x, qt), 1}):
                worst = max(worst, held(
                    "w4a16_gemm", f"{label} M={M} K={K} N={N} split_k={s}",
                    w4a16_fused(x, qt, split_k=s),
                    w4a16_fused_plain(x, qt, split_k=s), f32=False))
            del x, qt
    return worst


def check_mesh_attention(torch, dev, gen, cases=MESH_ATTN):
    """Paged attention at a rank's heads (``MESH_ATTN``: llama3-405b at
    TP=4, 32 query over 2 KV heads of 128; danube at TP=2, 16 over 4 of
    80, window 4096; or ``MESH_FAMILY_ATTN``: hymba at TP=5, 5 over 1 of
    64, window 1024; whisper at TP=2, 6 over 6 of 64) on phase 13's
    16-token pages and 9-page tables: decode, chunk and verify at one
    partition and the planner's pick, held as ``check_attention`` holds
    danube's."""
    worst = 0.0
    for label, heads, window in cases:
        for kind in ("decode", "chunk", "verify"):
            c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                          heads=heads, page=MESH_PAGE, pages=MESH_PAGES,
                          ctx=130)
            for parts in sorted({1, c["planned"]}):
                worst = max(worst, hold_partials(
                    torch, c, f"{label} {kind}", "kv_fp16", "bf16", window,
                    parts))
    return worst


def time_mesh(torch, dev, gen, timer, card, floor_ms):
    """Phase 5's rows 1e and 4d: the W4A16 kernel at each shard-local leaf
    at the engines' M = 4 (the planner's split_k beside the kernel's own
    split of K inside a cluster) against its bound, its plain version,
    dequant + ``torch.matmul`` and ``torch.matmul`` on the dense bf16
    weight; each rank's decode-step sum (every layer's GEMMs); paged
    attention at a rank's heads beside gather + SDPA. Each is one rank's
    work alone on the card."""
    from repro_torch.core import costmodel
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm import gemm_geometry, sm_count
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    M = 4
    rows = {}
    for label, K, N, n in MESH_GEMMS:
        x, qt = gemm_case(torch, K, N, M, gen, dev)
        dense = dequantize(qt).to(torch.bfloat16)
        s = planned_split(x, qt)
        geo = gemm_geometry("int4", M, N, K, s, x.dtype, direct=s <= 8,
                            group=qt.group_size, sms=sm_count(dev))
        nbytes = costmodel.w4a16_gemm_bytes(M, N, K)
        flops = costmodel.w4a16_gemm_flops(M, N, K)
        r = dict(ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                 plain_ms=timer(lambda: w4a16_fused_plain(x, qt, split_k=s)),
                 dequant_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                 library_ms=timer(lambda: torch.matmul(x, dense)),
                 bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                 bound_by=costmodel.bound_by(nbytes, flops), nbytes=nbytes,
                 flops=flops, n=n, split_k=s)
        rows[label] = r
        log("timing", f"w4a16_gemm {label} M={M} K={K} N={N} split_k={s} "
            f"(the kernel splits K {geo.ks} ways, {geo.sub} inside a "
            f"cluster of {geo.cluster}): kernel {r['ms']:.4f} ms, "
            f"{gbs(nbytes, r['ms'])}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of roofline; "
            f"the timer's floor {floor_ms:.4f}), plain {r['plain_ms']:.4f} "
            f"ms, dequant+matmul {r['dequant_ms']:.4f} ms, torch.matmul "
            f"bf16 {r['library_ms']:.4f} ms [{card}]")
        del x, qt, dense
    for arch, L in (("llama", 2), ("danube", 24)):
        def total(key):
            return L * sum(r[key] * r["n"] for lbl, r in rows.items()
                           if lbl.startswith(arch))
        log("timing", f"w4a16_gemm, one {arch} rank's decode step ({L} "
            f"layers' GEMMs at M={M}, {7 * L} launches): kernel "
            f"{total('ms'):.3f} ms, bound {total('bound_ms'):.3f} ms, plain "
            f"{total('plain_ms'):.3f} ms, torch.matmul bf16 "
            f"{total('library_ms'):.3f} ms [{card}]")
    for label, heads, window in MESH_ATTN:
        for kind in ("decode", "chunk"):
            c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                          heads=heads, page=MESH_PAGE, pages=MESH_PAGES,
                          ctx=130)
            rows[(label, kind)] = time_attn_case(
                torch, timer, c, window, f"{label} {kind}", card)
    return rows


def check_mesh_family_gemms(torch, dev, gen):
    """The W4A16 kernel against its plain version at every rank-local leaf
    of phase 13's carry-family and whisper runs (``MESH_FAMILY_GEMMS``:
    rwkv at TP=4 with fp32 activations, hymba at TP=2 and 5 and whisper at
    TP=2 in bf16), at each M those runs give it, with the planner's
    split_k at that M, the engine's plan (made at the decode step's rows,
    or the verify step's) and 1; ``held``'s tolerances. Returns the worst
    bf16 |d|."""
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    worst = 0.0
    for label, K, N, group, dt, _, Ms in MESH_FAMILY_GEMMS:
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        plans = set()
        for M in Ms:
            x, qt = carry_gemm_case(torch, K, N, group, M, gen, dev, dtype)
            if M in (2 if label.startswith("whisper") else 4, 20):
                plans.add(planned_split(x, qt))
            for s in sorted(plans | {planned_split(x, qt), 1}):
                err = held("w4a16_gemm", f"{label} {dt} M={M} K={K} N={N} "
                           f"group={group} split_k={s}",
                           w4a16_fused(x, qt, split_k=s),
                           w4a16_fused_plain(x, qt, split_k=s),
                           f32=dt == "fp32")
                if dt == "bf16":
                    worst = max(worst, err)
            del x, qt
    return worst


def time_mesh_families(torch, dev, gen, timer, card, floor_ms):
    """Phase 5's rows 1f, 4e and 7e, each one rank's work alone on the
    card: the W4A16 kernel at every rank-local leaf of phase 13's
    carry-family and whisper runs at the rank's decode rows (rwkv in
    fp32; whisper's admit leaves also at its 1500 frames), the planner's
    split_k, beside its bound, the timer's floor, its plain version,
    dequant + ``torch.matmul`` and ``torch.matmul`` on the dense weight in
    the activation dtype; each run's decode-step sum; paged attention at
    hymba 1x5's and whisper 2x2's heads beside gather + SDPA; the flash
    forward at a whisper 2x2 rank's encoder and decoder heads beside
    SDPA."""
    from repro_torch.core import costmodel
    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    rows = {}
    for label, K, N, group, dt, n, Ms in MESH_FAMILY_GEMMS:
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        step_m = 2 if label.startswith("whisper") else 4
        for M in [step_m] + [m for m in Ms if m == ENCODER_M]:
            x, qt = carry_gemm_case(torch, K, N, group, M, gen, dev, dtype)
            dense = dequantize(qt).to(dtype)
            s = planned_split(x, qt)
            size = 4 if dt == "fp32" else 2
            nbytes = costmodel.w4a16_gemm_bytes(M, N, K, group=group,
                                                act_bytes=size,
                                                out_bytes=size)
            flops = costmodel.w4a16_gemm_flops(M, N, K)
            r = dict(ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                     plain_ms=timer(lambda: w4a16_fused_plain(
                         x, qt, split_k=s)),
                     dequant_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                     library_ms=timer(lambda: torch.matmul(x, dense)),
                     bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                     bound_by=costmodel.bound_by(nbytes, flops),
                     nbytes=nbytes, n=n, split_k=s)
            rows[(label, M)] = r
            log("timing", f"w4a16_gemm {label} {dt} M={M} K={K} N={N} "
                f"group={group} split_k={s}: kernel {r['ms']:.4f} ms, "
                f"{gbs(nbytes, r['ms'])}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of "
                f"roofline; the timer's floor {floor_ms:.4f}), plain "
                f"{r['plain_ms']:.4f} ms, dequant+matmul "
                f"{r['dequant_ms']:.4f} ms, torch.matmul {dt} "
                f"{r['library_ms']:.4f} ms [{card}]")
            del x, qt, dense
    for what, L, M, prefix in MESH_FAMILY_STEPS:
        def total(key):
            return L * sum(r[key] * r["n"] for (lbl, m), r in rows.items()
                           if lbl.startswith(prefix) and m == M)
        n = L * sum(r["n"] for (lbl, m), r in rows.items()
                    if lbl.startswith(prefix) and m == M)
        log("timing", f"w4a16_gemm, one {what} rank's decode step ({n} "
            f"launches at M={M}): kernel {total('ms'):.3f} ms, bound "
            f"{total('bound_ms'):.3f} ms, plain {total('plain_ms'):.3f} ms, "
            f"dequant+matmul {total('dequant_ms'):.3f} ms, torch.matmul "
            f"{total('library_ms'):.3f} ms [{card}]")
    for label, heads, window in MESH_FAMILY_ATTN:
        for kind in ("decode", "chunk"):
            c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind,
                          heads=heads, page=MESH_PAGE, pages=MESH_PAGES,
                          ctx=130)
            rows[(label, kind)] = time_attn_case(
                torch, timer, c, window, f"{label} {kind}", card)
    for label, B, S, Hq, Hkv, D, causal, window in MESH_FAMILY_FLASH:
        q, k, v = flash_inputs(torch, gen, dev, B, S, S, Hq, Hkv, D,
                               torch.bfloat16)
        rows[label] = time_flash_shape(torch, timer, q, k, v, label, causal,
                                       window, card, "timing")
        del q, k, v
    return rows


def mesh_cfg(arch, layers, what=""):
    """The full config at ``layers`` layers (None: all), the activations
    fp32 for ``what == "fp32"``, whisper's encoder and a ring run's
    whole-prompt prefill on the flash kernel (as the serve launcher sets
    them on a card)."""
    import torch
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if what == "fp32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if cfg.family == "encdec" or what == "ring":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    return cfg


def mesh_weights(torch, dev, cfg, cut=None):
    """Seed 0's weights of ``cfg`` drawn on the card in bf16 (each leaf
    cut as drawn with ``cut``) and quantized there; for fp32 activations
    the quantized leaves then dequantize to fp32 (``fp32_params``)."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = T.quantize_params(T.init_params(gen, bf16, device=dev, cut=cut),
                               bf16, min_size=0)
    return fp32_params(torch, params) if cfg.dtype == torch.float32 \
        else params


def weight_bytes(tree):
    """Bytes a param tree holds (a QuantizedTensor's payload, scales and
    zeros)."""
    from repro_torch.core.quant import QuantizedTensor
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return sum(t.numel() * t.element_size()
                   for t in (tree.packed, tree.scales, tree.zeros)
                   if t is not None)
    return 0 if isinstance(tree, str) else tree.numel() * tree.element_size()


def mesh_requests(cfg, what=""):
    """Phase 13's requests: MESH_REQS random prompts of MESH_PROMPT tokens
    (with whisper's audio frames, each request its own), or for an ngram
    run prompts of a 16-token sequence repeated (prompt lookup has
    matches), each MESH_GEN tokens."""
    from repro_torch.launch import serve as launcher
    if what == "ngram":
        return repeat_prompts(cfg.vocab_size, n=MESH_REQS, plen=MESH_PROMPT,
                              gen=MESH_GEN)
    return launcher.make_requests(cfg, MESH_REQS, MESH_PROMPT, MESH_GEN, 0)


def mesh_serve_run(torch, dev, cfg, params, table, mesh=None, what=""):
    """Serve phase 13's requests through ``ServingEngine`` (on ``mesh``
    when given; ``params`` a tree, or a one-tree list that is emptied so
    that the engine holds the only reference: an ``fsdp`` run's slice is
    then freed once its shares are cut), counters set to 0 just before
    and read just after; the peak before the requests (the build) and
    while they are served (the engine's weights, pool and steps) apart. An
    ngram run wraps every verify step (``capture_carry_verify``): exact
    acceptance, each carry commit equal to checkpoint 1 + accepted, the
    verify logits at each row's first position against a decode step
    replayed from the same carry. A ring run (phase 16) serves on the
    ring engine (``paged=False``; its prompts prefill whole) and keeps the
    first decode step's logits. Returns a summary: tokens, first-token
    logits, launches, forwards, admits and times."""
    from repro_torch.runtime.engine import ServingEngine
    kw = dict(MESH_KW)
    if what == "ngram":
        kw.update(speculate="ngram", spec_k=SPEC_K)
    if what == "ring":
        kw = dict(RING_MESH_KW)
    if isinstance(params, list):
        params = params.pop()
    engine = ServingEngine(cfg, params, mesh=mesh, device=dev,
                           fsdp_serve=what == "fsdp", **kw)
    del params
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step0 = first_step_logits(engine) if what == "ring" else {}
    reqs = mesh_requests(cfg, what)
    if what == "ngram":
        kernels = ("w4a16_gemm",) + (() if cfg.attn_free
                                     else ("paged_attention",))
        records, quiet, stats = capture_carry_verify(torch, engine, table,
                                                     kernels)
    if mesh is not None:
        torch.distributed.barrier()
    reset_counts(table)
    t0 = time.perf_counter()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(table)
    chunks = sum(-(-len(r.prompt) // engine.prefill_chunk) for r in reqs) \
        - rep.prefill_steps_saved if engine.chunked else 0
    replays = 0
    if what == "ngram":
        # each verify step also ran a decode step replayed from its carry
        replays = len(records)
        check_acceptance(records, rep.results, len(reqs[0].prompt),
                         f"{cfg.name} ngram", phase="mesh")
        ok = not quiet and records and not stats["bad"] \
            and stats["commits"] == len(records) \
            and stats["replay_max"] <= LOGIT_TOL
        log("mesh", f"{cfg.name} ngram k={SPEC_K}: {rep.accepted_tokens}/"
            f"{rep.proposed_tokens} drafts accepted over {len(records)} "
            f"verify steps; {stats['commits']} carry commits, each row's "
            f"carry checkpoint 1 + accepted (rows per checkpoint "
            f"{dict(sorted(stats['sel'].items()))}), mismatches "
            f"{stats['bad'][:4]}; verify vs replayed decode logits max|d|="
            f"{stats['replay_max']:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{cfg.name} ngram on a mesh: verify "
                                 f"carries or logits disagree")
    out = dict(tokens=dict(rep.results), launches=counts,
               forwards=chunks + len(rep.step_records) + replays,
               admits=rep.admitted,
               logits={r: rep.prefill_logits[r].float().cpu()
                       for r in rep.results},
               wall=wall, decode_s=rep.decode_s,
               steps=len(rep.step_records), prefill_s=rep.prefill_s,
               heads=(engine.cfg.num_heads, engine.cfg.num_kv_heads),
               d_inner=engine.cfg.d_inner if cfg.family == "hybrid" else 0,
               plans={k: p.split_k for k, p in engine.plans.items()},
               paths=(engine.attn_path, engine.prefill_attn_path),
               spec=(rep.proposed_tokens, rep.accepted_tokens),
               step0=step0, build_peak=build_peak,
               serve_peak=torch.cuda.max_memory_allocated())
    del engine
    return out


def mesh_rank(rank, world, store, runs_json, out_dir):
    """One rank of phase 13 (``chip_smoke.py --mesh-rank``): joins the gloo
    group through ``store``, then for each run builds its mesh, draws the
    weights with the rank's cut (one rank after the other where the run
    asks: llama's leaves are GBs), quantizes its slice on the card and
    serves. Writes ``rank{r}.pkl``."""
    import pickle

    import torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = tmesh.rank_device()
    backend = tmesh.init_process_group(
        dev, init_method=f"file://{store}", rank=rank, world_size=world)
    table = kernel_table()
    results = []
    for arch, layers, dm, serial, what in json.loads(runs_json):
        cfg = mesh_cfg(arch, layers, what)
        mesh = tmesh.make_local_mesh(*dm)
        layout = sharding.Layout(cfg, mesh)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for turn in range(world if serial else 1):
            if not serial or turn == rank:
                params = mesh_weights(torch, dev, cfg, layout.cut)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            torch.distributed.barrier()
        build_s = time.perf_counter() - t0
        box = [params]
        del params
        res = mesh_serve_run(torch, dev, cfg, box, table, mesh, what)
        res.update(arch=arch, mesh=dm, what=what, backend=backend,
                   build_s=build_s, coords=(layout.dp_rank, layout.tp_rank),
                   peak_gib=max(res["build_peak"], res["serve_peak"])
                   / 2 ** 30)
        results.append(res)
        torch.cuda.empty_cache()
        torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


# every process this script starts and has not reaped yet; the script's
# exit kills what is left (a phase that fails leaves none running)
STARTED = []


def reap_started():
    """Kill and reap every process of ``STARTED`` still running."""
    for p in STARTED:
        if p.poll() is None:
            p.kill()
            p.wait()
    STARTED.clear()


def start_mesh(runs, world, timeout=420, flag="--mesh-rank",
               phase="mesh"):
    """Start ``runs`` (one world size) on ``world`` rank processes of this
    script sharing the card (``chip_smoke.py flag r world store runs
    out_dir``) and return at once; ``finish_mesh`` waits for them."""
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    logs = [open(os.path.join(d, f"rank{r}.log"), "w+")
            for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag,
         str(r), str(world), os.path.join(d, "store"),
         json.dumps(runs), d], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env) for r in range(world)]
    STARTED.extend(procs)
    return dict(dir=d, logs=logs, procs=procs, world=world, phase=phase,
                deadline=time.monotonic() + timeout)


def finish_mesh(job):
    """Wait for ``start_mesh``'s ranks; returns each rank's results. A
    rank that fails or hangs (past the timeout counted from the start)
    fails the phase."""
    import pickle
    import shutil
    d, logs, procs, phase = job["dir"], job["logs"], job["procs"], \
        job["phase"]
    try:
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > job["deadline"] or any(
                        p.returncode not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            for r, text in enumerate(texts):
                log(phase, f"rank {r} exited {codes[r]}:\n{text[-4000:]}")
            raise AssertionError(f"{phase}: ranks exited {codes}")
        for text in texts[:1]:
            for line in text.strip().splitlines():
                log(phase, f"rank 0: {line}")
        out = []
        for r in range(job["world"]):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def spawn_mesh(runs, world, timeout=420, flag="--mesh-rank",
               phase="mesh"):
    """``start_mesh`` and ``finish_mesh`` in one: the ranks' results."""
    return finish_mesh(start_mesh(runs, world, timeout, flag, phase))


def mesh_want(res):
    """One forward's and one admit's launches times the run's: W4A16 and
    paged attention a layer (``MESH_LAYER_LAUNCHES``) a forward (a prefill
    chunk, a decode or verify step, a replayed decode step); at each
    admit, whisper's encoder (6 W4A16 and 1 flash a layer) and every
    decoder layer's cross K/V (2 W4A16)."""
    gemm, attn = MESH_LAYER_LAUNCHES.get(res["family"], (7, 1))
    L, E, f, a = res["L"], res["E"], res["forwards"], res["admits"]
    admit = E * ENC_LAYER_GEMMS + L * CROSS_KV_GEMMS if E else 0
    return {"w4a16_gemm": gemm * L * f + admit * a,
            "paged_attention": attn * L * f, "flash_attention": E * a}


def hold_mesh(ref, ranks, what, card):
    """Every rank's first-token logits within LOGIT_TOL of the
    single-process port's on the same weights; every rank's launches of
    W4A16, paged attention and flash exactly the one process's and
    ``mesh_want``'s (each call went to its kernel) and no other kernel;
    the ranks in lockstep (the same tokens); the first greedy token that
    differs from the single process, if any, printed."""
    kinds = ("w4a16_gemm", "paged_attention", "flash_attention")
    for res in ranks:
        d = max(float((res["logits"][r] - ref["logits"][r]).abs().max())
                for r in ref["logits"])
        n = res["launches"]
        want = mesh_want(res)
        got = {k: n[k] for k in kinds}
        one = {k: ref["launches"][k] for k in kinds}
        others = {k: v for k, v in n.items() if v and k not in kinds}
        first = next(((r, i, a, b) for r in sorted(ref["tokens"])
                      for i, (a, b) in enumerate(zip(res["tokens"][r],
                                                     ref["tokens"][r]))
                      if a != b), None)
        ok = d <= LOGIT_TOL and got == want == one and not others \
            and res["tokens"] == ranks[0]["tokens"]
        heads = f"{res['heads'][0]}/{res['heads'][1]}" + (
            f", SSM channels {res['d_inner']}" if res["d_inner"] else "")
        log("mesh", f"{what} rank {res['coords']} ({res['backend']}): "
            f"heads {heads}, first-token logits vs one process max|d|="
            f"{d:.3e} (tolerance {LOGIT_TOL}), launches "
            + ", ".join(f"{k} {got[k]}" for k in kinds)
            + f" (want {', '.join(str(want[k]) for k in kinds)}: "
            f"{res['forwards']} forwards, {res['admits']} admits; one "
            f"process {', '.join(str(one[k]) for k in kinds)}; others "
            f"{others or 'none'}), first differing greedy token "
            f"{'none' if first is None else f'request {first[0]} token {first[1]}: {first[2]} vs {first[3]}'}"
            f"; build {res['build_s']:.1f} s, serve {res['wall']:.2f} s, "
            f"decode {res['decode_s'] / max(res['steps'], 1) * 1e3:.1f} "
            f"ms/step over {res['steps']} steps (one process "
            f"{ref['decode_s'] / max(ref['steps'], 1) * 1e3:.1f}), peak "
            f"{res['peak_gib']:.2f} GiB {'ok' if ok else 'FAIL'} [ranks "
            f"share one card: {card}]")
        if not ok:
            raise AssertionError(f"phase 13 {what}: rank {res['coords']} "
                                 f"disagrees with the single process")
    log("mesh", f"{what}: plans (KxN: split_k) {ranks[0]['plans']}, "
        f"attention paths {ranks[0]['paths']}")


def hold_fsdp_serve(ranks, plain, what, card):
    """Phase 13's fsdp_serve run against the same mesh without the flag:
    every rank's greedy tokens equal, its W4A16 and paged-attention
    launches equal (a gathered layer runs the kernels of the slice); each
    rank's peaks printed beside the plain run's: the build's (its slice
    and the shares cut from it) and the serving's (the shares, the pool,
    one gathered layer)."""
    kinds = ("w4a16_gemm", "paged_attention")
    for a, b in zip(ranks, plain):
        ok = a["coords"] == b["coords"] and a["tokens"] == b["tokens"] \
            and all(a["launches"][k] == b["launches"][k] for k in kinds)
        log("mesh", f"{what} fsdp_serve rank {a['coords']}: greedy tokens "
            f"{'equal' if a['tokens'] == b['tokens'] else 'DIFFER'} to the "
            f"same mesh without the flag; launches "
            + ", ".join(f"{k} {a['launches'][k]} (without "
                        f"{b['launches'][k]})" for k in kinds)
            + f"; serving peak {a['serve_peak'] / 2**30:.3f} GiB (without "
            f"{b['serve_peak'] / 2**30:.3f}), build peak "
            f"{a['build_peak'] / 2**30:.3f} GiB (without "
            f"{b['build_peak'] / 2**30:.3f}); decode "
            f"{a['decode_s'] / max(a['steps'], 1) * 1e3:.1f} ms/step "
            f"(without {b['decode_s'] / max(b['steps'], 1) * 1e3:.1f}) "
            f"{'ok' if ok else 'FAIL'} [ranks share one card: {card}]")
        if not ok:
            raise AssertionError(f"phase 13 {what} fsdp_serve: rank "
                                 f"{a['coords']} disagrees with the same "
                                 f"mesh without the flag")


def mesh_serve(torch, dev, card, table):
    """Phase 13: every run of MESH_RUNS served by one process at the same
    cut (the reference: the port on one card), then by its mesh's ranks,
    spawned on the one card over gloo (one spawn per world size), and held
    against it (``hold_mesh``)."""
    refs = {}
    for arch, layers, _, _, what in MESH_RUNS:
        if what == "fsdp":      # one process holds no shares
            continue
        cfg = mesh_cfg(arch, layers, what)
        full = mesh_cfg(arch, None)
        t0 = time.perf_counter()
        params = mesh_weights(torch, dev, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        nbytes = weight_bytes(params)
        ref = mesh_serve_run(torch, dev, cfg, params, table, what=what)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        refs[arch, layers, what] = ref
        log("mesh", f"{arch}{' ' + what if what else ''} ({cfg.num_layers} "
            f"of {full.num_layers} layers, {nbytes / 2**30:.2f} GiB of "
            f"weights held; d_model {cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}, {str(cfg.dtype).split('.')[-1]}) in "
            f"one process: built {build_s:.1f} s, served {MESH_REQS} x "
            f"{MESH_PROMPT} + {MESH_GEN} in {ref['wall']:.2f} s, decode "
            f"{ref['decode_s'] / max(ref['steps'], 1) * 1e3:.1f} ms/step "
            f"[{card}]")
    by_world = {}
    for arch, layers, meshes, serial, what in MESH_RUNS:
        for dm in meshes:
            by_world.setdefault(dm[0] * dm[1], []).append(
                (arch, layers, dm, serial, what))
    # phase 16(b)'s ring runs ride the spawn of their world size; phase 16
    # holds them (RING_RANKS)
    for arch, layers, dm, serial, what in RING_MESH:
        by_world.setdefault(dm[0] * dm[1], []).append(
            (arch, layers, dm, serial, what))
    for world, runs in sorted(by_world.items()):
        t0 = time.perf_counter()
        out = spawn_mesh(runs, world)
        log("mesh", f"{world} ranks on one card: {len(runs)} runs in "
            f"{time.perf_counter() - t0:.1f} s")
        for i, (arch, layers, dm, _, what) in enumerate(runs):
            ranks = [res[i] for res in out]
            if what == "ring":
                RING_RANKS[:] = ranks
                continue
            cfg = mesh_cfg(arch, layers, what)
            for res in ranks:
                res.update(L=cfg.num_layers, family=cfg.family,
                           E=cfg.encoder_layers)
            ref = refs[arch, layers, "" if what == "fsdp" else what]
            ref.update(L=cfg.num_layers, family=cfg.family,
                       E=cfg.encoder_layers)
            hold_mesh(ref, ranks, f"{arch}{' ' + what if what else ''} "
                      f"({layers} layers) at {dm[0]}x{dm[1]}", card)
            if what == "fsdp":
                plain = next(j for j, r in enumerate(runs)
                             if r[:2] == (arch, layers)
                             and tuple(r[2]) == tuple(dm) and r[4] == "")
                hold_fsdp_serve(ranks, [res[plain] for res in out],
                                f"{arch} ({layers} layers) at "
                                f"{dm[0]}x{dm[1]}", card)


# ---------------------------------------------------------------------------
# phase 14: training on a (data, model) mesh of ranks sharing the one card
# ---------------------------------------------------------------------------

# the runs: (arch, decoder layers kept (None: all), rows, tokens a row,
# meshes), each under the arch's preset (launch.presets.settings_for),
# FAMILY_STEPS steps on every mesh against one process. h2o-danube-1.8b
# at full width, its first MESH_TRAIN_LAYERS of 24 layers (a one-process
# reference and four ranks share the card; 1 layer since the elastic run's
# four checkpoints, gathered to rank 0 through host memory, were most of
# the phase at 4), 8 x 1024 tokens (4 microbatches, FSDP, ZeRO-2) at 1x4
# (and at 2x2: the elastic run, MESH_ELASTIC);
# whisper-small at full width, its first MESH_TRAIN_WHISPER_LAYERS decoder
# and encoder layers, 4 x 448 tokens over 1500 frames
# a row (4 microbatches of one row: every data rank runs every row; FSDP,
# ZeRO-2) at 2x2
MESH_TRAIN_LAYERS = 1
# whisper-small's decoder and encoder layers kept (2 of 12 each; cut too,
# for the script's time)
MESH_TRAIN_WHISPER_LAYERS = 2
MESH_TRAIN_RUNS = [
    ("h2o-danube-1.8b", MESH_TRAIN_LAYERS, 8, 1024, [(1, 4)]),
    ("whisper-small", MESH_TRAIN_WHISPER_LAYERS, 4, 448, [(2, 2)])]
# the elastic run, last (two of its ranks leave): danube as above at 2x2
# through ``run_training`` with a checkpoint after every step; its steps 0
# and 1 are the 2x2 mesh held against the one process as every mesh is;
# every try of step ELASTIC_FAIL fails, and ``remesh_fn`` drops the last
# data row (``launch.mesh.degraded_mesh``): ranks 2 and 3 leave, 0 and 1
# join a fresh group of two, restore the step-1 checkpoint onto their
# (1, 2) shares and train steps 2 and 3 on the first 4 rows (a data
# rank's 4 rows, as before), held against one process restoring the same
# checkpoint and running the same batches
MESH_ELASTIC = ("h2o-danube-1.8b", MESH_TRAIN_LAYERS, 8, 1024, (2, 2))
ELASTIC_STEPS, ELASTIC_FAIL = 4, 2
# the weight-gathered layers of ZeRO-3 (danube's preset with zero2 off and
# ZERO3_MICRO microbatch, for the script's time: each microbatch gathers
# every layer twice through host memory; with one, the forward and
# backward set the step's peak, not the AdamW update; the accumulation
# over microbatches on the shares is held on the CPU,
# tests/test_torch_train_mesh*.py): (arch,
# layers, rows, tokens a row, mesh); ZERO3_STEPS steps against one
# process, each layer gathered over "data" just before it runs and again
# in its recompute; then ZERO2_STEPS of the same cell under ZeRO-2 (the
# whole slice gathered once a step) for its peak beside
MESH_ZERO3 = ("h2o-danube-1.8b", 4, 8, 1024, (2, 2))
ZERO3_MICRO, ZERO3_STEPS, ZERO2_STEPS = 1, 3, 1


def zero3_settings(zero2: bool = False):
    """Phase 14's ZeRO-3 cell's settings (``zero2``: the same cell under
    ZeRO-2)."""
    from repro_torch.launch.presets import settings_for
    return dataclasses.replace(settings_for(MESH_ZERO3[0]), zero2=zero2,
                               microbatches=ZERO3_MICRO)
# phase 15's measured peaks: cell -> (the phase's peak device bytes less
# what was allocated before the cell's own tensors, the cell's geometry)
PEAKS = {}
MESH_TRAIN_PEAK = f"danube-{MESH_TRAIN_LAYERS}L-train-mesh-1x4 rank (0, 0)"
ZERO3_PEAK = f"danube-{MESH_ZERO3[1]}L-train-mesh-2x2 ZeRO-3 rank (0, 0)"
ZERO2_PEAK = f"danube-{MESH_ZERO3[1]}L-train-mesh-2x2 ZeRO-2 rank (0, 0)"
# the flash kernel's shapes there (a rank's rows of a microbatch, its
# heads): (label, B, S, Hq, Hkv, D, causal, window); whisper's are
# MESH_FAMILY_FLASH
MESH_TRAIN_FLASH = [("danube tp4 (1x4)", 2, 1024, 8, 2, 80, True, 4096),
                    ("danube tp2 (2x2)", 1, 1024, 16, 4, 80, True, 4096)]


def mesh_train_cfg(arch, layers):
    """The full config at ``layers`` decoder layers (and as many encoder
    layers at most), on the flash kernel."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=min(layers, cfg.num_layers),
            encoder_layers=min(layers, cfg.encoder_layers))
    return dataclasses.replace(cfg, attn_impl="flash")


class SpecMesh:
    """A spec-level (data, model) stand-in at rank (0, 0): what a rank
    holds (``runtime.sharding.TrainShards``), without ranks."""

    def __init__(self, dm):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.axis_names = ("data", "model")
        self.coords = {}


def reckon_mesh_train(cfg, settings, card, B, S, meshes):
    """Before the phase runs: its depth cut and ``train_bytes``, and per
    mesh what rank (0, 0) holds (its shares at the functional AdamW's 22
    B a parameter; ZeRO-2's gathered slice and a microbatch's gradients
    of it in bf16) and the bytes a step sends through host memory (each
    staged collective copies to the host and back): over "data" the
    gradients' reduce-scatter and the gather of the shares; over "model"
    a microbatch's 9 activation collectives a layer (2 row-parallel sums,
    again in the recompute, 5 column inputs' gradient sums), the
    embedding's sum and the fp32 logits' gather (whisper's encoder
    layers counted as decoder layers over their frames)."""
    import math

    from repro_torch import configs
    from repro_torch.launch.train import TRAIN_BYTES_PER_PARAM, train_bytes
    from repro_torch.runtime.sharding import TrainShards
    full = configs.get_config(cfg.name)
    log("mesh-train", f"{cfg.name}: depth cut to {cfg.num_layers} of "
        f"{full.num_layers} layers"
        + (f" (encoder {cfg.encoder_layers} of {full.encoder_layers})"
           if full.encoder_layers else "")
        + f", full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.sliding_window}, "
        f"{str(cfg.dtype).split('.')[-1]}, remat {cfg.remat}): "
        f"{cfg.param_count() / 1e9:.3f} B params, "
        f"train_bytes {train_bytes(cfg) / 2**30:.2f} GiB (the one-process "
        f"reference; all {full.num_layers} layers "
        f"{train_bytes(full) / 2**30:.2f} GiB); {B} x {S} tokens a step"
        + (f" over {cfg.encoder_seq} frames a row" if cfg.encoder_layers
           else "") + f", {settings}")
    n = settings.microbatches
    for dm in meshes:
        sh = TrainShards(cfg, SpecMesh(dm), fsdp=settings.fsdp)
        dp, tp = dm
        slice_n = share_n = 0
        for s in sh.leaves.values():
            k = math.prod(s.shape) // (s.tp[1] if s.tp else 1)
            slice_n += k
            share_n += k // dp if s.fsdp is not None and dp > 1 else k
        rows = B // n // dp or B // n
        act = rows * S * cfg.d_model * 2
        enc = rows * cfg.encoder_seq * cfg.d_model * 2
        model_b = 0 if tp == 1 else n * (
            9 * cfg.num_layers * act + 9 * cfg.encoder_layers * enc
            + 2 * act + rows * S * cfg.padded_vocab * 4)
        data_b = 0 if dp == 1 else \
            n * slice_n * 2 + (slice_n - share_n) * 2
        state = share_n * TRAIN_BYTES_PER_PARAM
        zero2 = slice_n * 2 if settings.zero2 and dp > 1 else 0
        log("mesh-train", f"reckoned at {dp}x{tp}: a rank's shares "
            f"{share_n / 1e6:.1f} M elements of its {slice_n / 1e6:.1f} M "
            f"slice, {state / 2**30:.2f} GiB of training state, ZeRO-2 "
            f"copy {zero2 / 2**30:.2f} GiB, a microbatch's slice "
            f"gradients {slice_n * 2 / 2**30:.2f} GiB; through host memory "
            f"a step: {data_b / 2**30:.2f} GiB over data, "
            f"{model_b / 2**30:.2f} GiB over model (x2 for the copies in "
            f"and out) [{card}]")


# rank 0's one-process m and v (host) by (arch, layers), for the elastic run
REF_MV = {}


def _nest(path, t):
    """A tree holding the one leaf ``t`` at key path ``path``."""
    for k in reversed(path):
        t = {k: t}
    return t


def mesh_train_rank(rank, world, store, runs_json, out_dir):
    """One rank of phase 14 (``chip_smoke.py --mesh-train-rank``): joins
    the gloo group through ``store``. For each run rank 0 first runs the
    reference, one process training the whole tree (``make_train_step``
    with the same settings, no mesh) while the others wait, and keeps its
    m and v on the host. Then for each mesh every rank draws the whole
    tree of seed 0, cuts its shares and trains ``FAMILY_STEPS`` steps on
    the same batches (whisper's audio frames drawn from one seed on every
    rank), counters set to 0 just before and read just after; m and v are
    gathered to rank 0 leaf by leaf, and it holds each against the
    reference. Writes ``rank{r}.pkl``."""
    import pickle

    import torch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every collective's host wall time (its wait for the card included),
    # and the all-gathers over "data"
    spent = {"s": 0.0, "n": 0, "gathers": 0}
    collective = sharding.Layout._collective

    def timed_collective(self, t, axis, fn, kind, **kw):
        t0 = time.perf_counter()
        try:
            return collective(self, t, axis, fn, kind, **kw)
        finally:
            spent["s"] += time.perf_counter() - t0
            spent["n"] += 1
            spent["gathers"] += kind == "all-gather" and axis == "data"
    sharding.Layout._collective = timed_collective
    dev = tmesh.rank_device()
    backend = tmesh.init_process_group(
        dev, init_method=f"file://{store}", rank=rank, world_size=world)
    table = kernel_table()
    opt_cfg = AdamWConfig(lr=1e-3)
    out = {"backend": backend, "runs": []}
    for arch, layers, B, S, meshes in json.loads(runs_json):
        out["runs"].append(mesh_train_arch(
            torch, rank, dev, table, opt_cfg, spent,
            mesh_train_cfg(arch, layers), B, S, meshes))
    arch, layers, B, S, dm = MESH_ZERO3
    out["zero3"] = mesh_train_arch(
        torch, rank, dev, table, opt_cfg, spent, mesh_train_cfg(arch, layers),
        B, S, [dm], settings=zero3_settings(), n_steps=ZERO3_STEPS)
    out["zero2"] = mesh_train_arch(
        torch, rank, dev, table, opt_cfg, spent, mesh_train_cfg(arch, layers),
        B, S, [dm], settings=zero3_settings(zero2=True), n_steps=ZERO2_STEPS,
        reference=False)
    out["elastic"] = mesh_elastic(torch, rank, dev, table, opt_cfg, spent,
                                  store, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if torch.distributed.is_initialized():     # a rank that left has none
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


def mesh_elastic(torch, rank, dev, table, opt_cfg, spent, store, out_dir):
    """``mesh_train_rank``'s elastic run (``MESH_ELASTIC``): every rank
    runs ``run_training`` at 2x2, a checkpoint after each step under
    ``out_dir``; the step's every try at ``ELASTIC_FAIL`` fails, and
    ``remesh_fn`` drops the last data row (a new store beside ``store``).
    A rank that leaves returns its steps so far. The survivors' m and v
    are gathered to rank 0, which then holds the run: m and v of the
    step-1 checkpoint against the one-process reference (``REF_MV``), and
    steps 2 and 3 against one process restoring that checkpoint and
    training the same rows. Each step's ms, its collectives' host wall
    and its launches are recorded."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.tree import tree_flatten_with_keys, tree_map
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.presets import settings_for
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import resilient, steps
    from repro_torch.runtime.resilient import RunnerConfig, run_training

    arch, layers, B, S, dm = MESH_ELASTIC
    # the runner's checkpoint saves and restores, timed (host wall)
    io = []
    real_io = resilient.save_checkpoint, resilient.restore_checkpoint

    def timed_io(fn, what):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                io.append((what, time.perf_counter() - t0))
        return call
    resilient.save_checkpoint = timed_io(real_io[0], "save")
    resilient.restore_checkpoint = timed_io(real_io[1], "restore")
    cfg = mesh_train_cfg(arch, layers)
    settings = settings_for(arch)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, device=dev)
    pool = [stream.batch_at(i) for i in range(ELASTIC_STEPS)]
    rows = B // dm[0]                   # a data rank's rows, kept
    now = {"mesh": tmesh.make_local_mesh(*dm)}
    first = now["mesh"]
    record = []                         # one entry a step

    def build():
        fn = steps.make_train_step(cfg, opt_cfg, settings, mesh=now["mesh"])

        def timed(params, state, inputs):
            torch.cuda.synchronize()
            reset_counts(table)
            spent.update(s=0.0, n=0)
            t0 = time.perf_counter()
            out = fn(params, state, inputs)
            torch.cuda.synchronize()
            record.append(dict(
                step=inputs["step"], mesh=tuple(now["mesh"].shape),
                ms=(time.perf_counter() - t0) * 1e3, coll_s=spent["s"],
                coll_n=spent["n"],
                flash=read_counts(table)["flash_attention"]))
            return out
        timed.shards = fn.shards
        now["step"] = timed
        return timed

    def batches(i):
        n = rows * now["mesh"].size(0)
        return {"batch": {k: v[:n] for k, v in pool[i].items()}, "step": i}

    def remesh_fn():
        now["mesh"] = tmesh.degraded_mesh(
            now["mesh"], drop_data=1, init_method=f"file://{store}.elastic")
        return build()

    step_fn = build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = step_fn.shards.cut(T.init_params(gen, cfg, device=dev))
    torch.cuda.empty_cache()
    ckpt = os.path.join(out_dir, "elastic_ckpt")
    metrics = []
    t0 = time.perf_counter()
    try:
        params, state, history = run_training(
            cfg=RunnerConfig(ckpt_dir=ckpt, ckpt_every=1,
                             keep_last=ELASTIC_STEPS),
            train_step=step_fn, params=params,
            opt_state=adamw_init(params, opt_cfg), batches=batches,
            num_steps=ELASTIC_STEPS,
            inject_failure=lambda s, r: s == ELASTIC_FAIL
            and now["mesh"] is first,
            remesh_fn=remesh_fn, shards=step_fn.shards,
            on_metrics=lambda i, m: metrics.append(
                (i, m["loss"], m["grad_norm"])))
    except tmesh.LeftMesh:
        return {"left": True, "record": record, "metrics": metrics}
    finally:
        resilient.save_checkpoint, resilient.restore_checkpoint = real_io
    run_s = time.perf_counter() - t0
    shards = now["step"].shards
    got = {}
    for key in ("m", "v"):
        for path, t in tree_flatten_with_keys(state[key]):
            w = shards.whole(_nest(path, t))     # None but on rank 0
            if w is not None:
                for k in path:
                    w = w[k]
                got[(key,) + tuple(path)] = w.cpu()
            del w
    del params, state
    torch.cuda.empty_cache()
    out = {"left": False, "record": record, "metrics": metrics,
           "history": history, "mesh": tuple(now["mesh"].shape),
           "run_s": run_s, "io": io, "held": None}
    if rank:
        return out

    def worst(pairs):
        d, where = 0.0, ""
        for key, g, w in pairs:
            w = w.float()
            x = float((g.float() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            if x > d:
                d, where = x, "/".join(key)
        return d, where

    abstract = T.abstract_params(cfg)
    like = {"params": abstract, "opt": adamw_init(abstract, opt_cfg)}
    tree, _, _ = restore_checkpoint(ckpt, like, step=ELASTIC_FAIL - 1)
    ref = REF_MV[cfg.name, cfg.num_layers]
    at1 = {k: worst((p, t, ref[k][p])
                    for p, t in tree_flatten_with_keys(tree["opt"][k]))
           for k in ("m", "v")}
    tree = tree_map(lambda t: t.to(dev), tree)
    plain = steps.make_train_step(cfg, opt_cfg, settings)
    params, state = tree["params"], tree["opt"]
    del tree
    tail = []
    for i in range(ELASTIC_FAIL, ELASTIC_STEPS):
        params, state, m = plain(params, state, {"batch": {
            k: v[:rows] for k, v in pool[i].items()}, "step": i})
        tail.append((i, float(m["loss"]), float(m["grad_norm"])))
    after = {k: worst((p, got[(k,) + tuple(p)], t.cpu()) for p, t in
                      tree_flatten_with_keys(state[k])) for k in ("m", "v")}
    del params, state
    torch.cuda.empty_cache()
    out["held"] = dict(at1=at1, tail=tail, after=after)
    return out


def mesh_train_arch(torch, rank, dev, table, opt_cfg, spent, cfg, B, S,
                    meshes, *, settings=None, n_steps=FAMILY_STEPS,
                    reference=True):
    """``mesh_train_rank``'s work for one run of ``n_steps`` steps under
    ``settings`` (the arch's preset by default): the reference on rank 0
    (unless ``reference`` is off), then every mesh. Returns {"ref" (rank
    0), "meshes"}; a step's metrics: loss, grad norm, seconds, seconds and
    count of collectives, all-gathers over "data"."""
    from repro_torch.core.tree import tree_flatten_with_keys, tree_map
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.presets import settings_for
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import steps

    settings = settings or settings_for(cfg.name)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    extra = extra_inputs(cfg, B, gen, dev)
    batches = [dict(stream.batch_at(i), **extra)
               for i in range(n_steps)]

    def draw():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return T.init_params(gen, cfg, device=dev)

    def train(step_fn, pair):
        # pair: [params, AdamW state], emptied here, so that a step holds
        # the state it reads and the one it makes, and no third copy
        params, state = pair.pop(0), pair.pop(0)
        torch.cuda.synchronize()
        reset_counts(table)
        metrics = []
        for i, batch in enumerate(batches):
            spent.update(s=0.0, n=0, gathers=0)
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state,
                                       {"batch": batch, "step": i})
            torch.cuda.synchronize()
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            time.perf_counter() - t0, spent["s"],
                            spent["n"], spent["gathers"]))
        return params, state, metrics, read_counts(table)

    out = {"meshes": []}
    if rank == 0 and reference:
        torch.cuda.reset_peak_memory_stats()
        pair = [draw()]
        pair.append(adamw_init(pair[0], opt_cfg))
        _, state, metrics, launches = train(
            steps.make_train_step(cfg, opt_cfg, settings), pair)
        ref = {k: dict(tree_flatten_with_keys(tree_map(
            lambda t: t.cpu(), state[k]))) for k in ("m", "v")}
        REF_MV[cfg.name, cfg.num_layers] = ref
        out["ref"] = dict(metrics=metrics, launches=launches,
                          peak_gib=torch.cuda.max_memory_allocated()
                          / 2 ** 30)
        del state
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    for dm in meshes:
        mesh = tmesh.make_local_mesh(*dm)
        step_fn = steps.make_train_step(cfg, opt_cfg, settings, mesh=mesh)
        shards = step_fn.shards
        lay = shards.layout
        base = torch.cuda.memory_allocated()
        pair = [shards.cut(draw())]
        torch.cuda.empty_cache()
        pair.append(adamw_init(pair[0], opt_cfg))
        share_gib = sum(t.numel() * t.element_size() for _, t in
                        tree_flatten_with_keys(pair[0])) / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        params, state, metrics, launches = train(step_fn, pair)
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        held = {}
        for key in ("m", "v") if reference else ():
            worst, where = 0.0, ""
            for path, t in tree_flatten_with_keys(state[key]):
                w = shards.whole(_nest(path, t))     # None but on rank 0
                if w is not None:
                    for k in path:
                        w = w[k]
                    ref_t = ref[key][path].to(dev).float()
                    d = float((w.float() - ref_t).abs().max()) / max(
                        float(ref_t.abs().max()), 1e-30)
                    if d > worst:
                        worst, where = d, "/".join(path)
                    del ref_t
                del w
            held[key] = (worst, where)
        local = lay.local_cfg()
        out["meshes"].append(dict(
            mesh=tuple(dm), coords=(lay.dp_rank, lay.tp_rank),
            heads=(local.num_heads, local.num_kv_heads), metrics=metrics,
            launches=launches, peak_gib=peak, base_gib=base / 2 ** 30,
            share_gib=share_gib, train_s=train_s,
            held=held if rank == 0 else None))
        del params, state, step_fn, shards, lay
        torch.cuda.empty_cache()
        torch.distributed.barrier()
    return out


def hold_mesh_train(out, cfg, settings, meshes, card, steps=FAMILY_STEPS):
    """The reference's and every rank's flash launches exactly 2 · L · n a
    step (forward and remat recompute per microbatch; 1 · L · n without
    remat; L the decoder's and the encoder's self-attention layers) and
    no other kernel; every
    rank's loss and grad norm equal; each mesh's loss and grad norm per
    step and m and v after ``FAMILY_STEPS`` steps within ``TRAIN_TOL`` of
    the one process's. ``out``: every rank's results of this run. Prints
    each rank's step ms beside the one process's."""
    L, n = cfg.num_layers + cfg.encoder_layers, settings.microbatches
    passes = 2 if cfg.remat else 1
    want = steps * passes * L * n
    arch = cfg.name

    def launches_ok(counts):
        return counts["flash_attention"] == want and not any(
            c for k, c in counts.items() if k != "flash_attention")

    ref = out[0]["ref"]
    bad = [] if launches_ok(ref["launches"]) else ["reference launches"]
    log("mesh-train", f"{arch}, one process: " + "; ".join(
        f"step {i} loss {l:.6f} grad-norm {g:.6f} ({t * 1e3:.1f} ms)"
        for i, (l, g, t, *_) in enumerate(ref["metrics"]))
        + f"; flash launches {ref['launches']['flash_attention']} (want "
        f"{want}: {passes} x {L} layers x {n} microbatches x {steps} "
        f"steps); peak {ref['peak_gib']:.2f} GiB [{card}]")
    for i, dm in enumerate(meshes):
        ranks = [o["meshes"][i] for o in out]
        what = f"{arch} {dm[0]}x{dm[1]}"
        for r in ranks:
            ok = launches_ok(r["launches"]) and [m[:2] for m in r[
                "metrics"]] == [m[:2] for m in ranks[0]["metrics"]]
            bad += [] if ok else [f"{what} rank {r['coords']}"]
            log("mesh-train", f"{what} rank {r['coords']} (gloo"
                f"): heads {r['heads'][0]}/{r['heads'][1]}, shares "
                f"{r['share_gib']:.2f} GiB, step ms "
                + ", ".join(f"{m[2] * 1e3:.1f}" for m in r["metrics"])
                + " (one process: " + ", ".join(
                    f"{m[2] * 1e3:.1f}" for m in ref["metrics"])
                + "), of which in collectives (host wall, each waiting "
                "for the card) " + ", ".join(
                    f"{m[3] * 1e3:.1f} ms in {m[4]}" for m in r["metrics"])
                + f", flash launches {r['launches']['flash_attention']} "
                f"(want {want}), peak {r['peak_gib']:.2f} GiB "
                f"{'ok' if ok else 'FAIL'} [ranks share one card: {card}]")
        for j in range(steps):
            for k, name in enumerate(("loss", "grad_norm")):
                got, w = ranks[0]["metrics"][j][k], ref["metrics"][j][k]
                d = abs(got - w) / abs(w)
                ok = d <= TRAIN_TOL[name]
                bad += [] if ok else [f"{what} step {j} {name}"]
                log("mesh-train", f"{what} step {j} {name}: mesh {got:.6f} "
                    f"vs one process {w:.6f}, |d|/|ref| {d:.2e} "
                    f"{'ok' if ok else 'FAIL'} ({TRAIN_TOL[name]})")
        for name in ("m", "v"):
            d, where = ranks[0]["held"][name]
            ok = d <= TRAIN_TOL[name]
            bad += [] if ok else [f"{what} {name}"]
            log("mesh-train", f"{what} after step {steps}, {name} "
                f"gathered from the ranks: max|d| / max|ref| per leaf "
                f"{d:.3e} (worst {where}) {'ok' if ok else 'FAIL'} "
                f"({TRAIN_TOL[name]:.3g})")
        log("mesh-train", f"{what}: {steps} steps in "
            f"{max(r['train_s'] for r in ranks):.2f} s on the slowest rank")
    return bad


def mesh_train(torch, card):
    """Phase 14: every run of ``MESH_TRAIN_RUNS`` under its preset,
    reckoned (``reckon_mesh_train``), then one spawn of 4 ranks on the one
    card over gloo that runs, per run, the one-process reference (rank 0)
    and every mesh, each held by ``hold_mesh_train``, then the elastic
    run (``MESH_ELASTIC``, ``hold_mesh_elastic``). Keeps rank (0, 0)'s
    peak of danube's 1x4 mesh for phase 15. ``main`` runs the two halves
    apart (``mesh_train_start``, ``mesh_train_finish``) with phase 13 and
    phase 15's one-device cells between them."""
    mesh_train_finish(torch, card, mesh_train_start(card))


def mesh_train_start(card):
    """Phase 14's reckoning and its 4 ranks, started; returns the job."""
    from repro_torch.launch.presets import settings_for
    for arch, layers, B, S, meshes in MESH_TRAIN_RUNS:
        cfg = mesh_train_cfg(arch, layers)
        reckon_mesh_train(cfg, settings_for(arch), card, B, S, meshes)
    arch, layers, B, S, dm = MESH_ELASTIC
    reckon_mesh_train(mesh_train_cfg(arch, layers), settings_for(arch),
                      card, B, S, [dm, (dm[0] - 1, dm[1])])
    job = start_mesh([list(r) for r in MESH_TRAIN_RUNS], 4, timeout=700,
                     flag="--mesh-train-rank", phase="mesh-train")
    job["t0"] = time.perf_counter()
    return job


# the card's free memory, once the main process has let go of its cache,
# below which phase 14's ranks wait for phase 13's (their peaks, ~25 GiB
# together, beside phase 13's: its one-process llama3-405b reference ~19
# GiB, or its 4 llama ranks ~21 GiB while one draws a 7.83 GiB fp32 leaf)
MESH_BESIDE_FREE = 48 * 2 ** 30


def train_beside(torch, card):
    """Phase 14's ranks started (``mesh_train_start``) to run beside phase
    13 when the card has ``MESH_BESIDE_FREE`` free; else None (``main``
    starts them after phase 13). The card's free memory and what this
    process holds are printed either way."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    beside = free >= MESH_BESIDE_FREE
    if torch.cuda.memory_allocated() > 2 * 2 ** 30:
        live = sorted((t.numel() * t.element_size(), tuple(t.shape),
                       str(t.dtype).split(".")[-1])
                      for t in gc.get_objects()
                      if isinstance(t, torch.Tensor) and t.is_cuda)[-5:]
        log("mesh-train", "this process's largest live tensors: " + ", ".join(
            f"{shape} {dt} {n / 2**30:.2f} GiB" for n, shape, dt in live))
    log("mesh-train", f"the card {free / 2**30:.2f} of {total / 2**30:.2f} "
        f"GiB free, this process holding "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved): phase 14's "
        + ("ranks start now, beside phase 13" if beside else
           f"ranks wait for phase 13 (less than "
           f"{MESH_BESIDE_FREE / 2**30:.0f} GiB free)") + f" [{card}]")
    return mesh_train_start(card) if beside else None


def mesh_train_finish(torch, card, job):
    """Waits for ``mesh_train_start``'s ranks and holds what they ran."""
    from repro_torch.launch.presets import settings_for
    out = finish_mesh(job)
    log("mesh-train", f"4 ranks on one card: {len(MESH_TRAIN_RUNS)} runs' "
        f"references and meshes and the elastic run in "
        f"{time.perf_counter() - job['t0']:.1f} s from their start")
    bad = []
    for i, (arch, layers, _, _, meshes) in enumerate(MESH_TRAIN_RUNS):
        bad += hold_mesh_train([o["runs"][i] for o in out],
                               mesh_train_cfg(arch, layers),
                               settings_for(arch), meshes, card)
    arch, layers, B, S, dm = MESH_ZERO3
    cfg = mesh_train_cfg(arch, layers)
    zero3 = zero3_settings()
    bad += hold_mesh_train([o["zero3"] for o in out], cfg, zero3, [dm], card,
                           steps=ZERO3_STEPS)
    bad += hold_zero3(out, cfg, zero3, card)
    bad += hold_mesh_elastic([o["elastic"] for o in out],
                             out[0]["runs"][0]["ref"]["metrics"], card)
    r0 = out[0]["runs"][0]["meshes"][0]
    PEAKS[MESH_TRAIN_PEAK] = (
        (r0["peak_gib"] - r0["base_gib"]) * 2 ** 30,
        dict(mesh=r0["mesh"], B=8, S=1024, layers=MESH_TRAIN_LAYERS))
    for label, key, settings in ((ZERO3_PEAK, "zero3", zero3),
                                 (ZERO2_PEAK, "zero2",
                                  zero3_settings(zero2=True))):
        r0 = out[0][key]["meshes"][0]
        PEAKS[label] = ((r0["peak_gib"] - r0["base_gib"]) * 2 ** 30,
                        dict(mesh=r0["mesh"], B=B, S=S, layers=layers,
                             settings=settings))
    if bad:
        raise AssertionError(f"phase 14: {bad}")


def hold_zero3(out, cfg, settings, card):
    """Phase 14's ZeRO-3 cell beside ZeRO-2's (the whole slice gathered
    once a step): every rank's all-gathers over "data" each step exactly
    ``dryrun.zero3_collectives``; its peak below ZeRO-2's on the same
    rank by at least L - 2 layers' TP bytes (a layer at a time, not the slice).
    Returns what failed."""
    import math
    from repro_torch.launch.dryrun import zero3_collectives
    from repro_torch.runtime.sharding import TrainShards
    sh = TrainShards(cfg, SpecMesh(MESH_ZERO3[4]), fsdp=True)
    want = zero3_collectives(sh, settings.microbatches)[0]
    layer = sum(math.prod(s.shape) // (s.tp[1] if s.tp else 1)
                for p, s in sh.leaves.items()
                if p[0] == "layers") * 2 // cfg.num_layers
    bad = []
    for o in out:
        z3, z2 = o["zero3"]["meshes"][0], o["zero2"]["meshes"][0]
        got = [m[5] for m in z3["metrics"]]
        p3 = z3["peak_gib"] - z3["base_gib"]
        p2 = z2["peak_gib"] - z2["base_gib"]
        ok = got == [want] * len(got) \
            and (p2 - p3) * 2 ** 30 >= (cfg.num_layers - 2) * layer
        bad += [] if ok else [f"zero3 rank {z3['coords']}"]
        log("mesh-train", f"{cfg.name}-{cfg.num_layers}L 2x2 ZeRO-3 rank "
            f"{z3['coords']}: all-gathers over data a step {got} (reckoned "
            f"{want}: {settings.microbatches} microbatch(es) x (2 x "
            f"{cfg.num_layers} layers' cut leaves + the cut leaves outside "
            f"them)); peak {p3:.3f} GiB (a layer at a time) vs ZeRO-2 "
            f"{p2:.3f} GiB (the whole slice once a step; ZeRO-2 step "
            f"{z2['metrics'][0][2] * 1e3:.1f} ms, ZeRO-3 steps "
            + ", ".join(f"{m[2] * 1e3:.1f}" for m in z3["metrics"])
            + f" ms), apart {(p2 - p3) * 1024:.0f} MiB (want at least "
            f"{(cfg.num_layers - 2) * layer / 2**20:.0f} MiB: "
            f"{cfg.num_layers - 2} layers' TP bytes) {'ok' if ok else 'FAIL'}"
            f" [ranks share one card: {card}]")
    return bad


def hold_mesh_elastic(ranks, ref_metrics, card):
    """The elastic run (``mesh_elastic``): the runner's history on both
    survivors (two checkpoints, ``max_retries + 1`` failures at step
    ELASTIC_FAIL, the re-mesh and restart, two checkpoints), ranks 2 and 3
    gone after steps 0 and 1; flash launches 2 · L · n a step on every
    rank, no other kernel; steps 0 and 1 (2x2) against the one process's
    (loss, grad norm, and m and v in the step-1 checkpoint); steps 2 and
    3 (1x2) against one process restoring that checkpoint (loss, grad norm,
    m and v after step 3), all within ``TRAIN_TOL``. Prints each rank's
    step ms. Returns what failed."""
    from repro_torch.launch.presets import settings_for
    arch, layers, B, S, dm = MESH_ELASTIC
    cfg = mesh_train_cfg(arch, layers)
    n = settings_for(arch).microbatches
    want_flash = (2 if cfg.remat else 1) * cfg.num_layers * n
    f = ELASTIC_FAIL
    want_hist = [("checkpoint", s) for s in range(f)] + [
        ("failure", f, f"injected failure at step {f}")] * 4 + [
        ("remesh", f), ("restart", f)] + [
        ("checkpoint", s) for s in range(f, ELASTIC_STEPS)]
    bad, kept = [], (dm[0] - 1) * dm[1]
    for r, res in enumerate(ranks):
        steps_done = [e["step"] for e in res["record"]]
        want_steps = list(range(f)) if r >= kept else \
            list(range(ELASTIC_STEPS))
        ok = res["left"] == (r >= kept) and steps_done == want_steps \
            and all(e["flash"] == want_flash for e in res["record"]) \
            and (res["left"] or res["history"] == want_hist)
        bad += [] if ok else [f"elastic rank {r}"]
        log("mesh-train", f"elastic {arch}-{cfg.num_layers}L rank {r}: "
            + "; ".join(f"step {e['step']} at {e['mesh'][0]}x{e['mesh'][1]}"
                        f" {e['ms']:.1f} ms ({e['coll_s'] * 1e3:.1f} ms in "
                        f"{e['coll_n']} collectives), flash {e['flash']}"
                        for e in res["record"])
            + (" — left the mesh at the re-mesh" if res["left"] else
               f"; history {res['history']}; final mesh {res['mesh']}")
            + f" (want flash {want_flash} a step: 2 x {cfg.num_layers} x "
            f"{n}) {'ok' if ok else 'FAIL'} [ranks share one card: {card}]")
    got = {i: (l, g) for i, l, g in ranks[0]["metrics"]}
    held = ranks[0]["held"]
    wants = [(i, ref_metrics[i][:2], "the one process") for i in range(f)] \
        + [(i, (l, g), "one process from the step-1 checkpoint")
           for i, l, g in held["tail"]]
    for i, w, whom in wants:
        for k, name in enumerate(("loss", "grad_norm")):
            d = abs(got[i][k] - w[k]) / abs(w[k])
            ok = d <= TRAIN_TOL[name]
            bad += [] if ok else [f"elastic step {i} {name}"]
            log("mesh-train", f"elastic step {i} {name}: mesh {got[i][k]:.6f}"
                f" vs {whom} {w[k]:.6f}, |d|/|ref| {d:.2e} "
                f"{'ok' if ok else 'FAIL'} ({TRAIN_TOL[name]})")
    for label, diffs in (("step-1 checkpoint (2x2) vs the one process",
                          held["at1"]),
                         (f"after step {ELASTIC_STEPS - 1} (1x2) vs one "
                          f"process from the checkpoint", held["after"])):
        for name in ("m", "v"):
            d, where = diffs[name]
            ok = d <= TRAIN_TOL[name]
            bad += [] if ok else [f"elastic {label} {name}"]
            log("mesh-train", f"elastic {label}, {name}: max|d| / max|ref| "
                f"per leaf {d:.3e} (worst {where}) {'ok' if ok else 'FAIL'} "
                f"({TRAIN_TOL[name]:.3g})")
    log("mesh-train", f"elastic run: {ranks[0]['run_s']:.1f} s on rank 0 "
        f"(its steps {sum(e['ms'] for e in ranks[0]['record']) / 1e3:.1f} "
        f"s; checkpoint " + ", ".join(f"{w} {t:.1f} s"
                                      for w, t in ranks[0]["io"])
        + ")")
    return bad


# ---------------------------------------------------------------------------
# phase 15: the dry run on the meta device
# ---------------------------------------------------------------------------

# a prediction holds when it is within this share of the measured peak, or
# this many bytes of it, whichever is larger
PEAK_REL, PEAK_ABS = 0.10, 256 * 2 ** 20
# the production grid's cells: (arch, shape, layers kept (None: all),
# data rows dropped, global batch (None: the shape's)); llama3-405b's
# train_4k keeps 1 and 2 of its 126 layers (its 16 microbatches x 126
# layers of meta ops take ~7 minutes of host time: a rank's peak is
# reckoned linear in the layers from the two, beside the CPU's full-depth
# record in PERF.md), the rest full depth; the last is JAX's elastic cell:
# danube on the 15x16 survivors at batch 240. A decode shape's cell is
# JAX's (the ring state cut over "data" and "model"), then the paged
# departure beside it; llama3-405b's serving cells read its preset's
# fsdp_serve (JAX's dry run's rule): decode_32k first, then prefill_32k
DRYRUN_GRID = [("llama3-405b", "decode_32k", None, 0, None),
               ("llama3-405b", "prefill_32k", None, 0, None),
               ("h2o-danube-1.8b", "decode_32k", None, 0, None),
               ("h2o-danube-1.8b", "train_4k", None, 0, None),
               ("llama3-405b", "train_4k", 1, 0, None),
               ("llama3-405b", "train_4k", 2, 0, None),
               ("h2o-danube-1.8b", "train_4k", None, 1, 240)]


def meta_batch(torch, cfg, B, S):
    """A training batch of B x S tokens as meta tensors, with the arch's
    vision patches or audio frames (``launch.train.extra_inputs``'
    shapes)."""
    out = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    if cfg.vision_prefix:
        out["vision_embeds"] = torch.empty(
            (B, cfg.vision_prefix, cfg.d_model), dtype=cfg.dtype,
            device="meta")
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), dtype=cfg.dtype,
            device="meta")
    return out


def dryrun_cells(torch):
    """The dry run's counterpart of each peak an earlier phase measured
    (``PEAKS``): (label, the cell's step and arguments, the measured
    bytes, what was measured), each made when the one before has been
    traced (a fake world replaces the one before it): the one-device
    cells of phases 4, 7b and 12, then phase 14's mesh cells."""
    yield from one_device_cells(torch)
    yield from mesh_cells(torch)


def one_device_cells(torch):
    """``dryrun_cells``' cells of phases 7b, 4 and 12 (one device)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import TrainSettings
    opt_cfg = AdamWConfig(lr=1e-3)
    danube = configs.get_config(ARCH)
    label = f"{ARCH}-train-{TRAIN_BATCH}x{TRAIN_SEQ} launcher"
    peak, geo = PEAKS[label]
    yield ("danube-train-2x8192 (phase 7b, one device)",
           dryrun.train_cell(danube, meta_batch(
               torch, danube, geo["B"], geo["S"]), TrainSettings(
               microbatches=geo["microbatches"]), opt_cfg=opt_cfg),
           peak, "the launcher's run, its checkpoints included")
    peak, geo = PEAKS["danube-serve-8x512 decode step"]
    yield ("danube-serve-8x512 decode step (phase 4, one device)",
           dryrun.decode_paged_cell(
               danube, geo["B"], geo["cache_len"],
               page_size=geo["page_size"], num_blocks=geo["num_blocks"],
               kv_format=geo["kv_format"], attn_path=geo["attn_path"],
               kv_partitions=geo["kv_partitions"]),
           peak, "the engine's highest decode step: weights, pool, step")
    whisper = configs.get_config("whisper-small")
    peak, geo = PEAKS["whisper-small-train-4x448 flash bfloat16"]
    yield ("whisper-train-4x448 (phase 12, one device)",
           dryrun.train_cell(whisper, meta_batch(
               torch, whisper, geo["B"], geo["S"]), TrainSettings(),
               opt_cfg=opt_cfg),
           peak, "the flash run's four steps")


def mesh_cells(torch):
    """``dryrun_cells``' cells of phase 14's ranks (a fake world of 4)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.presets import settings_for
    from repro_torch.optim import AdamWConfig
    opt_cfg = AdamWConfig(lr=1e-3)
    danube = configs.get_config(ARCH)
    peak, geo = PEAKS[MESH_TRAIN_PEAK]
    cut = dataclasses.replace(danube, num_layers=geo["layers"])
    yield (f"{MESH_TRAIN_PEAK} (phase 14, a fake world of 4)",
           dryrun.train_cell(cut, meta_batch(torch, cut, geo["B"], geo["S"]),
                             settings_for(ARCH), opt_cfg=opt_cfg,
                             mesh=tmesh.fake_mesh(*geo["mesh"])),
           peak, "rank (0, 0)'s two steps")
    for label, what in ((ZERO3_PEAK, f"rank (0, 0)'s {ZERO3_STEPS} steps"),
                        (ZERO2_PEAK, f"rank (0, 0)'s {ZERO2_STEPS} step")):
        peak, geo = PEAKS[label]
        cut = dataclasses.replace(danube, num_layers=geo["layers"])
        yield (f"{label} (phase 14, a fake world of 4)",
               dryrun.train_cell(
                   cut, meta_batch(torch, cut, geo["B"], geo["S"]),
                   geo["settings"], opt_cfg=opt_cfg,
                   mesh=tmesh.fake_mesh(*geo["mesh"])),
               peak, what)


def dryrun_phase(torch, card):
    """Phase 15: the dry run (``repro_torch.launch.dryrun``) on the meta
    device beside what the card measured. For each cell an earlier phase
    ran on the card, its step traced at that phase's geometry (a mesh
    rank on a fake world of the same size) predicts the step's peak
    (``peak_total``: its arguments and every temporary), printed beside
    the phase's measured peak less what the process held before the cell's
    own tensors; a miss (off by more than PEAK_REL and PEAK_ABS) is printed
    with the breakdown that explains it. Then the production grid
    (``DRYRUN_GRID``) at 16x16 and JAX's elastic cell at 15x16: every
    record OK, with its peak, flops and collective bytes. No kernel
    launches: counts stay as they were. ``main`` runs it in three parts:
    the grid in a process of its own from the start
    (``dryrun_grid_start``), the one-device cells while phase 14's ranks
    run, the mesh cells after them (``dryrun_held``,
    ``dryrun_finish``)."""
    t0 = time.perf_counter()
    misses = dryrun_held(torch, card, dryrun_cells(torch))
    dryrun_finish(dryrun_grid_lines(torch), misses, t0)


def dryrun_held(torch, card, cells):
    """Phase 15's cells (``dryrun_cells`` or a part of it) traced and each
    printed beside its measured peak; returns the labels that missed."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    misses = []
    for label, (step, args, meta), measured, what in cells:
        t1 = time.perf_counter()
        rec = dryrun.trace(step, args)
        b = rec["bytes_per_device"]
        pred = b["peak_total"]
        off = pred - measured
        ok = abs(off) <= max(PEAK_REL * measured, PEAK_ABS)
        misses += [] if ok else [label]
        log("dryrun", f"{label}: predicted peak {pred / 2**30:.3f} GiB "
            f"(arguments {b['argument'] / 2**30:.3f}, temporaries "
            f"{b['temp'] / 2**30:.3f}, outputs {b['output'] / 2**30:.3f}) "
            f"vs measured {measured / 2**30:.3f} GiB ({what}): off "
            f"{off / 2**20:+.0f} MiB = {off / max(measured, 1):+.1%} "
            f"{'ok' if ok else 'MISS'} (within {PEAK_REL:.0%} or "
            f"{PEAK_ABS // 2**20} MiB); {rec['cost']['flops']:.4g} FLOP, "
            f"{rec['collectives']['total'] / 2**30:.3f} GiB of collectives; "
            f"traced in {time.perf_counter() - t1:.1f} s [{card}]")
        del step, args
        if not ok:
            log("dryrun", f"{label}: MISS by {off / 2**20:+.0f} MiB: "
                + ("the card held more than the step's arguments and "
                   "temporaries: memory the phase keeps beside the step "
                   "(allocator rounding and cached blocks are not "
                   "allocated bytes)" if off < 0 else
                   "the trace holds more than the card did: a temporary "
                   "the eager step frees earlier than the meta trace "
                   "sees"))
    if dist.is_initialized():
        dist.destroy_process_group()
    return misses


def dryrun_grid_lines(torch):
    """``DRYRUN_GRID`` traced, every decode shape as JAX's cell and then
    the paged departure, and the train cells cut in depth reckoned linear
    in the layers: phase 15's lines for them (no card work, nothing read
    from an earlier phase). A record that is not OK fails."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    if dist.is_initialized():
        dist.destroy_process_group()
    lines = []
    grid = [(arch, shape, layers, drop, batch, paged)
            for arch, shape, layers, drop, batch in DRYRUN_GRID
            for paged in ((False, True)
                          if dryrun.SHAPES[shape].kind == "decode"
                          else (False,))]
    cut_peaks = {}
    for arch, shape, layers, drop, batch, paged in grid:
        rec = dryrun.run_cell(arch, shape, layers=layers, drop_data=drop,
                              global_batch=batch, paged=paged,
                              verbose=False)
        if rec["status"] != "OK":
            raise AssertionError(f"dry run {arch} {shape}: {rec}")
        b, c = rec["bytes_per_device"], rec["collectives"]
        cell = {"ring": " JAX's cell (the ring state)",
                "paged (departure)": " the paged departure"}.get(
            rec.get("cell"), "")
        lines.append(
            f"{arch} {shape}{cell} at {rec['mesh']}"
            + (f", global batch {batch}" if batch else "")
            + (f", {layers} of {dryrun.configs.get_config(arch).num_layers}"
               f" layers" if layers else "")
            + f": rank 0 peak {b['peak_total'] / 2**30:.3f} GiB (arguments "
            f"{b['argument'] / 2**30:.3f}, temporaries "
            f"{b['temp'] / 2**30:.3f}), fits one H100: {rec['fits_h100']}; "
            f"{rec['cost']['flops']:.4g} FLOP "
            f"({rec['cost']['kernel_flops']:.4g} in kernels); collectives "
            + ", ".join(
                f"{k} {v['count']} x {v['bytes'] / 2**30:.3f} GiB"
                for k, v in c.items() if k != "total" and v["count"])
            + (f"; fsdp_serve {rec['fsdp_serve']}" if "fsdp_serve" in rec
               else "")
            + f"; traced in {rec['seconds']:.1f} s")
        dist.destroy_process_group()
        if layers:
            cut_peaks.setdefault((arch, shape), {})[layers] = \
                b["peak_total"]
    for (arch, shape), peaks in cut_peaks.items():
        (l0, p0), (l1, p1) = sorted(peaks.items())[:2]
        L = dryrun.configs.get_config(arch).num_layers
        whole = p0 + (p1 - p0) * (L - l0) / (l1 - l0)
        lines.append(
            f"{arch} {shape} at 16x16, all {L} layers reckoned "
            f"linear in the layers from {l0} and {l1}: rank 0 peak "
            f"{whole / 2**30:.3f} GiB ({(p1 - p0) / (l1 - l0) / 2**30:.3f} "
            f"GiB a layer), fits one H100: {whole <= dryrun.card_bytes()}")
    return lines


def dryrun_grid_rank(out_path):
    """``chip_smoke.py --dryrun-grid out_path``: ``dryrun_grid_lines`` in
    a process of its own (the meta device only), written to
    ``out_path`` as JSON with its seconds."""
    import torch
    t0 = time.perf_counter()
    lines = dryrun_grid_lines(torch)
    with open(out_path, "w") as f:
        json.dump({"lines": lines, "seconds": time.perf_counter() - t0}, f)
    return 0


def dryrun_grid_start():
    """Start ``dryrun_grid_rank`` (one CPU core, no card work) and return
    at once; ``dryrun_grid_wait`` reads its lines."""
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    out = open(os.path.join(d, "grid.log"), "w+")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-grid",
         os.path.join(d, "grid.json")], stdout=out,
        stderr=subprocess.STDOUT, env=env)
    STARTED.append(proc)
    return dict(dir=d, log=out, proc=proc, t0=time.perf_counter())


def dryrun_grid_wait(job, timeout=900):
    """``dryrun_grid_start``'s lines once its process has ended: a process
    that fails or outlives ``timeout`` from its start fails phase 15."""
    import shutil
    proc, d = job["proc"], job["dir"]
    try:
        try:
            proc.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                                  - job["t0"])))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        job["log"].seek(0)
        text = job["log"].read()
        job["log"].close()
        if proc.returncode:
            log("dryrun", f"the grid's process exited {proc.returncode}:\n"
                f"{text[-4000:]}")
            raise AssertionError(f"phase 15: the grid's process exited "
                                 f"{proc.returncode}")
        with open(os.path.join(d, "grid.json")) as f:
            rec = json.load(f)
        log("dryrun", f"the grid below traced in {rec['seconds']:.1f} s "
            f"in a process of its own (started after the build, beside "
            f"the card's phases; waited for here "
            f"{time.perf_counter() - job['t0']:.1f} s after its start)")
        return rec["lines"]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def dryrun_finish(lines, misses, t0):
    """Phase 15's grid lines printed, then its time and misses; fails if
    the ZeRO-3 cell's prediction missed."""
    for line in lines:
        log("dryrun", line)
    log("dryrun", f"phase 15 took {time.perf_counter() - t0:.1f} s; "
        f"{len(misses)} predictions missed: {misses}")
    if any(m.startswith(ZERO3_PEAK) for m in misses):
        raise AssertionError(f"phase 15: the dry run's ZeRO-3 peak misses "
                             f"the measured one ({ZERO3_PEAK})")


# ---------------------------------------------------------------------------
# phase 16: the ring engine
# ---------------------------------------------------------------------------

# (a) danube at full width and depth, W4A16, 8 requests of 512 + RING_GEN
# tokens through ServingEngine(paged=False) beside the paged engine on the
# same weights
RING_GEN = 32
RING_KW = dict(max_batch=8, max_prompt_len=512, max_new_tokens=RING_GEN)
# (b) danube's first 2 layers on 1x2 gloo ranks against one process,
# phase 13's requests (4 slots, 128 + 8 tokens)
RING_MESH_KW = dict(max_batch=4, max_prompt_len=MESH_PROMPT,
                    max_new_tokens=MESH_GEN, paged=False)
RING_MESH = [("h2o-danube-1.8b", 2, (1, 2), False, "ring")]
# their ranks' results, served in phase 13's spawn of 2 ranks
RING_RANKS = []
# (c) the refine pass at the worst shapes of PERF.md rows 1d and 1e
REFINE_SHAPES = [("granite (6144, 128)", 6144, 128),
                 ("llama3 tp4 wk/wv (16384, 256)", 16384, 256)]
REFINE_M = (1, 8, 16)


def first_step_logits(engine):
    """Keep the first decode step's logits and input tokens of
    ``engine`` (its serve steps wrapped) in the returned dict."""
    box = {}
    make = engine._serve_step

    def serve_step(live_pages=None):
        fn = make(live_pages)

        def run(params, inputs):
            res = fn(params, inputs)
            if "logits" not in box:
                box.update(logits=res["logits"].float().cpu(),
                           tokens=inputs["tokens"].cpu())
            return res
        return run
    engine._serve_step = serve_step
    return box


def step_gap(a, b):
    """max|d| of two first decode steps' logits over the rows whose input
    tokens agree, and how many rows that is."""
    same = (a["tokens"] == b["tokens"]).nonzero().flatten().tolist()
    rows = [r for r in same if r < a["logits"].shape[0]]
    if not rows:
        return float("inf"), 0
    return float((a["logits"][rows] - b["logits"][rows]).abs().max()), \
        len(rows)


def first_divergence(got, want):
    """(request, token index, got, want) of the first greedy token that
    differs, or None."""
    return next(((r, i, a, b) for r in sorted(want)
                 for i, (a, b) in enumerate(zip(got[r], want[r]))
                 if a != b), None)


def ring_serve(torch, dev, card, table, paged):
    """Phase 16(a): danube at full width and depth (W4A16, bf16) serves
    ``RING_KW``'s 8 requests of 512 + 32 tokens through the ring engine,
    counters set to 0 just before and read just after: every whole-prompt
    prefill launching 24 flash and 168 W4A16 kernels, every decode step
    168 W4A16 and no paged attention. Its prefill logits and first decode
    step's logits (rows whose input tokens agree) against the paged
    engine's on the same weights within LOGIT_TOL (``paged``: phase 4's
    run of the same requests on the launcher's weights from seed 0);
    greedy tokens compared and the first divergence printed with the
    paged engine's logit gap there."""
    from repro_torch import configs
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import ServingEngine
    cfg = dataclasses.replace(configs.get_config(ARCH), attn_impl="flash")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = T.quantize_params(T.init_params(gen, cfg, device=dev), cfg,
                               min_size=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = launcher.make_requests(cfg, 8, 512, RING_GEN, 0)
    engine = ServingEngine(cfg, params, device=dev, paged=False, **RING_KW)
    step0 = first_step_logits(engine)
    torch.cuda.synchronize()
    reset_counts(table)
    t0 = time.perf_counter()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    ring = dict(rep=rep, step0=step0, counts=read_counts(table),
                wall=time.perf_counter() - t0, path=engine.attn_path,
                cache_len=engine.cache_len)
    del engine
    L, steps = cfg.num_layers, len(rep.step_records)
    want = {"w4a16_gemm": 7 * L * (rep.admitted + steps),
            "flash_attention": L * rep.admitted, "paged_attention": 0}
    counts = ring["counts"]
    others = {k: v for k, v in counts.items() if v and k not in want}
    got = {k: counts[k] for k in want}
    d_pre = max(float((rep.prefill_logits[r].float()
                       - paged["rep"].prefill_logits[r].float())
                      .abs().max()) for r in rep.results)
    d_step, rows = step_gap(ring["step0"], paged["step0"])
    toks = [a == b for r in rep.results
            for a, b in zip(rep.results[r], paged["rep"].results[r])]
    first = first_divergence(rep.results, paged["rep"].results)
    gap = "none"
    if first is not None:
        r, i = first[:2]
        gap = f"request {r} token {i}: {first[2]} vs {first[3]}"
        if i == 0:
            lg = paged["rep"].prefill_logits[r].float()
            gap += (f", the paged engine's logit gap "
                    f"{float(lg.max() - lg[first[2]]):.3e}")
    ok = got == want and not others and d_pre <= LOGIT_TOL \
        and d_step <= LOGIT_TOL and rows > 0 \
        and all(len(v) == RING_GEN for v in rep.results.values())
    log("ring", f"{ARCH} W4A16 ({L} layers, full width; built "
        f"{build_s:.1f} s) ring engine (attn path {ring['path']}, "
        f"cache_len {ring['cache_len']} a slot): {len(rep.results)} x 512 + "
        f"{RING_GEN} in {ring['wall']:.2f} s, prefill {rep.prefill_s:.3f} "
        f"s, decode {rep.decode_s / max(steps, 1) * 1e3:.2f} ms/step over "
        f"{steps} steps (the paged engine: phase 4's run, attn path "
        f"{paged['path']}, cache_len {paged['cache_len']}); "
        f"launches " + ", ".join(f"{k} {got[k]}" for k in want)
        + f" (want {', '.join(str(want[k]) for k in want)}: "
        f"{rep.admitted} whole-prompt prefills, {steps} decode steps; "
        f"others {others or 'none'}); vs the paged engine: prefill logits "
        f"max|d|={d_pre:.3e}, first decode step's logits max|d|="
        f"{d_step:.3e} over {rows} rows whose tokens agree (tolerance "
        f"{LOGIT_TOL}), greedy tokens equal {sum(toks)}/{len(toks)}, "
        f"first divergence {gap} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("phase 16: the ring engine disagrees with the "
                             "paged engine or missed its kernels")
    del params
    torch.cuda.empty_cache()


def ring_mesh(torch, dev, card, table):
    """Phase 16(b): danube's first 2 layers at full width on the ring
    engine, on 1x2 gloo ranks sharing the card (the window cut over
    "model", each rank's slice for every KV head; served in phase 13's
    spawn of 2 ranks, ``RING_RANKS``) against one process serving the same
    weights: first-token logits and the first
    decode step's logits within LOGIT_TOL, W4A16 7 a layer a forward and
    flash 1 a layer an admit on every rank (equal to the one process's),
    no paged attention, the ranks' tokens equal, the first greedy token
    that differs from the one process printed."""
    arch, layers, dm, serial, what = RING_MESH[0]
    cfg = mesh_cfg(arch, layers, what)
    params = mesh_weights(torch, dev, cfg)
    ref = mesh_serve_run(torch, dev, cfg, params, table, what=what)
    del params
    torch.cuda.empty_cache()
    if len(RING_RANKS) != dm[0] * dm[1]:
        raise AssertionError(f"phase 16: phase 13's spawn gave "
                             f"{len(RING_RANKS)} ring ranks")
    ranks = list(RING_RANKS)
    L = cfg.num_layers
    want = {"w4a16_gemm": 7 * L * (ref["admits"] + ref["steps"]),
            "flash_attention": L * ref["admits"], "paged_attention": 0}
    bad = []
    for res in ranks:
        d = max(float((res["logits"][r] - ref["logits"][r]).abs().max())
                for r in ref["logits"])
        d_step, rows = step_gap(res["step0"], ref["step0"])
        got = {k: res["launches"][k] for k in want}
        one = {k: ref["launches"][k] for k in want}
        others = {k: v for k, v in res["launches"].items()
                  if v and k not in want}
        first = first_divergence(res["tokens"], ref["tokens"])
        ok = d <= LOGIT_TOL and d_step <= LOGIT_TOL and rows > 0 \
            and got == want == one and not others \
            and res["tokens"] == ranks[0]["tokens"]
        bad += [] if ok else [res["coords"]]
        log("ring", f"{arch}-{L}L ring at {dm[0]}x{dm[1]} rank "
            f"{res['coords']} ({res['backend']}): heads {res['heads'][0]}/"
            f"{res['heads'][1]}, first-token logits vs one process max|d|="
            f"{d:.3e}, first decode step's logits max|d|={d_step:.3e} over "
            f"{rows} rows (tolerance {LOGIT_TOL}), launches "
            + ", ".join(f"{k} {got[k]}" for k in want)
            + f" (want {', '.join(str(want[k]) for k in want)}; one "
            f"process {', '.join(str(one[k]) for k in want)}; others "
            f"{others or 'none'}), first differing greedy token "
            f"{'none' if first is None else f'request {first[0]} token {first[1]}: {first[2]} vs {first[3]}'}"
            f"; decode {res['decode_s'] / max(res['steps'], 1) * 1e3:.1f} "
            f"ms/step (one process "
            f"{ref['decode_s'] / max(ref['steps'], 1) * 1e3:.1f}) "
            f"{'ok' if ok else 'FAIL'} [ranks share one card: {card}]")
    if bad:
        raise AssertionError(f"phase 16: ring ranks {bad} disagree with "
                             f"the one process")


def refine_check(torch, dev, card):
    """Phase 16(c): the refine pass's plan (``plan_matmul(refine=True)``:
    ``kernels/autotune.py``'s split_k) at ``REFINE_SHAPES`` and
    ``REFINE_M``, held against the plain version at that split (GEMM_TOL),
    then timed beside the default plan's split and ``torch.matmul`` on the
    dense bf16 weight (phase 5's timer, L2 flushed). No claim: the ranking
    is a model."""
    from repro_torch.kernels import planning, ref
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    timer = Timer(torch, dev)
    for label, K, N in REFINE_SHAPES:
        for M in REFINE_M:
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            prob = planning.MatmulProblem.from_operands(x, qt)
            default = planning.plan_matmul(prob, use_cache=False).split_k
            refined = planning.plan_matmul(prob, refine=True,
                                           use_cache=False).split_k
            held("w4a16_gemm", f"refined plan {label} M={M} split_k="
                 f"{refined}", w4a16_fused(x, qt, split_k=refined),
                 w4a16_fused_plain(x, qt, split_k=refined), f32=False)
            w = ref.dequant_ref(qt.packed, qt.scales, qt.zeros,
                                qt.group_size, out_dtype=x.dtype)
            ms_ref = timer(lambda: w4a16_fused(x, qt, split_k=refined))
            ms_def = timer(lambda: w4a16_fused(x, qt, split_k=default))
            ms_mm = timer(lambda: torch.matmul(x, w))
            log("ring", f"refine {label} M={M}: refined split_k {refined} "
                f"{ms_ref:.4f} ms, default split_k {default} {ms_def:.4f} "
                f"ms, torch.matmul on the dense bf16 weight {ms_mm:.4f} ms "
                f"[{card}]")
            del x, qt, w
    del timer
    torch.cuda.empty_cache()


def ring_phase(torch, dev, card, table, paged):
    """Phase 16: the ring engine on one card (against ``paged``, phase 4's
    run) and on 1x2 ranks, and the planner's refine pass."""
    ring_serve(torch, dev, card, table, paged)
    ring_mesh(torch, dev, card, table)
    refine_check(torch, dev, card)


# ---------------------------------------------------------------------------
# phase 17: the compiled serving steps (CUDA graphs) against eager
# ---------------------------------------------------------------------------

# (b): the families held compiled against eager on tokens, at the depths
# their phases use (``None``: full depth), 8 requests of 64 + 16 tokens
# (danube's prompts repeat a 16-token segment, so ngram proposes)
HOLD_PROMPT, HOLD_GEN = 64, 16
COMPILED_HOLDS = [
    ("h2o-danube-1.8b ngram verify", ARCH, FEATURE_LAYERS,
     ["--page-size", "8", "--speculate", "ngram", "--spec-k", str(SPEC_K)]),
    ("rwkv6-7b", "rwkv6-7b", CARRY_LAYERS["rwkv6-7b"], ["--page-size", "16"]),
    ("whisper-small", "whisper-small", None, ["--page-size", "16"]),
    ("olmoe-1b-7b", MOE_ARCH, MOE_LAYERS, ["--page-size", "16"]),
]


def step_run(torch, engine, reqs, table, kernels, what):
    """Serve ``reqs`` through the stepper: every prefill step, then 10
    decode steps untraced, timed to a sync, then 4 under
    ``torch.profiler`` (device busy ms and ops a step; the launches the
    card recorded beside the counters), then the rest; each of those 24
    steps' launches of ``kernels``. Returns a dict."""
    from torch.profiler import ProfilerActivity, profile
    engine.start()
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.report.decode_tokens == 0:
        engine.step()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = []

    def step():
        n0 = [table[k][0].launches for k in kernels]
        engine.step()
        counts.append(tuple(table[k][0].launches - n
                            for k, n in zip(kernels, n0)))

    for _ in range(10):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    n0 = read_counts(table)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step()
        torch.cuda.synchronize()
    rows, busy, ops = device_rows(prof, 4)
    recorded_launches(rows, n0, read_counts(table), what, "compiled")
    rep = engine.drain()
    torch.cuda.synchronize()
    return dict(rep=rep, prefill_s=prefill_s, wall=wall, busy=busy, ops=ops,
                rows=rows, counts=sorted(set(counts)),
                pool=engine.graph_pool)


def logit_hold(a, b):
    """(max|d| over every request's first-token logits, bit-equal)."""
    d = max(float((a.prefill_logits[r].float()
                   - b.prefill_logits[r].float()).abs().max())
            for r in a.results)
    same = all(torch_equal(a.prefill_logits[r], b.prefill_logits[r])
               for r in a.results)
    return d, same


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a, b))


def hold_compiled(compiled, eager, what, launches):
    """Compiled against eager: the same greedy tokens, first-token logits
    bit-equal or within LOGIT_TOL (then named), the same launches."""
    d, same = logit_hold(compiled, eager)
    div = first_divergence(compiled.results, eager.results)
    ok = div is None and d <= LOGIT_TOL and launches[0] == launches[1]
    log("compiled", f"{what}: greedy tokens compiled vs eager "
        f"{'equal' if div is None else f'DIFFER at {div}'} "
        f"({sum(len(v) for v in compiled.results.values())} tokens); "
        f"first-token logits "
        + ("bit-equal" if same else f"max|d|={d:.3e}, not bit-equal "
           f"(within LOGIT_TOL {LOGIT_TOL}: the same kernels on the same "
           f"inputs, whose sums are not run-to-run deterministic)")
        + f"; launches compiled {launches[0]} / eager {launches[1]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the compiled steps disagree with "
                             f"the eager ones")


def compiled_cell(torch, card, table):
    """17(a): phase 4's cell (danube at full width and depth, 8 x (512 +
    32), W4A16) through the serve launcher's engine compiled (the
    default) and ``--eager``, on the same weights (seed 0) and requests;
    counters set to 0 just before each run and read just after."""
    from repro_torch.launch import serve as launcher
    kernels = ("w4a16_gemm", "paged_attention")
    runs = {}
    for name, extra in (("compiled", []), ("eager", ["--eager"])):
        argv = SERVE_ARGV + extra
        log_built("compiled", argv)
        engine, reqs = launcher.build(launcher.build_args(argv))
        reset_counts(table)
        r = step_run(torch, engine, reqs, table, kernels,
                     f"danube 8 x (512 + 32) {name}")
        r["launches"] = {k: v for k, v in read_counts(table).items() if v}
        r["steps"] = launcher.steps_line(engine)
        runs[name] = r
        del engine
        torch.cuda.empty_cache()
    c, e = runs["compiled"], runs["eager"]
    for name, r in runs.items():
        log("compiled", f"danube 8 x (512 + 32) {name}: {r['steps']}; "
            f"prefill {r['prefill_s']:.2f} s wall; decode "
            f"{r['wall']:.3f} ms/step wall untraced, device busy "
            f"{r['busy']:.3f} ms/step in {r['ops']:.0f} device ops -> "
            f"device idle {1 - r['busy'] / r['wall']:.1%}; launches per "
            f"decode step of {list(kernels)} {r['counts']} [{card}]")
        for ev in r["rows"][:4]:
            log("compiled", f"  {name} device "
                f"{ev.self_device_time_total / 1e3 / 4:8.3f} ms/step  "
                f"x{ev.count / 4:<6.0f} {ev.key[:80]}")
    log("compiled", f"danube decode step compiled / eager: wall "
        f"{c['wall'] / e['wall']:.3f}x, device busy "
        f"{c['busy'] / max(e['busy'], 1e-9):.3f}x; prefill "
        f"{c['prefill_s'] / e['prefill_s']:.3f}x [{card}]")
    if not c["pool"].nodes:
        raise AssertionError("the compiled run's captures held no kernel "
                             "node against the launch counters")
    if c["counts"] != e["counts"] or c["counts"] != [(168, 24)]:
        raise AssertionError(f"launches per decode step compiled "
                             f"{c['counts']}, eager {e['counts']}, not "
                             f"[(168, 24)]")
    hold_compiled(c["rep"], e["rep"], "danube 8 x (512 + 32)",
                  (c["launches"], e["launches"]))


def compiled_holds(torch, dev, card, table):
    """17(b): each of ``COMPILED_HOLDS`` through the serve launcher's
    engine compiled, and an eager engine on the same weights and
    requests, held on tokens."""
    from repro_torch.launch import serve as launcher
    from repro_torch.runtime.engine import ServingEngine
    for what, arch, layers, extra in COMPILED_HOLDS:
        t0 = time.perf_counter()
        with depth_cut(arch, layers, "compiled"):
            argv = ["--arch", arch, "--batch", "8", "--requests", "8",
                    "--prompt-len", str(HOLD_PROMPT), "--gen",
                    str(HOLD_GEN), "--prefill-chunk", "32", "--kv-format",
                    "kv_fp16", "--seed", "0"] + extra
            log_built("compiled", argv)
            engine, reqs = launcher.build(launcher.build_args(argv))
        if engine.proposer is not None:
            reqs = repeat_prompts(engine.cfg.vocab_size, gen=HOLD_GEN)
        eager = ServingEngine(
            dataclasses.replace(engine.cfg, w4a16_plan=None), engine.params,
            max_batch=engine.max_batch, max_prompt_len=engine.max_prompt_len,
            max_new_tokens=engine.max_new_tokens, page_size=engine.page_size,
            prefill_chunk=engine.prefill_chunk, kv_format=engine.kv_format,
            speculate="ngram" if engine.proposer is not None else None,
            spec_k=engine.spec_k, device=dev, compiled=False)
        got = []
        for eng in (engine, eager):
            reset_counts(table)
            rep = eng.run(reqs)
            torch.cuda.synchronize()
            got.append((rep, {k: v for k, v in read_counts(table).items()
                              if v}))
        (c, cl), (e, el) = got
        spec = f"; accepted {c.accepted_tokens}/{c.proposed_tokens} " \
            f"(eager {e.accepted_tokens}/{e.proposed_tokens})" \
            if engine.proposer is not None else ""
        log("compiled", f"{what}: {launcher.steps_line(engine)}; decode "
            f"{c.decode_s / max(len(c.step_records), 1) * 1e3:.2f} ms/step "
            f"compiled, {e.decode_s / max(len(e.step_records), 1) * 1e3:.2f}"
            f" eager (host clock){spec}; run {time.perf_counter() - t0:.1f} "
            f"s [{card}]")
        hold_compiled(c, e, what, (cl, el))
        if engine.proposer is not None and (
                c.proposed_tokens, c.accepted_tokens) != (
                e.proposed_tokens, e.accepted_tokens):
            raise AssertionError(f"{what}: drafts proposed or accepted "
                                 f"differ")
        del engine, eager, got
        torch.cuda.empty_cache()


def compiled_phase(torch, dev, card, table):
    """Phase 17: the compiled serving steps against eager."""
    t0 = time.perf_counter()
    compiled_cell(torch, card, table)
    compiled_holds(torch, dev, card, table)
    log("compiled", f"phase 17 took {time.perf_counter() - t0:.1f} s")


def time_mesh_flash(torch, dev, gen, timer, card):
    """Phase 5's row 7d: the flash forward at phase 14's shard-local
    shapes (``MESH_TRAIN_FLASH``; ``time_flash_shape``)."""
    rows = {}
    for label, B, S, Hq, Hkv, D, causal, window in MESH_TRAIN_FLASH:
        q, k, v = flash_inputs(torch, gen, dev, B, S, S, Hq, Hkv, D,
                               torch.bfloat16)
        rows[label] = time_flash_shape(torch, timer, q, k, v, label, causal,
                                       window, card, "timing")
        del q, k, v
    return rows


_MANGLED = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16",
            "Lb0E": "", "Lb1E": " kv8"}


def ptxas_summary(text):
    """One line per attention-kernel or tensor-core GEMM instantiation of
    an ``-Xptxas -v`` log: ``paged_attn_kernel<bf16, D=80 kv8>: 128
    registers, 16 bytes spill stores, 24 bytes spill loads``,
    ``tc_gemm_kernel<bf16, BM=8, Int4Ring>: ...``."""
    import re
    rows = {}
    name = None
    for line in text.splitlines():
        if "Compiling entry function" not in line:
            if name:
                r = re.search(r"Used (\d+) registers", line)
                sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
                if r:
                    rows[name]["regs"] = r.group(1)
                if sp:
                    rows[name]["spill"] = sp.groups()
            continue
        name = None
        m = re.search(r"(paged_attn_kernel|flash_fwd_kernel)I"
                      r"(f|13__nv_bfloat16|6__half)Li(\d+)E(Lb[01]E)?", line)
        g = re.search(r"tc_gemm_kernelI(13__nv_bfloat16|6__half)Li(\d+)"
                      r"ENS_\d+(\w+?Ring)E", line)
        q = re.search(r"w4a8_gemm_kernelI(f|13__nv_bfloat16|6__half)"
                      r"Li(\d+)E", line)
        o = re.search(r"(quantize_rows_kernel|dequant_w4_kernel|"
                      r"reduce_partials_kernel)I(f|13__nv_bfloat16|6__half)"
                      r"(Li(\d+)E)?", line)
        if q:
            name = (f"w4a8_gemm_kernel<{_MANGLED[q.group(1)]}, "
                    f"BM={q.group(2)}>")
        elif o:
            cpt = f", CPT={o.group(4)}" if o.group(4) else ""
            name = f"{o.group(1)}<{_MANGLED[o.group(2)]}{cpt}>"
        elif m:
            name = (f"{m.group(1)}<{_MANGLED[m.group(2)]}, D={m.group(3)}"
                    f"{_MANGLED[m.group(4) or 'Lb0E']}>")
        elif g:
            name = (f"tc_gemm_kernel<{_MANGLED[g.group(1)]}, "
                    f"BM={g.group(2)}, {g.group(3)}>")
        if name:
            rows[name] = {}
    return [f"{n}: {v.get('regs', '?')} registers, {v['spill'][0]} bytes "
            f"spill stores, {v['spill'][1]} bytes spill loads"
            for n, v in rows.items() if "spill" in v] or ["cached build"]


def layer_totals(torch, gemm_rows, fam_rows, card):
    """The paper's question per layer (its seven GEMMs) at M = 8 and 32:
    fused W4A16 vs the decoupled pipeline vs the dense baseline, with W8A16
    and W4A8 beside them, each against its bound."""
    for M in (8, 32):
        def total(name, key):
            rows = gemm_rows if name == "w4a16_gemm" else fam_rows
            return sum((rows[(M, K, N)] if name == "w4a16_gemm"
                        else rows[(name, M, K, N)])[key]
                       for K, N in LAYER_GEMMS)
        parts = []
        for name in ("w4a16_gemm", "w4a16_decoupled", "dense_gemm",
                     "w8a16_gemm", "w4a8_gemm"):
            parts.append(f"{name} {total(name, 'ms'):.4f} ms (bound "
                         f"{total(name, 'bound_ms'):.4f}, "
                         f"{gbs(total(name, 'nbytes'), total(name, 'ms'))})")
        phases = sum(total(n, "ms") for n in ("dequant_w4", "splitk_gemm",
                                              "reduce_partials"))
        log("timing", f"one layer's 7 GEMMs at M={M}: " + "; ".join(parts)
            + f"; 7 x the timer's floor {7 * gemm_rows['floor_ms']:.4f} ms"
            + f"; decoupled design bound "
            f"{total('w4a16_decoupled', 'design_bound_ms'):.4f} ms, its "
            f"phases timed apart {phases:.4f} ms (phase 1 "
            f"{total('dequant_w4', 'ms'):.4f}, phase 3 "
            f"{total('reduce_partials', 'ms'):.4f}), phase 2 warm "
            f"{total('splitk_gemm', 'warm_ms'):.4f} vs cold "
            f"{total('splitk_gemm', 'ms'):.4f} ms; W4A8 "
            f"{total('w4a8_gemm', 'ms'):.4f} ms (its quantize kernel "
            f"alone {total('w4a8_quantize', 'ms'):.4f}), "
            f"{total('w4a8_gemm', 'serial_ms'):.4f} ms without the GEMM's "
            f"early start [{card}]")


def main() -> int:
    # empty_cache hands freed memory back to the card even where a live
    # tensor shares its segment, so what an earlier phase cached does not
    # stay pinned (phase 14's ranks run beside phase 13 on that room); the
    # spawned ranks inherit it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import costmodel
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log("device", f"{card} ({torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    table = kernel_table()
    t0 = time.perf_counter()
    logs = build.build_all(k for k, _, _ in table.values())
    sources = list(dict.fromkeys(src for _, src, _ in table.values()))
    log("build", f"{' + '.join(sources)} in {time.perf_counter() - t0:.1f} "
        f"s (one nvcc each, in parallel)")
    for name, text in zip(sources, logs):
        if name in ("paged_attention.cu", "flash_attention.cu",
                    "w4a16_gemm.cu", "dense_gemm.cu", "w8a16_gemm.cu",
                    "w4a8_gemm.cu", "w4a16_decoupled.cu"):
            for line in ptxas_summary(text):
                log("build", f"{name}: {line}")
            continue
        regs = sorted({line.split(":", 1)[1].strip()
                       for line in text.splitlines() if "registers" in line})
        log("build", f"{name}: {'; '.join(regs) or 'cached build'}")

    # phase 15's grid needs no card and nothing an earlier phase measures:
    # it traces on the meta device in a process of its own from here on
    grid_job = dryrun_grid_start()
    log("dryrun", "phase 15's grid started in a process of its own (the "
        "meta device, one CPU core)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    errs = {"w4a16_gemm": check_gemm(torch, dev, gen)}
    check_gemm_fp32(torch, dev, gen)
    errs["paged_attention"] = check_attention(torch, dev, gen)
    errs.update(check_family(torch, dev, gen))
    errs["w4a8_gemm"] = max(errs["w4a8_gemm"],
                            check_w4a8_edges(torch, dev, gen))
    errs["w4a8_quantize"] = 0.0         # bit-equal, or phase 3 failed
    errs["flash_attention"] = check_flash(torch, dev, gen)
    check_flash_grads(torch, dev, gen)
    errs["w4a16_gemm_experts"], w8_err = check_moe_gemms(torch, dev, gen)
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_moe_attention(torch, dev, gen))
    check_expert_loops(torch, dev, gen)
    errs["w8a16_gemm"] = max(errs["w8a16_gemm"], w8_err)
    errs["w4a16_gemm"] = max(errs["w4a16_gemm"],
                             check_carry_gemms(torch, dev, gen))
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_carry_attention(torch, dev, gen))
    errs["w4a16_gemm"] = max(errs["w4a16_gemm"],
                             check_p11_gemms(torch, dev, gen))
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_p11_attention(torch, dev, gen))
    errs["w4a16_gemm"] = max(errs["w4a16_gemm"],
                             check_mesh_gemms(torch, dev, gen))
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_mesh_attention(torch, dev, gen))
    errs["w4a16_gemm"] = max(errs["w4a16_gemm"],
                             check_mesh_family_gemms(torch, dev, gen))
    errs["paged_attention"] = max(errs["paged_attention"], check_mesh_attention(
        torch, dev, gen, MESH_FAMILY_ATTN))
    # a whisper 2x2 rank's flash shapes (phase 13's encoder at admit, phase
    # 14's training), drawn last so every earlier case keeps its inputs
    errs["flash_attention"] = max(errs["flash_attention"], check_flash(
        torch, dev, gen, [((label, B, S, S, *rest), False)
                          for label, B, S, *rest in MESH_FAMILY_FLASH]))
    check_flash_grads(torch, dev, gen, [
        (label, S, Hq, Hkv, D, causal, window, True)
        for label, _, S, Hq, Hkv, D, causal, window in MESH_FAMILY_FLASH])
    torch.cuda.synchronize()
    log("kernels", f"phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    paged_run, launches = check_serve(torch, card, table)
    torch.cuda.empty_cache()
    with depth_cut(ARCH, FAMILY_LAYERS, "serve"):
        launches.update(serve_family(torch, card, table))
    log("serve", f"phase 4 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    timer = Timer(torch, dev)
    gemm_rows = time_gemms(torch, dev, gen, timer, card)
    attn_rows = time_attention(torch, dev, gen, timer, card)
    fam_rows = time_family(torch, dev, gen, timer, card)
    layer_totals(torch, gemm_rows, fam_rows, card)
    flash_rows = time_flash(torch, dev, gen, timer, card)
    moe_rows = time_moe_gemms(torch, dev, gen, timer, card)
    time_carry(torch, dev, gen, timer, card, gemm_rows["floor_ms"])
    time_p11(torch, dev, gen, timer, card, gemm_rows["floor_ms"])
    time_mesh(torch, dev, gen, timer, card, gemm_rows["floor_ms"])
    time_mesh_flash(torch, dev, gen, timer, card)
    time_mesh_families(torch, dev, gen, timer, card, gemm_rows["floor_ms"])
    del timer
    torch.cuda.empty_cache()
    log("timing", f"phase 5 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_compare(torch, dev, card, table)
    launches["flash_attention"], step_s = train_launcher(torch, card, table)
    torch.cuda.empty_cache()
    trace_train(torch, dev, card, step_s)
    log("train", f"phase 7 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with depth_cut(ARCH, FEATURE_LAYERS, "features"):
        serve_features(torch, dev, card, table)
    torch.cuda.empty_cache()
    with depth_cut(MOE_ARCH, MOE_LAYERS, "moe"):
        launches["w4a16_gemm_experts"] = moe_serve(
            torch, dev, card, table)["w4a16_gemm_experts"]
    torch.cuda.empty_cache()
    carry_serve(torch, dev, card, table)
    torch.cuda.empty_cache()
    p11_serve(torch, dev, card, table)
    torch.cuda.empty_cache()
    errs["flash_attention"] = max(errs["flash_attention"], train_families(
        torch, dev, card, table))
    torch.cuda.empty_cache()
    # phase 14's ranks start first and train while phase 13 serves and
    # phase 15 traces its one-device cells (when the card has room:
    # ``train_beside``); each rank's peak and launches are its own
    # process's
    train_job = train_beside(torch, card)
    t0 = time.perf_counter()
    mesh_serve(torch, dev, card, table)
    log("mesh", f"phase 13 took {time.perf_counter() - t0:.1f} s"
        + (" (phase 14's ranks training beside it)" if train_job else ""))
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    misses = dryrun_held(torch, card, one_device_cells(torch))
    t15 = time.perf_counter() - t15
    if train_job is None:
        train_job = mesh_train_start(card)
    mesh_train_finish(torch, card, train_job)
    log("mesh-train", f"phase 14 took "
        f"{time.perf_counter() - train_job['t0']:.1f} s from its ranks' "
        f"start")
    t0 = time.perf_counter() - t15
    misses += dryrun_held(torch, card, mesh_cells(torch))
    dryrun_finish(dryrun_grid_wait(grid_job), misses, t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ring_phase(torch, dev, card, table, paged_run)
    del paged_run
    log("ring", f"phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    compiled_phase(torch, dev, card, table)

    # one entry per kernel: a GEMM entry sums one decode step's seven
    # per-layer GEMMs at M=8 (the set a step repeats in each of 24 layers),
    # the expert-batched W4A16 entry one olmoe layer's three expert stacks
    # at M=8 (launches: phase 9's olmoe run);
    # the attention entry is one decode call at B=8 over the served window;
    # the flash entry one forward call at the launcher's 2 x 8192 tokens
    def layer_sum(name, key):
        if name == "w4a16_gemm":
            vals = [gemm_rows[(8, K, N)][key] for K, N in LAYER_GEMMS]
        else:
            vals = [fam_rows[(name, 8, K, N)][key] for K, N in LAYER_GEMMS]
        return None if None in vals else sum(vals)

    def entry(name, **numbers):
        _, src, replaces = table[name]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], **numbers}

    def gemm_entry(name):
        return entry(name, ms=layer_sum(name, "ms"),
                     plain_ms=layer_sum(name, "plain_ms"),
                     bound_ms=layer_sum(name, "bound_ms"),
                     bound_by=costmodel.bound_by(
                         layer_sum(name, "nbytes"), layer_sum(name, "flops"),
                         int8=name == "w4a8_gemm"),
                     library_ms=layer_sum(name, "library_ms"))

    a = attn_rows["decode"]
    f = flash_rows[FLASH_TIMED[-1][0]]        # the launcher's shape
    record = {"kernels": [
        gemm_entry("w4a16_gemm"),
        entry("w4a16_gemm_experts", ms=moe_rows["ms"],
              plain_ms=moe_rows["plain_ms"], bound_ms=moe_rows["bound_ms"],
              bound_by=costmodel.bound_by(moe_rows["nbytes"],
                                          moe_rows["flops"]),
              library_ms=moe_rows["library_ms"]),
        entry("paged_attention", ms=a["ms"], plain_ms=a["plain_ms"],
              bound_ms=a["bound_ms"], bound_by=a["bound_by"],
              library_ms=a["library_ms"]),
        gemm_entry("dense_gemm"), gemm_entry("dequant_w4"),
        gemm_entry("reduce_partials"), gemm_entry("w8a16_gemm"),
        gemm_entry("w4a8_gemm"), gemm_entry("w4a8_quantize"),
        entry("flash_attention", ms=f["ms"], plain_ms=f["plain_ms"],
              bound_ms=f["bound_ms"], bound_by=f["bound_by"],
              library_ms=f["library_ms"]),
    ]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        # one rank of phase 13, started by spawn_mesh
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]),
                           *sys.argv[4:7]))
    if sys.argv[1:2] == ["--mesh-train-rank"]:
        # one rank of phase 14, started by mesh_train_start
        sys.exit(mesh_train_rank(int(sys.argv[2]), int(sys.argv[3]),
                                 *sys.argv[4:7]))
    if sys.argv[1:2] == ["--dryrun-grid"]:
        # phase 15's grid, started by dryrun_grid_start
        sys.exit(dryrun_grid_rank(sys.argv[2]))
    try:
        rc = main()
    finally:
        reap_started()
    sys.exit(rc)
