#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    every kernel of the port from `src/repro_torch/kernels/*/csrc`
              (the dry runs' CPU subprocesses start before it); ptxas
              registers and spills per kernel, when each source's nvcc
              ended, and the tensor-core instructions cuobjdump finds in
              the flash and SSD kernels, mma.sync (HMMA) and wgmma
              (HGMMA) apart, where the toolkit has cuobjdump (run beside
              the phases, counted at the end; a backward kernel without
              either fails, and a wide backward one without HGMMA)
  3. flash    the flash-attention kernel against its plain version at the
              DiT-XL shape (f32 and bf16), a causal GQA shape with a window,
              a ragged shape, a q-at-the-tail shape, the zamba2-2.7b
              prefill shape (bf16, head dim 80), an odd head dim at a
              misaligned storage offset, and the dit-video spatial (B 32 x
              256) and temporal (B 512 x 16) and dit-audio (B 2 x 256, head
              dim 64) shapes in f32, these three gated at 2e-5 with a
              one-pass TF32 control that the gate must reject, and the
              dense LLMs' prefill shapes (bf16, causal, 4 x 512 tokens:
              tinyllama 32 / 4 heads of 64, qwen2-7b 28 / 4 of 128,
              qwen2.5-14b 40 / 8 of 128, minitron-8b 32 / 8 of 128), the
              whisper-small encoder (4 x 1500 frames, 12 heads of 64) and
              cross-attention (448 queries over 1500 keys), and the
              pixtral-12b prefill (2 x 1088 positions, 32 / 8 heads of
              160, causal: the bf16 serving instantiation at D 160), the
              arctic-480b prefill (4 x 512, 56 / 8 heads of 128) and
              deepseek-v2's MLA prefill (4 x 512 and a ragged 4 x 500, 128
              heads of q/k 192 over v 128: the split instantiation, its
              registers and spills from the build log); kernel,
              plain and scaled_dot_product_attention (yardstick only)
              times, and the CUDA kernels SDPA runs at each shape with
              their device time; at the zamba2 shape also SDPA with
              is_causal
  4. flash-bwd the flash backward kernels (Delta, dK/dV, dQ on the tensor
              cores) under autograd, bitwise on a rerun,
              against autograd of the plain version on float64 copies (f32
              1e-4 abs, bf16 2e-2 abs) and the plain backward
              (`attention_bwd_ref`, from the kernel's output and row
              log-sum-exp) against the same, at the DiT-XL shape in f32
              and in bf16 (the full-width train phase's), a causal GQA
              shape with a window, a ragged shape, q longer than k (the
              keyless rows' dq exactly 0), the zamba2 prefill shape, an
              odd head dim, the train-dit example's shape and train-dense's
              (tinyllama, B 8, S 128, GQA group 8, bf16); kernel,
              device and plain times, SDPA forward + backward (yardstick
              only), and the forward with and without its log-sum-exp
  5. forecast the forecast kernel against its plain version, batched over
              serving slots and unbatched at a block-sized shape, f32 and
              bf16, and at the video pool's (2, 3, 65536) and the audio
              pool's (2, 3, 20480) in f32; taylor, hermite and foca
              coefficients (n_valid 0-3), through `forecast` and through
              the fused `forecast_basis`; per-call times of `forecast`
              beside torch.bmm and of `forecast_basis` beside
              basis_coeffs + forecast; one skip tick's operators and
              kernels under the profiler
  6. ssd      the SSD scan kernels (C B^T pass and scan) against their plain
              version at the zamba2 prefill shape (b 4, s 512, h 80, p 64,
              n 64) in f32, as the path passes them (bf16 views of the conv
              output xBC) at b 4 and b 1, and at b 1 with a ragged s = 500;
              kernel, device and plain times
  7. ssd-bwd  the SSD backward kernels (the tile-local states and their
              gradients, the recurrence, the per-tile terms of a head
              group, the sums over groups) against float64 autograd of the
              plain scan
              (1e-4 of each gradient's largest value; a bf16 dx, dB, dC
              within one bf16 rounding more) and the plain VJP
              (`ssd_bwd_ref`), bitwise on a rerun, at the zamba2 prefill
              shape in f32 and on bf16 xBC views with dh_final, the train
              shape (b 8, s 128) on bf16 views and a ragged s = 500 with
              dh_final; kernel, device and plain times and the bound
  8. serve    full-width DiT-XL (28 layers, bf16 params, random weights from
              a seed, AdaLN gates perturbed) behind DiffusionServingEngine
              with TaylorSeer, 4 slots, 8 requests of 8 and 16 steps, two
              guided; every x0 finite, every request's computed steps equal
              its static schedule, flash and forecast launched on this path
  9. serve-adaptive  the same DiT-XL, weights, slots and requests as
              serve, under TeaCache (planned by the device want pass: one
              read a tick) and then FoCa (host plan; forecast kernel on its
              skip ticks); every x0 finite, each request's first step
              computes, its computed steps equal the ticks the plan gave its
              row, TeaCache saves rows; req/s, ticks by kind, tick ms, the
              plan's host ms and device-to-host copies per tick (profiler,
              and the plan's own dispatch as a count of what the profile
              must hold: a profile short of it lost CUPTI records and is
              taken again, three at most), the device's idle share
  10. check    a reduced DiT served on the card (kernels) and on the CPU
              (plain versions) from the same weights and noise under each of
              the 13 policies of slice 5 and TaylorSeer: the same computed
              steps per request and tick kinds (every thresholded decision
              of the CPU reference at least 1e-4 relative from its
              threshold), x0 within 1e-3 relative
  11. serve-cfg serve's DiT-XL under TaylorSeer with FasterCacheCFG(4) on
              the uncond branch, 8 requests of 8 and 16 steps, four guided,
              one with a negative-prompt vector: every x0 finite, each
              request's cond and uncond computed steps equal the two
              schedules, cond-only ticks and saved uncond rows, the vector
              changes its request's x0; the dense engine
              (row_compaction=False) decides the same and its x0 agree
              within 1e-3 relative; with a MetricsRegistry and a TickEvent
              hook the counters agree with the telemetry; req/s with and
              without them; flash and forecast launched on this path
  12. check-cfg the reduced DiT of phase 9 on the card and on the CPU under
              FasterCacheCFG (extrapolate and lowfreq with TaylorSeer,
              TeaCache, the dense engine), guided requests, one with a
              vector: the same (cond, uncond) computed steps and tick
              kinds, x0 within 1e-3 relative; the plan's device-to-host
              copies per tick from the profiler (1 under TeaCache, 0 with
              two step-only branches)
  13. serve-diffusion  examples/torch_serve_diffusion.py's `run` on
              serve's DiT-XL: the SLA autotuner per traffic class, the
              per-class serving and the guided FasterCacheCFG pool; each
              class's pick, PSNR (against the exact trajectory on random
              weights: no quality measure), compute fraction, req/s and
              latency p50/p95, the pool's tick mix and saved uncond rows
  14. serve-video full-width, full-depth dit-video (28 layers, d_model 1152,
              16 frames x 256 patches, bf16 params from seed 0, AdaLN gates
              perturbed) behind DiffusionServingEngine(slots=2,
              max_steps=16), 4 unguided requests of 8 and 16 steps, under
              TaylorSeer (forecast kernel on its skip ticks) and then
              teacache_video (frames 16, max; the device want pass with 1
              DtoH a tick, counted from the profiler and the plan's
              dispatch); 56 flash launches per
              backbone pass (28 spatial + 28 temporal); req/s, latency,
              ticks by kind, rows, peak memory, idle share
  15. denoise-video CachedDenoiser on the same model, batch 1, 16 DDIM
              steps: exact, pab_video, block under FORA 2, deepcache under
              Δ-DiT 2 (shallow_n 4); ms per step, compute fraction, relative
              L2 error of x0 against exact
  16. check-video dit-video SMOKE on the card and on the CPU from the same
              weights: served under teacache_video and TaylorSeer (the same
              decisions and tick kinds, x0 within 1e-3 relative), and
              CachedDenoiser under pab_video, block and deepcache (x0 within
              1e-3 relative)
  17. serve-mixed examples/torch_mixed_modality_serving.py's `run` on
              full-width dit-xl, dit-video and dit-audio: autotune per
              modality (the video sweep adds teacache_video), then the
              example's 9 requests through MixedModalityEngine, 2 slots a
              pool, image requests guided under FasterCacheCFG(4, 12);
              each pool's pick, autotune seconds, req/s, rows and
              token-weighted rows, latency
  18. serve-t2i examples/torch_text_to_image_serving.py's `run` on
              full-width dit-t2i (28 layers, d_model 1152, 77 text tokens,
              bf16 params from seed 0, every AdaLN gate perturbed, the
              cross branch's too) with a full-width text encoder (d 1152, 2
              layers, 4 heads): 6 prompts (3 unique) and a negative prompt
              under TeaCache 0.1 + FasterCacheCFG(4, 12), 2 slots; the same
              queue again tick by tick (computed steps = the plan's rows);
              then 8 prompted requests of 8 and 16 steps under TaylorSeer
              + FasterCacheCFG(4), 4 slots, four guided, one negative
              prompt.  Encoder runs = unique prompts, text-table builds =
              admission waves = text_kv calls (none in a tick), 28 flash
              launches a backbone pass, forecast on the skip ticks, two
              prompts give two x0; req/s, latency, ticks against
              serve-cfg's, the cross-attention's share of device time
              (profiler), peak memory, idle share; the cross-attention
              core against masked SDPA (yardstick) at the 8-row shape
  19. check-text dit-t2i and dit-t2v SMOKE with their text encoders on the
              card and the CPU, the same weights, prompts and noise: under
              TeaCache + FasterCacheCFG(3) and TaylorSeer the same
              decisions, tick kinds, text-table builds and encoder runs
              (every thresholded decision >= 1e-4 relative from its
              threshold first), x0 within 1e-3 relative; the prompt-less
              and all-masked forwards bit-identical on the card to the
              forward without the cross branch
  20. serve-t2v full-width dit-t2v (dit-video's 28 layers, 16 frames x 256
              patches, with the cross branch), 2 slots, 4 prompted requests
              of 8 and 16 steps under TaylorSeer: 56 flash launches a
              backbone pass, the same text checks, req/s, latency,
              cross-attention share, idle share, peak; CachedDenoiser
              exact against pab_video (cross_attn at range 6), 16 steps:
              ms a step, branch compute fraction, x0's relative L2 error;
              the cross-attention core against masked SDPA at (2, 4096)
  21. control examples/torch_online_control_plane.py's `run` on serve's
              full-width DiT-XL: SmoothCache calibrated at 16 steps (profile,
              schedule, compute fraction); the OnlineTuner over the
              example's menu (none, teacache 0.06, fora 2, blockcache 0.05
              and 0.2 on the profile), 4 slots, 12 requests of 8 and 16
              steps, retuning every 6 ticks; a SignalTraceLog's probes
              replayed into teacher pairs and fit_want_gate for 120 steps
              on the card (the loss must fall); then a second tuner with one
              swap forced to TaylorSeer (2, 1) at tick 6 (every request
              keeps the computed steps of the policy that admitted it), and
              the learned gate served on the compacted and the dense engine
              (equal computed steps, x0 within 5e-4 abs + 1e-3 rel); sweep
              seconds, swaps, the window's row and plan times and
              occupancy, req/s, the training seconds and losses
  22. observability examples/torch_observability.py's `run` on full-width
              DiT-XL and dit-video (2 slots a pool, 8 requests, TeaCache,
              FasterCacheCFG(4, 8) on the image pool): each program's
              first-run seconds and FLOPs, flops_per_row against the hand
              count 24 d^2 T L + 4 T^2 d L (within 5 %), each pool's
              redundancy ratio; trace.json must validate and the
              cache-event JSONL must equal telemetry's computed and uncond
              steps exactly; req/s with the hooks against without them
              (reported, not gated)
  23. check-control a reduced DiT on the card and on the CPU: the forced-
              swap tuner run (identical computed steps, x0 within 1e-3
              relative), the program profiles' FLOPs (identical per
              program) and fit_want_gate from one initial gate (loss
              history within 1e-4 relative)
  24. serve-llm full-width zamba2-2.7b (54 Mamba2 layers, 9 shared attention
              applications, bf16 params, random weights from a seed) behind
              ServingEngine, 4 slots, 8 greedy requests of 64-500 prompt
              tokens, 32 new tokens each; every logit finite, SSD launched
              54 times and flash 9 times per prefill; tok/s, prefill ms,
              decode ms per step, peak memory, device time by kernel
  25. check-llm the zamba2 SMOKE config served on the card (kernels) and on
              the CPU (plain versions) from the same weights and prompts
              must give the same tokens and close logits
  26. train   full-width DiT-XL (28 layers, d_model 1152, 256 tokens, 1000
              classes, bf16 params from seed 0) trained through
              launch/train.py's `train`: AdamW, the cosine schedule (warmup
              0), clipping, batch 8, 8 steps, a checkpoint every 4.  Every
              loss finite, every leaf moves, 28 forward and 28 backward
              flash launches a step; restored from step 4 and rerun to step
              8, the state equals the uninterrupted run's (bitwise, or the
              largest relative difference within 1e-4); one more step
              profiled (device ms of the forward, backward and optimizer
              between CUDA events at their edges, the idle share, the flash
              backward's share); one backward on gate-perturbed params
              gives every leaf, and wq, wk, wv of every layer, a finite
              non-zero gradient; checkpoint save and restore seconds, peak
  27. train-dit examples/torch_train_dit.py's `run` at its defaults (~130M
              params, batch 16, 300 steps): the loss falls, the checkpoint
              restores, the TaylorSeer-cached sample is finite; steps/s
  28. check-train DiT-XL SMOKE (f32) trained 3 steps on the card (kernels)
              and on the CPU (plain versions) from the same weights and
              injected draws: losses, params and moments within 1e-4
              relative; ssd_scan under grad differentiates on the card
  29. train-llm full-width zamba2-2.7b (2,422,670,240 bf16 params) trained
              through launch/train.py's `train` at batch 8 x seq 128 for 4
              steps: finite losses and grad norms, 54 SSD scans, 54 SSD
              backward launches and 9 flash forward and backward launches
              a step; ms a step over two more steps, one profiled step
              split into forward / backward / optimizer, the SSD
              backward's share of kernel time, peak memory
  30. check-train-llm zamba2 SMOKE (f32) trained 3 steps at seq 100 on the
              card and on the CPU (losses, params and moments within 1e-4
              relative, the SSD backward launched on the card); a run
              resumed from the launcher's step-2 checkpoint on the card
              bitwise equal to the uninterrupted one
  31. serve-dense full-width tinyllama-1.1b behind ServingEngine with
              serve-llm's traffic (4 slots, 8 greedy requests of 64-500
              prompt tokens, 32 new tokens), then qwen2-7b, qwen2.5-14b and
              minitron-8b one at a time, each dropped before the next, 4
              requests x 16 tokens; every logit finite, one flash launch a
              layer a prefill; tok/s, prefill ms, decode ms a step, peak
  32. check-dense tinyllama and qwen2-7b SMOKE on the card and the CPU:
              identical greedy tokens, prefill and decode logits within
              1e-4 abs; one tinyllama train step within 1e-4 relative
  33. train-dense full-width tinyllama-1.1b trained as train-llm: 22 flash
              forward and backward launches a step
  34. dlm     examples/torch_diffusion_lm.py's `run` on full-width
              tinyllama-1.1b: B 2, S 64, 8 steps, exact, FORA 2 and
              TaylorSeer 2 (8, 4 and 4 full computes, 2 x 22 flash launches
              each, the forecast kernel on TaylorSeer's forecast steps, no
              mask left); ms a generation
  35. serve-ssm full-width falcon-mamba-7b (64 Mamba1 layers, d_inner 8192,
              bf16 params from seed 0) behind ServingEngine with
              serve-llm's traffic; attention-free and its scan plain
              PyTorch, so no kernel runs (every count must stay 0); every
              logit finite; tok/s, prefill ms, decode ms a step, peak, the
              Mamba1 scan's share of a prefill's device time (CUDA events
              at the edges of each scan) and the idle share (profiler)
  36. check-ssm falcon-mamba-7b SMOKE (f32) on the card and the CPU: the
              forward's, a prefill's and 4 decode steps' logits within
              1e-4 relative, greedy and ServingEngine tokens identical,
              `lm_loss`'s gradients within 1e-4 relative per leaf
  37. serve-encdec full-width whisper-small (12 + 12 layers, bf16): 4
              requests of (1500, 768) stub frames, `encode` (12 flash
              launches), one `cross_kv`, 32 greedy `decode_step`s (no
              flash, no (6000, 768) x (768, 768) product in a step, which
              one cross_kv shows 24 of, from the profiler's shapes); every
              logit finite; encode, cross_kv and decode ms, peak; the
              teacher-forced `forward` at 448 tokens (36 flash launches)
  38. check-encdec whisper-small SMOKE (f32) on the card and the CPU:
              forward and 12 decode steps' logits within 1e-4 relative,
              greedy tokens identical, the token cross-entropy's gradients
              within 1e-4 relative per leaf; on the card, decoding against
              the cached cross K/V bit-identical to recomputing them
  39. serve-vlm full-width pixtral-12b (40 layers, head dim 160, bf16): 2
              requests of (1024, 1024) stub patch embeddings and 16-64 text
              tokens, `prefill` with vision_embeds (40 flash launches, all
              of the D 160 kernel by the profiler's kernel names), 32
              greedy `decode_step`s; every logit finite; prefill and
              decode ms, peak
  40. check-vlm pixtral-12b SMOKE (f32) with patch embeddings on the card
              and the CPU, as check-ssm without the engine
  41. serve-moe arctic-480b (2 of its 35 layers) and then
              deepseek-v2-236b (8 of 60) at full width (published widths,
              experts, top-k, capacity factor and MLA ranks; bf16 params,
              f32 routers, random weights from seed 0; the depth cut
              because neither fits one card, logged with the sizes),
              behind ServingEngine: 4 slots, 4 greedy requests of 64-500
              prompt tokens (max_prompt 512), 16 new tokens; every logit
              finite, one flash launch a layer a prefill (deepseek's all
              of the split 192-over-128 kernel by the profiler's names);
              tok/s, prefill and decode ms, peak under the card's, the
              MoE's share of a prefill's and a decode step's device time
              (CUDA events at its edges), the (token, choice) pairs
              dropped past capacity, the idle share
  42. check-moe arctic-480b and deepseek-v2-236b SMOKE (f32) on the card
              and the CPU: forward, prefill and decode logits and
              ServingEngine's tokens (as check-ssm), the forward's MoE
              losses, each layer's routing at capacity factors 8 and 0.5
              identical (once every top-k margin is >= 1e-4 relative),
              lm_loss and its MoE terms within 1e-5, its gradients within
              1e-4, and one AdamW step (the step from the same gradients
              and its moments within 1e-4)
  42b. any-kernels the general units (any head dim, dtype and alignment;
              any SSD p and n) against their plain versions: the flash
              forward (serving and with the row log-sum-exp) at pixtral's
              f32 shape (2 x 1088, 32 / 8 heads of 160), the MLA's in f32
              (4 x 512, 128 heads, 192 over 128), the prompt encoder's
              (8 x 77, 4 heads of 288), Gemma-7B's (2 x 1024, 16 heads of
              256) in bf16 and f32, D 200 in f32 and D 136 in bf16 one
              element off 16 bytes, 2e-5 abs in f32 and one bf16 rounding;
              each backward against float64 autograd, 1e-4 abs in f32 and
              2e-2 past one rounding in bf16, bitwise on a rerun; the SSD
              scan at zamba2's n 128 (b 4, s 512, h 80, p 64) on bf16 xBC
              views and in f32 and at a ragged (1, 500, 4, p 96, n 160)
              against the plain version in float64 (2e-4 + 1e-3 rel), its
              backward against float64 autograd (1e-4 of each gradient's
              largest value, bf16 outputs one rounding more); ms, device
              ms, the plain version's and SDPA's times (its backend's
              kernels by name), bounds, registers and spills
  42c. any-paths pixtral-12b with f32 params at full width (4 of 40
              layers): a prefill of 2 x (1024 patches + 64 tokens) and 8
              decode steps, then 3 steps of train_loop(jit=True);
              deepseek-v2-236b with f32 params (1 of 60 layers): a prefill
              and lm_loss with its gradients at 2 x 512; zamba2-2.7b at
              ssm_state 128 (one hybrid group, 6 of 54 layers): a prefill
              and lm_loss with its gradients at 4 x 512; each general unit
              launched once a layer where its path runs it
  42d. check-any pixtral-12b (head dim 160), deepseek-v2's MLA (192 over
              128, every expert chosen) and zamba2 (ssm_state 128) SMOKE
              with f32 params on the card and the CPU: logits, lm_loss and
              every gradient within 1e-4 relative, through the general
              units
  43. verify  the port's analysis (`repro_torch.analysis`) on the card: the
              lint of src/repro_torch with every rule (the ir-* rules on
              the card: the golden engines verified and served under the
              retrace sentinel, the train step's donation, the launch lint)
              exits 0; the launch lint's plan of every C launch site at the
              main paths' shapes, one line each (registers, spill bytes,
              shared memory, threads, grid, active blocks per SM); two
              full-width DiT-XL engines of 4 slots (TeaCache with
              FasterCacheCFG, and TaylorSeer, whose skip ticks forecast)
              give `warmup(verify=True)` no finding (its cost against a
              plain warmup logged) and serve 8 requests under a
              RetraceSentinel with 0 builds, loads and cold programs and a
              live selftest; a `.item()` injected into one tick fires both
              sync channels (the operator record and torch's sync debug
              mode), a `.cpu()` the copy channel; `train_loop(...,
              verify_donation=True)` runs 2 steps of full-width DiT-XL at
              batch 8 with every leaf updated in place
  43b. graphs every program captured per shape key in CUDA graphs against
              the same work run eagerly: full-width DiT-XL under TaylorSeer
              and under TeaCache + FasterCacheCFG(4) (4 slots, 8 requests)
              and dit-t2i prompted with FasterCacheCFG(4), each a warmed
              engine (graphs) against an unwarmed one: x0 bitwise (else
              within 1e-5 relative), computed steps, rows, tick kinds and
              plan decisions identical, equal launches, 0 builds, captures
              or cold programs under a RetraceSentinel around the warmed
              engine's ticks, tick ms and idle share both ways, capture
              seconds per key, graphs and pool bytes, the prompt encoder
              captured and replayed; zamba2-2.7b and tinyllama-1.1b
              behind ServingEngine with and without capture: greedy tokens
              equal to a plain prefill / decode_step loop, no capture in a
              second generate, decode ms a step, idle share and peak
              memory both ways; DiT-XL trained 8 steps by
              train_loop(jit=True) against jit=False: params within 1e-4
              relative, equal launches, ms a step and idle share both ways
  44. dist    a world-size-1 NCCL process group on the card
              (`tcp://localhost`, a free port; no gloo fallback):
              `make_host_mesh()` and a (1, 1, 1) ("data", "attn", "ffn")
              mesh on "cuda"; full-width qwen2-7b (bf16, seed 0) prefill's
              forward over 4 x 512 tokens with DTensor params from
              `params_sharding` and batch-sharded tokens, then full-width
              DiT-XL's denoiser step at batch 8 the same way: logits / eps
              and the K/V within 1e-4 relative of the unsharded forward of
              the same weights (the difference logged; 0 expected); the
              collectives CommDebugMode counts; the flash launches on
              local shards; the prefill's device memory above its
              arguments
  45. dist-moe deepseek-v2-236b at full width cut to 2 of its 60 layers,
              on the (1, 1, 1) mesh: the first layer's MoE through
              `moe_forward_ep` (NCCL's all_to_all_single on the 1-rank ep
              group) against `moe_forward` on the same input, every
              token's top-k margin >= 1e-4 relative asserted first: y, the
              losses and the drops within 1e-5; then `transformer.forward
              (..., ep=...)` on DTensors against the unsharded forward
              (logits and aux within 1e-5; the MLA prefill's split flash
              kernel on local shards)
  46. dryrun  `python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
              --shape train_4k` in a subprocess (the CPU, by design: fake
              process group at 256 ranks, fake tensors, this machine's
              torch): status ok, the roofline, fits 80 GB; and qwen2-7b's
              prefill at 4 x 512 traced the same way on a (1, 1, 1) fake
              world: its bytes per device beside the dist phase's (both
              started before the build); it waits for the subprocesses,
              so perf-dit's times do not share the host with them
  47. perf-dit the three variants of `launch/perf_dit.py` (uncached,
              TaylorSeer refresh, the static skip) at full width on the
              card at decode_32k's per-rank batch on dit-xl's logical mesh
              (128 over data 32 = 4): CUDA-event ms per variant (the
              median of 4 rounds of 10 calls, the variants in turns) and
              the amortised N = 4 ms, beside the dry run's per-rank roofline
              terms of the same variant (the perf_dit CLI, run on the CPU
              in a subprocess started before the build); the forecast
              launches of the skip

Each served phase sets every launch count to 0 just before it and reads the
counts just after (each wrapper's and each C entry point's); every phase builds the models it serves and drops them
at its end, and logs its wall seconds and its own peak device memory.  It
then prints a `kernels` JSON line (each row's launches on each path are
those of its C entry points), the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Needs one CUDA card; it
imports nothing of JAX.

    python3 chip_smoke.py --flash-only
    python3 chip_smoke.py --graphs-only

run phases 1-4 alone (a quick check of the flash kernels), or the build,
forecast and graphs phases alone; neither prints a result line.
"""
from __future__ import annotations

import atexit
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, dense peaks:
PEAK_FLOPS = {"float32": 67e12,  # f32 outside the tensor cores
              "bfloat16": 989e12,
              # f32-accurate products on the tensor cores: 3xTF32 (big*big +
              # big*small + small*big) is three TF32 products at 495 TFLOP/s.
              # The flash kernel and the SSD scan run their f32 products so.
              "float32_3xtf32": 495e12 / 3,
              # ... and two where one operand is a bf16 value, exact in TF32
              # (the SSD scan on the path's bf16 x, B and C)
              "bf16_x_f32_2xtf32": 495e12 / 2}
SSD_KERNELS = ("ssd_cb_kernel", "ssd_scan_kernel")   # one ssd_scan call
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # flash: max |kernel - plain|
LSE_TOL = 1e-3     # the training forward's row log-sum-exp, abs (f32 sums)
MLA_DV = 128       # deepseek-v2's v head dim under q/k's 192 (the mla cases)
# flash at the video and audio DiTs' shapes: a few times the largest error
# of sound runs (5.96e-6 spatial, 3.34e-6 temporal), below what a one-pass
# TF32 kernel gives there (tf32_control, logged and checked per case)
CASE_TOL = {"dit-video spatial": 2e-5, "dit-video temporal": 2e-5,
            "dit-audio": 2e-5}
SSD_TOL = dict(atol=2e-4, rtol=1e-3)       # ssd: chunk invariance
LLM_LOGIT_TOL = 1e-4                       # check-llm: f32 logits, card vs CPU


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile(torch, fn):
    """Run fn() under torch.profiler; returns (key averages, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def device_ms(torch, fn, kernels, reps: int = 20):
    """Mean device time per call of fn() of every CUDA kernel whose name
    contains one of `kernels` (a name or a tuple of names), summed over the
    kernels one call launches and divided by the calls, from a profiled run
    of `reps` calls (None if the profiler saw no device time)."""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    evts, _ = profile(torch, lambda: [fn() for _ in range(reps)])
    hits = [e for e in evts if any(k in e.key for k in kernels)
            and _self_device_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    if not hits:
        return None
    return sum(_self_device_us(e) for e in hits) / 1e3 / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tf32(torch, x):
    """x (f32) rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_control(torch, q, k, v):
    """Non-causal attention with each product's operands rounded once to
    TF32 (q, k; P, v) and summed in f32: what the flash kernel would give
    with one TF32 pass in place of its 3xTF32 split."""
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (_tf32(torch, t.float().transpose(1, 2)) for t in (q, k, v))
    p = torch.softmax(qt @ kt.transpose(-1, -2) * scale, dim=-1)
    return (_tf32(torch, p) @ vt).transpose(1, 2)


def phase_flash(torch, F):
    from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention, ops)
    cases = [  # name, B, Sq, Sk, H, KH, D, causal, window, dtype, offset
        ("dit-xl f32", 8, 256, 256, 16, 16, 72, False, 0, "float32", 0),
        ("dit-xl bf16", 8, 256, 256, 16, 16, 72, False, 0, "bfloat16", 0),
        ("causal gqa window", 2, 512, 512, 8, 2, 64, True, 128, "float32", 0),
        ("ragged 77", 2, 77, 77, 4, 4, 72, True, 0, "float32", 0),
        ("q tail of k, d128", 1, 128, 256, 4, 1, 128, True, 64, "bfloat16", 0),
        ("zamba2 prefill", 4, 512, 512, 32, 32, 80, True, 0, "bfloat16", 0),
        # 72-byte rows at a 4-byte storage offset: element-by-element staging
        ("odd d, misaligned", 2, 100, 160, 4, 2, 18, True, 48, "float32", 1),
        # the video and audio DiTs' shapes (serve-video's 2 rows): spatial
        # B*F sequences of P = 256, temporal B*P sequences of F = 16
        ("dit-video spatial", 32, 256, 256, 16, 16, 72, False, 0, "float32",
         0),
        ("dit-video temporal", 512, 16, 16, 16, 16, 72, False, 0, "float32",
         0),
        ("dit-audio", 2, 256, 256, 12, 12, 64, False, 0, "float32", 0),
        # the dense LLMs' prefill (serve-dense: 4 slots x 512 tokens, bf16,
        # causal): GQA groups of 8, 7, 5 and 4 at head dims 64 and 128
        ("tinyllama prefill", 4, 512, 512, 32, 4, 64, True, 0, "bfloat16", 0),
        ("qwen2-7b prefill", 4, 512, 512, 28, 4, 128, True, 0, "bfloat16", 0),
        ("qwen2.5-14b prefill", 4, 512, 512, 40, 8, 128, True, 0, "bfloat16",
         0),
        ("minitron-8b prefill", 4, 512, 512, 32, 8, 128, True, 0, "bfloat16",
         0),
        # whisper-small's encoder (4 requests x 1500 frames) and its
        # decoder's cross-attention at Whisper's 448-token context; the
        # pixtral-12b prefill (1024 patches + 64 text tokens) at head dim
        # 160, the bf16 serving path's one instantiation above 128
        ("whisper encoder", 4, 1500, 1500, 12, 12, 64, False, 0, "bfloat16",
         0),
        ("whisper cross", 4, 448, 1500, 12, 12, 64, False, 0, "bfloat16", 0),
        ("pixtral prefill", 2, 1088, 1088, 32, 8, 160, True, 0, "bfloat16",
         0),
        # the moe family's prefill (serve-moe: 4 slots x 512 tokens): arctic
        # GQA 56 / 8 heads of 128; deepseek-v2's MLA, 128 heads of q/k 192
        # over v 128 (MLA_DV), the split instantiation, and a ragged S 500
        ("arctic prefill", 4, 512, 512, 56, 8, 128, True, 0, "bfloat16", 0),
        ("mla prefill", 4, 512, 512, 128, 128, 192, True, 0, "bfloat16", 0),
        ("mla ragged 500", 4, 500, 500, 128, 128, 192, True, 0, "bfloat16",
         0),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype, offset):
        flat = torch.randn((math.prod(shape) + offset,), generator=gen,
                           device="cuda").to(dtype)
        return flat[offset:].view(shape)

    report = None
    for name, B, Sq, Sk, H, KH, D, causal, window, dt, offset in cases:
        dtype = getattr(torch, dt)
        Dv = MLA_DV if name.startswith("mla") else D
        q = randn((B, Sq, H, D), dtype, offset)
        k = randn((B, Sk, KH, D), dtype, offset)
        v = randn((B, Sk, KH, Dv), dtype, offset)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if out.dtype != dtype or out.shape != q.shape[:3] + (Dv,):
            fail(f"flash {name}: got {out.dtype} {tuple(out.shape)}")
        err = float((out.float() - ref.float()).abs().max())
        tol = CASE_TOL.get(name, TOL[dt])
        ok = err <= tol
        control = None
        if name in CASE_TOL:
            control = float((tf32_control(torch, q, k, v)
                             - ref.float()).abs().max())
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=causal,
                                                    window=window))
        dev_ms = device_ms(torch, lambda: flash_attention(
            q, k, v, causal=causal, window=window), "flash_fwd")
        plain_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                        window=window), reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if causal or window:
            qp = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= kp <= qp
            if window:
                mask &= qp - kp < window
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=KH != H)
        lib_ms = cuda_ms(torch, sdpa)
        # the work these inputs need: the unmasked (query, key) pairs only
        pairs = Sq * Sk if mask is None else int(mask.sum())
        nbytes = (B * Sq * H + B * Sk * KH) * (D + Dv) * q.element_size()
        peak = PEAK_FLOPS["float32_3xtf32" if dt == "float32" else dt]
        b_ms, by = bound(nbytes, 2.0 * B * H * pairs * (D + Dv), peak)
        log(f"flash {name}: B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} D={D} "
            + (f"Dv={Dv} " if Dv != D else "") +
            f"causal={causal} window={window} {dt}: max_abs_err={err:.3e} "
            f"(tol {tol}) ms={ms:.4f} device_ms={dev_ms} "
            f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({by})")
        kernels, sdpa_dev_ms = sdpa_kernels(torch, sdpa)
        log(f"flash {name}: sdpa device_ms={sdpa_dev_ms:.4f} runs {kernels}")
        if not ok:
            fail(f"flash {name}: max_abs_err {err} > {tol}")
        if control is not None:
            log(f"flash {name}: one-pass TF32 control max_abs_err="
                f"{control:.3e} (must exceed the gate {tol})")
            if not control > tol:
                fail(f"flash {name}: the gate {tol} does not reject one-pass "
                     f"TF32 ({control:.3e})")
        if report is None:       # the DiT main path's shape and type
            report = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                      "device_ms": dev_ms, "shape": name,
                      "tolerance": f"{TOL[dt]} abs"}
        if name.startswith("dit-video") or name == "dit-audio":
            report[name] = {"ms": ms, "device_ms": dev_ms,
                            "max_abs_err": err, "tolerance": f"{tol} abs",
                            "tf32_control_err": control, "bound_ms": b_ms,
                            "bound_by": by, "library_ms": lib_ms,
                            "library_device_ms": sdpa_dev_ms}
        lse_row = {}
        if name in ("pixtral prefill", "mla prefill"):
            # the training forward (kLse) at the same shape: o and the rows'
            # log-sum-exp against the plain versions, ms with and without it
            lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
            scale = 1.0 / math.sqrt(D)
            entry = route_entry(ops, q, k, v, True)
            o_l = ops._forward(q, k, v, causal, window, scale, lse, entry)
            lse_ref = attention_lse_ref(q, k, causal=causal, window=window)
            torch.cuda.synchronize()
            o_err = float((o_l.float() - ref.float()).abs().max())
            lse_err = float((lse - lse_ref.float()).abs().max())
            lse_ms = cuda_ms(torch, lambda: ops._forward(
                q, k, v, causal, window, scale, lse, entry))
            lse_dev = device_ms(torch, lambda: ops._forward(
                q, k, v, causal, window, scale, lse, entry), "flash_fwd")
            log(f"flash {name}: the training forward (kLse): "
                f"max_abs_err={o_err:.3e} (tol {tol}), lse max_abs_err="
                f"{lse_err:.3e} (tol {LSE_TOL}), ms={lse_ms:.4f} device_ms="
                f"{lse_dev} against ms={ms:.4f} without the lse")
            if not (o_err <= tol and lse_err <= LSE_TOL):
                fail(f"flash {name}: the kLse forward is off ({o_err}, "
                     f"{lse_err})")
            lse_row = {"fwd_with_lse_ms": lse_ms,
                       "fwd_with_lse_device_ms": lse_dev,
                       "lse_max_abs_err": lse_err}
            del lse, o_l, lse_ref
        if name.startswith(("whisper", "pixtral")):
            report[name] = {"ms": ms, "device_ms": dev_ms, "max_abs_err": err,
                            "tolerance": f"{tol} abs", "bound_ms": b_ms,
                            "bound_by": by, "plain_ms": plain_ms,
                            "library_ms": lib_ms,
                            "library_device_ms": sdpa_dev_ms, **lse_row}
        elif name.startswith(("arctic", "mla")):
            report.setdefault("moe", {})[name] = {
                "ms": ms, "device_ms": dev_ms, "max_abs_err": err,
                "tolerance": f"{tol} abs", "bound_ms": b_ms, "bound_by": by,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_device_ms": sdpa_dev_ms, "library_kernels": kernels,
                **lse_row}
        elif name.endswith(" prefill") and name != "zamba2 prefill":
            report.setdefault("dense", {})[name] = {
                "ms": ms, "device_ms": dev_ms, "max_abs_err": err,
                "bound_ms": b_ms, "bound_by": by, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": sdpa_dev_ms}
        if name == "zamba2 prefill":   # the same function as is_causal
            def sdpa_causal():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            c_ms = cuda_ms(torch, sdpa_causal)
            c_kernels, c_dev_ms = sdpa_kernels(torch, sdpa_causal)
            log(f"flash {name}: sdpa is_causal ms={c_ms:.4f} device_ms="
                f"{c_dev_ms:.4f} runs {c_kernels}")
            report["zamba2"] = {"ms": ms, "device_ms": dev_ms,
                                "max_abs_err": err, "bound_ms": b_ms,
                                "library_ms": lib_ms,
                                "library_is_causal_ms": c_ms,
                                "library_is_causal_device_ms": c_dev_ms}
    usage = ptxas_usage(SPLIT_KERNEL)
    log(f"flash: the split instantiation (bf16, q/k 192 over v 128): "
        f"registers, spill store and load bytes {usage}")
    if usage is None:
        fail("flash: ptxas reported no split (192 over 128) instantiation")
    report["moe"]["split_registers_spills"] = usage
    report["wide_lse_registers_spills"] = {
        tag: ptxas_usage(tag) for tag in WIDE_LSE_KERNELS}
    log(f"flash: the kLse instantiations above 128 (160; 192 over 128): "
        f"registers, spill store and load bytes "
        f"{report['wide_lse_registers_spills']}")
    if None in report["wide_lse_registers_spills"].values():
        fail("flash: ptxas reported no kLse instantiation above 128")
    return report


def route_entry(ops, q, k, v, grad: bool) -> str:
    """The forward entry the wrapper routes q, k, v to (the one that also
    writes the rows' log-sum-exp under grad)."""
    D, Dv = q.shape[-1], v.shape[-1]
    return ops.route(q.dtype, D, Dv, ops.aligned16(D, Dv, (q, k, v)),
                     grad).forward


def sdpa_kernels(torch, fn, reps: int = 3):
    """The two CUDA kernels that take most of fn()'s device time, from the
    profiler, and the device milliseconds of all its kernels per call."""
    evts, _ = profile(torch, lambda: [fn() for _ in range(reps)])
    kern = sorted((e for e in evts if _self_device_us(e) > 0
                   and str(e.device_type).endswith("CUDA")),
                  key=_self_device_us, reverse=True)
    dev_ms = sum(_self_device_us(e) for e in kern) / 1e3 / reps
    return "; ".join(f"{e.key[:120]} x{e.count}" for e in kern[:2]), dev_ms


# flash-bwd: the backward kernels (f32 1e-4 abs as the forward, bf16 2e-2
# abs) against autograd of the plain version on float64 copies
BWD_CASES = [  # name, B, Sq, Sk, H, KH, D, Dv, causal, window, dtype
    ("dit-xl f32", 8, 256, 256, 16, 16, 72, 72, False, 0, "float32"),
    # the full-width train phase's shape: JAX's step casts x_t to cfg.dtype
    ("dit-xl bf16 (train)", 8, 256, 256, 16, 16, 72, 72, False, 0,
     "bfloat16"),
    ("causal gqa window", 2, 512, 512, 8, 2, 64, 64, True, 128, "float32"),
    ("ragged 77", 2, 77, 77, 4, 4, 72, 72, True, 0, "float32"),
    # q longer than k, causal: the first 32 rows see no key
    ("fully masked rows", 1, 64, 32, 2, 2, 16, 16, True, 0, "float32"),
    ("zamba2 prefill", 4, 512, 512, 32, 32, 80, 80, True, 0, "bfloat16"),
    ("odd d", 2, 100, 160, 4, 2, 18, 18, True, 48, "float32"),
    # examples/torch_train_dit.py's ~100M model (f32 params)
    ("train-dit f32", 16, 64, 64, 12, 12, 64, 64, False, 0, "float32"),
    # train-dense: tinyllama-1.1b at batch 8 x seq 128, GQA group 8 summed
    ("tinyllama train (gqa 8)", 8, 128, 128, 32, 4, 64, 64, True, 0,
     "bfloat16"),
    # train-wide: pixtral-12b at 2 x (1024 patches + 64 tokens), 32 / 8
    # heads of 160 (GQA group 4 summed), and deepseek-v2's MLA at 4 x 512,
    # 128 heads of q/k 192 over v 128: flash_attention_bwd_wide.cu
    ("pixtral train (d 160)", 2, 1088, 1088, 32, 8, 160, 160, True, 0,
     "bfloat16"),
    ("mla train (192 over 128)", 4, 512, 512, 128, 128, 192, 128, True, 0,
     "bfloat16"),
]
BWD_MAIN = "dit-xl bf16 (train)"     # the kernels line's row
BWD_WIDE = ("pixtral train (d 160)", "mla train (192 over 128)")
# an older tree's backward kernels' device times at these shapes
# are not taken here: the parent's source is not in a checkout.  The A/B
# tool builds both trees' kernels and times them in turns on one card.
PARENT_AB = {k: f"not measured here: python3 tools/flash_fwd_ab.py "
                f"--kernel {k} --src <parent>/src --src src (PERF.md §6)"
             for k in ("flash-bwd", "ssd-bwd")}
# a GQA group summed into its kv head makes dk and dv larger (up to 14 at
# tinyllama's group of 8), where one bf16 rounding of the output exceeds
# 2e-2 abs: there each element is held within 2e-2 abs plus one rounding
# (2^-8 of its float64 value), for the kernel and the plain version alike.
# pixtral's group of 4 sums the same way (|dv| up to 10.6, 2.99e-2 abs off
# float64, 2.2e-5 past one rounding); the MLA has no group, but causal dV
# of the first keys sums dO over up to 512 queries (|dv| up to 6.4, where
# half a bf16 step is 1.6e-2: 1.55e-2 abs, 5.7e-6 past one rounding), so
# both wide rows take the rounded form (first card run, PERF.md §6)
BWD_ROUNDED = ("tinyllama train (gqa 8)", *BWD_WIDE)


def phase_flash_bwd(torch, F):
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref, ops)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, B, Sq, Sk, H, KH, D, Dv, causal, window, dt in BWD_CASES:
        dtype = getattr(torch, dt)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, k, v, do = randn(B, Sq, H, D), randn(B, Sk, KH, D), \
            randn(B, Sk, KH, Dv), randn(B, Sq, H, Dv)
        scale = 1.0 / math.sqrt(D)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        launched = (flash_attention.launches, flash_attention_backward.launches)
        o = flash_attention(qg, kg, vg, causal=causal, window=window)
        if o.grad_fn is None:
            fail(f"flash-bwd {name}: the output under grad has no grad_fn")
        got = torch.autograd.grad(o, (qg, kg, vg), do)
        if (flash_attention.launches - launched[0],
                flash_attention_backward.launches - launched[1]) != (1, 1):
            fail(f"flash-bwd {name}: the forward and backward under grad "
                 f"did not launch one kernel each")
        o2 = flash_attention(qg, kg, vg, causal=causal, window=window)
        if not all(torch.equal(a, b) for a, b in zip(
                got, torch.autograd.grad(o2, (qg, kg, vg), do))):
            fail(f"flash-bwd {name}: a rerun is not bitwise equal")
        del o2
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        ref = torch.autograd.grad(
            attention_ref(q64, k64, v64, causal=causal, window=window),
            (q64, k64, v64), do.double())
        del q64, k64, v64
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
        entry = route_entry(ops, q, k, v, True)
        o = ops._forward(q, k, v, causal, window, scale, lse, entry)
        plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                  window=window)
        torch.cuda.synchronize()
        err = max(float((a.double() - b).abs().max()) for a, b in zip(got, ref))
        plain_err = max(float((a.double() - b).abs().max())
                        for a, b in zip(plain, ref))
        abs_err = err
        if name in BWD_ROUNDED:   # what exceeds one rounding, plus 2e-2
            err, plain_err = (max(float(((a.double() - b).abs()
                                         - 2.0 ** -8 * b.abs()).max())
                                  for a, b in zip(out, ref))
                              for out in (got, plain))
        vs_plain = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(got, plain))
        scale_ref = max(float(b.abs().max()) for b in ref)
        del plain, ref
        tol = TOL[dt]
        extra = f" (error beyond one bf16 rounding; abs {abs_err:.3e})" \
            if name in BWD_ROUNDED else ""
        if name == "fully masked rows":   # rows 0..31: dq exactly 0
            dead = got[0][:, :Sq - Sk]
            extra = f" dq of the {Sq - Sk} keyless rows max {float(dead.abs().max())}"
            if bool((dead != 0).any()):
                fail(f"flash-bwd {name}: dq of a row with no key is not 0")
        del got

        def bwd():
            return flash_attention_backward(q, k, v, o, do, lse,
                                            causal=causal, window=window)
        ms = cuda_ms(torch, bwd)
        dev_ms = device_ms(torch, bwd, "flash_bwd")
        plain_ms = cuda_ms(torch, lambda: attention_bwd_ref(
            q, k, v, o, do, lse, causal=causal, window=window), reps=5)
        serve = route_entry(ops, q, k, v, False)
        fwd_ms = cuda_ms(torch, lambda: ops._forward(q, k, v, causal, window,
                                                     scale, None, serve))
        fwd_lse_ms = cuda_ms(torch, lambda: ops._forward(
            q, k, v, causal, window, scale, lse, entry))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot_ = do.transpose(1, 2)
        mask = None
        if causal or window:
            qp = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
            kp = torch.arange(Sk, device="cuda")[None, :]
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= kp <= qp
            if window:
                mask &= qp - kp < window

        def sdpa_fwd_bwd():   # the yardstick: the port never calls it
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=KH != H)
            return torch.autograd.grad(out, (qt, kt, vt), dot_)

        lib_ms = cuda_ms(torch, sdpa_fwd_bwd)
        sdpa_what, sdpa_dev_ms = sdpa_kernels(torch, sdpa_fwd_bwd)
        pairs = Sq * Sk if mask is None else int(mask.sum())
        # q, dq, k, dk of D; o, dO, v, dv of Dv; the f32 lse
        nbytes = (2 * B * Sq * H + 2 * B * Sk * KH) * (D + Dv) \
            * q.element_size() + 4 * B * H * Sq
        peak = PEAK_FLOPS["float32_3xtf32" if dt == "float32" else dt]
        b_ms, by = bound(nbytes, 2.0 * B * H * pairs * (3 * D + 2 * Dv), peak)
        log(f"flash-bwd {name}: B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} D={D} "
            + (f"Dv={Dv} " if Dv != D else "") +
            f"causal={causal} window={window} {dt}: max_abs_err={err:.3e} "
            f"(tol {tol}; largest |grad| {scale_ref:.3e}) plain "
            f"max_abs_err={plain_err:.3e} kernel-plain={vs_plain:.3e}"
            f"{extra} ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f} "
            f"sdpa_fwd_bwd_ms={lib_ms:.4f} (device {sdpa_dev_ms:.4f}; "
            f"{sdpa_what}) bound_ms={b_ms:.4f} ({by}) "
            f"fwd_ms={fwd_ms:.4f} fwd_lse_ms={fwd_lse_ms:.4f}; bitwise on a "
            f"rerun")
        if not err <= tol:
            fail(f"flash-bwd {name}: max_abs_err {err} > {tol}")
        if not plain_err <= tol:
            fail(f"flash-bwd {name}: the plain backward is off by {plain_err}")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                      "library_device_ms": sdpa_dev_ms,
                      "device_ms": dev_ms, "shape": name,
                      "tolerance": f"{tol} abs" + (
                          " + 2^-8 |ref| (max_abs_err: the excess over one "
                          "rounding)" if name in BWD_ROUNDED else ""),
                      "fwd_ms": fwd_ms,
                      "fwd_with_lse_ms": fwd_lse_ms,
                      "parent_device_ms": PARENT_AB["flash-bwd"]}
        del q, k, v, do, o, lse, qg, kg, vg, qt, kt, vt, dot_, mask
        torch.cuda.empty_cache()
    report = dict(rows[BWD_MAIN])
    report.update({n: rows[n] for n in ("dit-xl f32", "train-dit f32",
                                         "zamba2 prefill",
                                         "tinyllama train (gqa 8)",
                                         *BWD_WIDE)})
    report["wide_registers_spills"] = wide_usage()
    log(f"flash-bwd: the wide instantiations' registers, spill store and "
        f"load bytes {report['wide_registers_spills']}")
    if None in report["wide_registers_spills"].values():
        fail("flash-bwd: ptxas reported no wide backward instantiation")
    if any(u[1] or u[2] for u in report["wide_registers_spills"].values()):
        fail("flash-bwd: a wide backward instantiation spills")
    return report


def phase_forecast(torch, slots: int):
    import numpy as np
    from repro_torch.core import PredictivePolicy
    from repro_torch.kernels.forecast import (basis_coeffs, forecast,
                                              forecast_basis, forecast_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    interval = 4
    both = ("float32", "bfloat16")
    cases = [  # name, batch (None = unbatched), m+1, N, dtypes
        ("serving main path", slots, 3, 256 * 16, both),
        ("serving 8 slots", 8, 3, 256 * 16, both),
        ("block-sized", None, 3, 256 * 1152, both),
        # serve-video's pool (2 slots of 4096 tokens x 16 channels) and
        # serve-mixed's audio pool (2 slots of 256 tokens x 80), f32 latents
        ("dit-video pool", 2, 3, 4096 * 16, ("float32",)),
        ("dit-audio pool", 2, 3, 256 * 80, ("float32",)),
    ]
    report, foca = None, []
    for name, batch, m1, n, dtypes in cases:
        for dt in dtypes:
            for basis in ("taylor", "hermite", "foca"):
                dtype = getattr(torch, dt)
                lead = (m1,) if batch is None else (batch, m1)
                d = torch.randn(lead + (n,), generator=gen,
                                device="cuda").to(dtype)
                rows = 1 if batch is None else batch
                # steps, last_step and n_valid on the device, as a skip
                # tick holds them (the steps in the engine's static
                # buffer); u = steps / interval from 0.25 up
                host_steps = np.array([1, 2, 3, 5, 6, 7, 9, 10][:rows])
                steps = torch.from_numpy(host_steps.astype(np.int32)).cuda()
                nv = torch.arange(rows, device="cuda", dtype=torch.int32) \
                    % (m1 + 1)
                last = torch.zeros((rows,), dtype=torch.int32, device="cuda")
                if batch is None:
                    steps, nv, last = steps[0], nv[0] + 2, last[0]
                    host_steps = int(host_steps[0])
                u = (torch.as_tensor(steps, dtype=torch.int32, device="cuda")
                     - last).float() / float(interval)
                c = basis_coeffs(m1 - 1, u, basis, n_valid=nv)

                def fused():
                    return forecast_basis(d, steps, last, nv, interval, basis)

                def fused_host():   # host steps: one staged copy a call
                    return forecast_basis(d, host_steps, last, nv, interval,
                                          basis)

                def chain():   # the skip tick before the fused entry point
                    uu = (torch.as_tensor(host_steps, dtype=torch.int32,
                                          device="cuda") - last).float() \
                        / float(interval)
                    return forecast(d, basis_coeffs(m1 - 1, uu, basis,
                                                    n_valid=nv))

                out = forecast(d, c)
                before = forecast.launches
                out_f = fused()
                one_launch = forecast.launches == before + 1
                ref = forecast_ref(d, c)
                torch.cuda.synchronize()
                scale = float(ref.float().abs().max())
                err = float((out.float() - ref.float()).abs().max())
                err_f = float((out_f.float() - ref.float()).abs().max())
                tol = 2e-6 * max(scale, 1.0) if dt == "float32" \
                    else 2 ** -7 * max(scale, 1.0)
                ms = cuda_ms(torch, lambda: forecast(d, c), reps=50)
                dev_ms = device_ms(torch, lambda: forecast(d, c),
                                   "forecast_kernel")
                fused_ms = cuda_ms(torch, fused, reps=50)
                fused_dev_ms = device_ms(torch, fused, "forecast_kernel")
                fused_host_ms = cuda_ms(torch, fused_host, reps=50)
                chain_ms = cuda_ms(torch, chain, reps=50)
                plain_ms = cuda_ms(torch, lambda: forecast_ref(d, c), reps=50)
                nbytes = (rows * (m1 + 1) * n) * d.element_size() + c.numel() * 4
                b_ms, by = bound(nbytes, 2.0 * rows * m1 * n, PEAK_FLOPS[dt])
                lib_ms = None
                if dt == "float32":
                    c3 = c.view(rows, 1, m1)
                    d3 = d.view(rows, m1, n)
                    lib_ms = cuda_ms(torch, lambda: torch.bmm(c3, d3), reps=50)
                log(f"forecast {name} {tuple(d.shape)} {dt} {basis}: "
                    f"max_abs_err={err:.3e} fused {err_f:.3e} (tol {tol:.3e}) "
                    f"ms={ms:.4f} device_ms={dev_ms} fused_ms={fused_ms:.4f} "
                    f"fused_device_ms={fused_dev_ms} fused_host_steps_ms="
                    f"{fused_host_ms:.4f} chain_ms={chain_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({by}) "
                    f"library_ms={lib_ms}")
                if max(err, err_f) > tol:
                    fail(f"forecast {name} {dt} {basis}: err {max(err, err_f)} "
                         f"> {tol}")
                if not one_launch:
                    fail(f"forecast {name}: forecast_basis did not count one "
                         f"launch")
                if basis == "foca":
                    foca.append(err_f / tol)
                if report is None:
                    report = {"max_abs_err": max(err, err_f), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": by, "library_ms": lib_ms,
                              "device_ms": dev_ms, "fused_ms": fused_ms,
                              "fused_device_ms": fused_dev_ms,
                              "fused_host_steps_ms": fused_host_ms,
                              "chain_ms": chain_ms,
                              "shape": f"{name} {tuple(d.shape)} {dt}",
                              "tolerance": f"{tol:.3e} abs"}
                if name.endswith(" pool") and basis == "taylor":
                    report[name] = {"ms": ms, "device_ms": dev_ms,
                                    "fused_ms": fused_ms,
                                    "fused_device_ms": fused_dev_ms,
                                    "max_abs_err": max(err, err_f),
                                    "bound_ms": b_ms, "bound_by": by,
                                    "plain_ms": plain_ms,
                                    "library_ms": lib_ms}

    report["foca_worst_err_over_tol"] = max(foca)
    # one skip tick of the policy (no slot computes) under the profiler
    pol = PredictivePolicy(interval, 2, "taylor")
    S = slots
    states = {"diffs": torch.randn((S, 3, 256, 16), generator=gen,
                                   device="cuda"),
              "n_valid": torch.full((S,), 3, dtype=torch.int32, device="cuda"),
              "last_step": torch.zeros((S,), dtype=torch.int32, device="cuda")}
    steps = np.array([1, 2, 3, 5, 6, 7, 9, 10][:S])
    xs = torch.zeros((S, 256, 16), device="cuda")
    # with the plan's host decision (no slot computes) and the steps as
    # the engine passes them (Staged: the host array and its static device
    # buffer); without a decision, apply_slots reads its own from the device
    from repro_torch.device import Staged
    skip = Staged(np.zeros((S,), bool),
                  torch.zeros((S,), dtype=torch.bool, device="cuda"),
                  ("want_c",))
    steps = Staged(steps, torch.from_numpy(steps.astype(np.int32)).cuda(),
                   ("steps",))
    tick = lambda: pol.apply_slots(states, steps, xs, xs,  # noqa: E731
                                   want=skip)
    tick()
    before = forecast.launches
    evts, _ = profile(torch, tick)
    kern = [e for e in evts if _self_device_us(e) > 0
            and str(e.device_type).endswith("CUDA")]
    report["skip_tick"] = {
        "forecast_launches": forecast.launches - before,
        "device_kernels": sum(e.count for e in kern),
        "aten_ops": sum(e.count for e in evts if e.key.startswith("aten::")),
        "memcpy_h2d": sum(e.count for e in evts if "HtoD" in e.key),
        "ms": cuda_ms(torch, tick, reps=50)}
    log(f"forecast: one skip tick of apply_slots ({S} slots): "
        f"{report['skip_tick']}; kernels {[e.key[:50] for e in kern]}")
    if report["skip_tick"]["forecast_launches"] != 1:
        fail("forecast: a skip tick did not launch the forecast kernel once")
    return report


def ssd_inputs(torch, gen, b, s, h, p, n, xbc: bool):
    """x, dt, A, B, C for the scan.  xbc: x, B and C are bf16 views of one
    (b, s, h p + 2 n) conv output, as `mamba2_forward` passes them;
    otherwise contiguous f32."""
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
    if xbc:
        w = h * p
        buf = torch.randn((b, s, w + 2 * n), generator=gen,
                          device="cuda").to(torch.bfloat16)
        return (buf[..., :w].view(b, s, h, p), dt, A, buf[..., w:w + n],
                buf[..., w + n:])
    return (torch.randn((b, s, h, p), generator=gen, device="cuda"), dt, A,
            torch.randn((b, s, n), generator=gen, device="cuda"),
            torch.randn((b, s, n), generator=gen, device="cuda"))


def causal_pairs(s: int, L: int = 64) -> int:
    """(i, j) pairs with j <= i inside each L-token tile of s tokens (the
    last tile ragged)."""
    full, rest = divmod(s, L)
    return full * L * (L + 1) // 2 + rest * (rest + 1) // 2


def ssd_fwd_work(b, s, h, p, n, el, xbc):
    """(bytes, operations, seconds of operations at the peak) the scan
    needs: x, B, C (el bytes), dt and A read once, y and h written once
    in f32.  Per (b, tile) the causal half of C B^T over n (shared by the
    heads); per (b, h, tile) the causal half of S x over p; per token and
    head C h^T and the state update over (p, n).  On bf16 xBC views C B^T
    has two bf16 operands (the bf16 peak) and the rest one (the 2xTF32
    peak); f32 inputs take 3xTF32 throughout."""
    pairs = causal_pairs(s)
    cb = 2.0 * b * pairs * n
    rest = 2.0 * b * h * pairs * p + 2.0 * b * h * s * 2 * p * n
    seconds = (cb / PEAK_FLOPS["bfloat16" if xbc else "float32_3xtf32"]
               + rest / PEAK_FLOPS["bf16_x_f32_2xtf32" if xbc
                                   else "float32_3xtf32"])
    nbytes = (el * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
              + 4 * (b * s * h * p + b * h * p * n))
    return nbytes, cb + rest, seconds


def phase_ssd(torch):
    from repro_torch.kernels.ssd import ssd_chunked, ssd_ref, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(2)
    report = None
    for name, b, s, h, p, n, xbc in (
            ("zamba2 prefill f32", 4, 512, 80, 64, 64, False),
            ("zamba2 prefill bf16 xBC views", 4, 512, 80, 64, 64, True),
            ("b1 bf16 xBC views", 1, 512, 80, 64, 64, True),
            ("ragged 500 f32", 1, 500, 80, 64, 64, False)):
        args = ssd_inputs(torch, gen, b, s, h, p, n, xbc)
        y, hf = ssd_scan(*args)
        # the plain version at the longest chunk of at most 64 that divides
        # s: 64 as the path runs it; at s = 500 the path's plain version
        # takes one 500-token chunk (JAX's chunk = s rule) and rounds its
        # cumsums near -700 by more than the tolerance.
        chunk = max(c for c in range(1, 65) if s % c == 0)
        yr, hr = ssd_chunked(*args, chunk)
        torch.cuda.synchronize()
        if y.shape != (b, s, h, p) or hf.shape != (b, h, p, n):
            fail(f"ssd {name}: got {tuple(y.shape)} {tuple(hf.shape)}")

        def excess(out, ref):      # > 0 where |out - ref| > atol + rtol |ref|
            return float(((out - ref).abs()
                          - SSD_TOL["rtol"] * ref.abs()).max())

        err = max(float((y - yr).abs().max()), float((hf - hr).abs().max()))
        worst = max(excess(y, yr), excess(hf, hr))
        ms = cuda_ms(torch, lambda: ssd_scan(*args))
        dev_ms = device_ms(torch, lambda: ssd_scan(*args), SSD_KERNELS)
        plain_ms = cuda_ms(torch, lambda: ssd_ref(*args), reps=5)
        nbytes, flops, t_ops = ssd_fwd_work(b, s, h, p, n,
                                            args[0].element_size(), xbc)
        b_ms, by = bound(nbytes, flops, flops / t_ops)
        log(f"ssd {name}: b={b} s={s} h={h} p={p} n={n} "
            f"{str(args[0].dtype)[6:]}: max_abs_err={err:.3e} vs plain at "
            f"chunk {chunk} (tol {SSD_TOL['atol']} abs + {SSD_TOL['rtol']} "
            f"rel, worst excess {worst:.3e}) ms={ms:.4f} device_ms={dev_ms} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if not worst <= SSD_TOL["atol"]:
            fail(f"ssd {name}: off by {worst} beyond {SSD_TOL}")
        rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": by, "library_ms": None,
               "device_ms": dev_ms, "shape": name,
               "tolerance": f"{SSD_TOL['atol']} abs + {SSD_TOL['rtol']} rel"}
        if report is None:
            report = {"f32": rec}
        elif xbc and "shape" not in report:   # the path's case is the row
            report.update(rec)
    return report


def no_launches(kernels):
    """A zero count for each wrapper in `kernels` and each C entry point."""
    from repro_torch.kernels import _build
    return dict.fromkeys((*(k.__name__ for k in kernels), *_build.ENTRIES), 0)


def _count_launches(kernels, path, phase, run):
    """Set every count to 0 (the wrappers' and each C entry point's,
    `_build.launches`), run, read the counts; fail if a kernel of `path`
    was not launched."""
    from repro_torch.kernels import _build
    for k in kernels:
        k.launches = 0
    for e in _build.ENTRIES:
        setattr(_build.launches, e, 0)
    out = run()
    launches = {k.__name__: k.launches for k in kernels}
    launches.update(vars(_build.launches))
    for k in path:
        if launches[k.__name__] <= 0:
            fail(f"{phase}: kernel {k.__name__} was not launched on this path")
    return out, launches


def phase_serve(torch, kernels, path):
    from repro_torch.configs import get_config
    from repro_torch.core import make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import DiffusionServingEngine
    cfg = get_config("dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)
    n_params = sum(t.numel() for t in _leaves(params))
    eng = DiffusionServingEngine(params, cfg, "taylorseer", slots=4,
                                 max_steps=16, device="cuda")
    buckets = eng.warmup()
    torch.cuda.synchronize()
    log(f"serve: dit-xl {cfg.num_layers} layers d_model={cfg.d_model} "
        f"params={n_params} ({cfg.dtype}) init+warmup "
        f"{time.perf_counter() - t0:.2f}s buckets={buckets}")
    reqs = serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = _count_launches(kernels, path, "serve",
                                    lambda: eng.serve(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pol = make_policy("taylorseer")
    if len(res) != len(reqs):
        fail(f"serve: {len(res)} of {len(reqs)} requests finished")
    for r, req in zip(res, reqs):
        if r.x0.shape != (cfg.dit_tokens, cfg.dit_in_dim):
            fail(f"serve: request {r.request_id} x0 shape {r.x0.shape}")
        if not math.isfinite(float(abs(r.x0).max())):
            fail(f"serve: request {r.request_id} x0 not finite")
        want = sum(pol.static_schedule(req.num_steps))
        if r.record.computed_steps != want:
            fail(f"serve: request {r.request_id} computed "
                 f"{r.record.computed_steps} steps, schedule says {want}")
        want_u = req.num_steps if req.guided else 0
        if r.record.uncond_computed_steps != want_u:
            fail(f"serve: request {r.request_id} uncond computed "
                 f"{r.record.uncond_computed_steps}, want {want_u}")
    s = eng.telemetry.summary()
    rows = s["backbone_rows_computed"] + s["backbone_rows_padding"]
    log(f"serve: {s['requests']} requests in {wall:.3f}s wall, "
        f"throughput_rps={s['throughput_rps']:.4f} "
        f"ticks={s['ticks']} (full {eng.telemetry.ticks_full}, cond "
        f"{eng.telemetry.ticks_cond}, skip {eng.telemetry.ticks_skip}) "
        f"tick_ms_backbone_mean={s['tick_ms_backbone_mean']:.3f} "
        f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"backbone_rows_padding={s['backbone_rows_padding']} "
        f"latency_p50_s={s['latency_p50_s']:.3f} "
        f"latency_p95_s={s['latency_p95_s']:.3f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    log(f"serve: launches {launches} (flash: {cfg.num_layers} per backbone "
        f"pass; {eng.telemetry.ticks_backbone} backbone ticks, {rows} rows)")
    # the same traffic again under the profiler: where the device time goes
    log_profile(torch, "serve", lambda: eng.serve(reqs))
    del params, eng
    torch.cuda.empty_cache()
    return launches, s["tick_ms_skip_mean"]


def serve_requests(cfg):
    """The served phases' traffic: 8 requests of 8 and 16 steps, two
    guided."""
    from repro_torch.serving.diffusion import DiffusionRequest
    return [DiffusionRequest(i, num_steps=(8, 16)[i % 2], seed=i,
                             class_label=(37 * i) % cfg.dit_num_classes,
                             cfg_scale=4.0 if i in (1, 4) else 0.0)
            for i in range(8)]


def log_profile(torch, label, fn):
    """Run fn() under the profiler; log the device's idle share and the
    twelve kernels that took the most device time."""
    evts, pwall = profile(torch, fn)
    kern = sorted((e for e in evts if _self_device_us(e) > 0
                   and str(e.device_type).endswith("CUDA")),
                  key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in kern) / 1e3
    log(f"profile: {label} wall {pwall * 1e3:.1f} ms (profiled), device "
        f"kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / (pwall * 1e3):.3f}")
    for e in kern[:12]:
        log(f"profile: {_self_device_us(e) / 1e3:9.3f} ms "
            f"{100 * _self_device_us(e) / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# The reduced check's policies (phase 9): thresholds for its weights and
# noise, each splitting the steps into computes and reuses; every
# thresholded decision of the CPU reference lies at least 1e-4 relative from
# them (the phase asserts it).  LazyDiT's gate comes from a seeded
# generator, BlockCache's profile is fixed.
CHECK_PROFILE = [0.0, 0.04, 0.07, 0.02, 0.09, 0.03, 0.05, 0.08, 0.01, 0.06,
                 0.05, 0.02]
CHECK_POLICIES = {
    "taylorseer": {}, "delta_dit": {}, "pab": {}, "foca": {}, "freqca": {},
    "teacache": {"delta": 0.3}, "magcache": {"delta": 0.05},
    "easycache": {"tau": 35.0}, "foresight": {"gamma": 1.0},
    "blockcache": {"profile": CHECK_PROFILE}, "lazydit": {"threshold": 0.56},
    "toca": {}, "clusca": {}, "speca": {},
}
MARGIN = 1e-4      # least relative distance of a value from its threshold
# serve-adaptive's TeaCache threshold at full width: the slots diverge (some
# ticks gather fewer rows than there are active slots)
TEACACHE_DELTA = 0.5


def drive(eng, reqs, record: bool = False):
    """Serve `reqs` tick by tick.  Returns (results, log): per request the
    steps at which the plan gave it a cond row (`rows`) and an uncond row
    (`urows`), each tick's kind, the ticks whose cond rows were fewer than
    the active slots but not none (`split`), the plan's host seconds per
    tick from a wrapper around the plan (`plan_s`) and as the tick events
    report them (`event_plan_s`), and with `record` every device plan (the
    active mask and the WantPlan read back).  The per-tick entries come
    from a TickEvent hook."""
    import numpy as np
    log = {"rows": {r.request_id: [] for r in reqs},
           "urows": {r.request_id: [] for r in reqs}, "kinds": [],
           "split": 0, "plan_s": [], "event_plan_s": [], "plans": []}
    plan, want_all = eng._plan_all, eng._want_all
    session = None

    def timed_plan(*args):
        t0 = time.perf_counter()
        out = plan(*args)
        log["plan_s"].append(time.perf_counter() - t0)
        return out

    def recorded_want(*args):
        out = want_all(*args)
        log["plans"].append((np.asarray(session.sched.active_mask()), out))
        return out

    def on_tick(ev):
        for key, want in (("rows", ev.want_cond), ("urows", ev.want_uncond)):
            for s in np.nonzero(want)[0]:
                log[key][int(ev.request_ids[s])].append(int(ev.steps[s]))
        log["split"] += 0 < int(ev.want_cond.sum()) < int(ev.active.sum())
        log["kinds"].append(ev.kind)
        log["event_plan_s"].append(ev.plan_seconds)

    eng._plan_all = timed_plan
    if record:
        eng._want_all = recorded_want
    try:
        session = eng.start_session(reqs, hooks=[on_tick])
        while not session.done:
            session.tick()
    finally:
        # back to the class's method: an instance attribute holding the
        # bound method would make a cycle that keeps the engine (and its
        # params) alive until the next garbage collection
        del eng._plan_all
        eng._want_all = want_all
    return session.finish(), log


def check_rows(phase, res, reqs, log):
    """Every request's first step computes; its computed steps lie in
    [1, num_steps] and equal the ticks the plan gave its row."""
    for r, req in zip(res, reqs):
        rows = log["rows"][r.request_id]
        if not rows or rows[0] != 0:
            fail(f"{phase}: request {r.request_id}'s first step did not "
                 f"compute (rows at steps {rows})")
        if not 1 <= r.record.computed_steps <= req.num_steps \
                or r.record.computed_steps != len(rows):
            fail(f"{phase}: request {r.request_id} computed "
                 f"{r.record.computed_steps} of {req.num_steps} steps, the "
                 f"plan gave it {len(rows)} rows")


def least_margin(log):
    """The least relative distance from its threshold of any thresholded
    decision of an active slot in the recorded plans (None if none)."""
    import numpy as np
    rel = [abs(p.value[s] - p.threshold[s]) / max(abs(p.threshold[s]), 1e-12)
           for active, p in log["plans"]
           for s in np.nonzero(active & ~p.forced)[0]]
    return float(min(rel)) if rel else None


def plan_readbacks(torch, eng, reqs, attempts: int = 3, results: int = 0):
    """`profile_plan` until its device record is whole: a profile whose
    Memcpy DtoH events inside the plan are fewer than the device-to-host
    copies the plan dispatched on the host, or whose copies in all are
    fewer than the `results` the serve read back, lost CUPTI records (the
    program made the copies; the profiler dropped their records), and is
    taken again, `attempts` profiles at most.  Returns the first whole
    profile's counts, or the last profile's, with every profile's in-plan
    device count in `dtoh_in_plan_tries`.  A profile never shows copies
    that were not made, so the callers' want of exactly so many a tick is
    held on a whole record."""
    tries = []
    for _ in range(attempts):
        rb = profile_plan(torch, eng, reqs)
        tries.append(rb["dtoh_in_plan"])
        if rb["dtoh_in_plan"] >= rb["host_dtoh_in_plan"] \
                and rb["dtoh_total"] >= results:
            break
        log(f"plan_readbacks: the profile holds {rb['dtoh_in_plan']} "
            f"device-to-host copies in the plan of the "
            f"{rb['host_dtoh_in_plan']} dispatched ({rb['dtoh_total']} linked "
            f"in all of at least {results}, {rb['dtoh_device_events']} "
            f"device events): CUPTI "
            f"records lost, profiling again")
    rb["dtoh_in_plan_tries"] = tries
    return rb


def profile_plan(torch, eng, reqs):
    """Serve `reqs` under the profiler with each plan call marked: the
    device-to-host copies (the profiler's Memcpy DtoH events) issued inside
    a plan call and in all, the plan calls, and the device's idle share of
    the profiled wall time.  `host_dtoh_in_plan` counts the same copies on
    the host, as the plan dispatches them (an `OpRecorder` around each plan
    call: copies from a CUDA tensor into a CPU one)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as prof_ctx
    from repro_torch.analysis.ir.op_checks import OpRecorder
    plan = eng._plan_all
    host = []

    def marked(*args):
        with record_function("repro_plan"), \
                OpRecorder(sync_debug=False) as rec:
            out = plan(*args)
        host.append(sum(ev.kind == "dtoh" for ev in
                        rec.record.priced + rec.record.syncs))
        return out

    eng._plan_all = marked
    try:
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del eng._plan_all           # the class's method again (see drive)
    evts = prof.events()
    # each device copy is linked to the operator that issued it (its
    # `kernels`); the plan's are those that start inside a `repro_plan`
    # range on its thread.  Not by walking `cpu_parent`: the profiler
    # nests by time with CUPTI's runtime events among the operators, and
    # one that overlaps its operator's end cuts the chain (one of 32 plan
    # copies lost its `repro_plan` ancestor so in a card run).
    issued = [(e, sum("Memcpy DtoH" in k.name for k in e.kernels))
              for e in evts if str(e.device_type).endswith("CPU")]
    plans = {}
    for e, _ in issued:
        if e.name == "repro_plan":
            plans.setdefault(e.thread, []).append(e.time_range)
    plan_calls = sum(map(len, plans.values()))

    def in_plan(e):
        return any(r.start <= e.time_range.start < r.end
                   for r in plans.get(e.thread, ()))

    busy = sum(_self_device_us(e) for e in prof.key_averages()
               if _self_device_us(e) > 0
               and str(e.device_type).endswith("CUDA")) / 1e3
    by_op = {}
    for e, n in issued:
        if n:
            key = f"{e.name}{' in plan' if in_plan(e) else ''}"
            by_op[key] = by_op.get(key, 0) + n
    return {"dtoh_in_plan": sum(n for e, n in issued if n and in_plan(e)),
            "host_dtoh_in_plan": sum(host),
            "dtoh_by_op": by_op,
            "dtoh_total": sum(n for _, n in issued),
            "dtoh_device_events": sum("Memcpy DtoH" in e.name for e in evts
                                      if not str(e.device_type)
                                      .endswith("CPU")),
            "plan_calls": plan_calls,
            "ticks": eng.telemetry.summary()["ticks"],
            "idle_share": 1 - busy / (wall * 1e3), "busy_ms": busy,
            "wall_ms": wall * 1e3}


def check_plan_copies(label, rb, want):
    """Fail unless the plan made `want` device-to-host copies a tick, on
    the host (as dispatched) and on the device (the profile's record);
    return the counts as a log fragment."""
    want_n = want * rb["ticks"]
    note = (f"{rb['dtoh_in_plan']} on the device and "
            f"{rb['host_dtoh_in_plan']} dispatched in {rb['plan_calls']} "
            f"plan calls over {rb['ticks']} ticks (want {want} a tick; "
            f"profiles {rb['dtoh_in_plan_tries']})")
    if rb["dtoh_in_plan"] != want_n or rb["host_dtoh_in_plan"] != want_n:
        fail(f"{label}: plan device-to-host copies: {note}; "
             f"{rb['dtoh_total']} DtoH linked to operators, "
             f"{rb['dtoh_device_events']} DtoH device events, by operator "
             f"{rb['dtoh_by_op']}")
    return note


def phase_serve_adaptive(torch, kernels, flash, forecast):
    """Full-width DiT-XL under TeaCache (device plan) and FoCa (host plan),
    with serve's weights, slots and requests."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import DiffusionServingEngine
    cfg = get_config("dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(0)     # serve's weights
    params = perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)
    reqs = serve_requests(cfg)
    out = {}
    for name, kw, path in (("teacache", {"delta": TEACACHE_DELTA}, (flash,)),
                           ("foca", {}, (flash, forecast))):
        phase = f"serve-{name}"
        eng = DiffusionServingEngine(params, cfg, make_policy(
            name, num_steps=16, **kw), slots=4, max_steps=16, device="cuda")
        eng.warmup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (res, trace), launches = _count_launches(
            kernels, path, phase, lambda: drive(eng, reqs, record=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(res) != len(reqs):
            fail(f"{phase}: {len(res)} of {len(reqs)} requests finished")
        for r in res:
            if not math.isfinite(float(abs(r.x0).max())):
                fail(f"{phase}: request {r.request_id} x0 not finite")
        check_rows(phase, res, reqs, trace)
        s = eng.telemetry.summary()
        tel = eng.telemetry
        if name == "teacache":
            vals = sorted(float(p.value[i]) for a, p in trace["plans"]
                          for i in range(len(a)) if a[i] and not p.forced[i])
            log(f"{phase}: delta {TEACACHE_DELTA}: {trace['split']} ticks "
                f"gathered fewer cond rows than active slots; thresholded "
                f"values min {vals[0]:.4f} median {vals[len(vals) // 2]:.4f} "
                f"max {vals[-1]:.4f}, least margin "
                f"{least_margin(trace)}")
            if s["backbone_rows_saved"] <= 0 or trace["split"] == 0:
                fail(f"{phase}: at delta {TEACACHE_DELTA} no row saved or no "
                     f"tick split the slots")
        plan_ms = 1e3 * sum(trace["plan_s"]) / len(trace["plan_s"])
        rb = plan_readbacks(torch, eng, reqs, results=len(reqs))
        if rb["dtoh_total"] < len(reqs):
            fail(f"{phase}: the profiler linked {rb['dtoh_total']} DtoH "
                 f"copies to their operators, fewer than the {len(reqs)} "
                 f"results' (by operator: {rb['dtoh_by_op']})")
        per_tick = rb["dtoh_in_plan"] / rb["ticks"]
        log(f"{phase}: {kw} "
            f"{s['requests']} requests in {wall:.3f}s wall, "
            f"throughput_rps={s['throughput_rps']:.4f} "
            f"ticks={s['ticks']} (full {tel.ticks_full}, cond "
            f"{tel.ticks_cond}, skip {tel.ticks_skip}) "
            f"tick_ms_backbone_mean={s['tick_ms_backbone_mean']:.3f} "
            f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
            f"backbone_rows_computed={s['backbone_rows_computed']} "
            f"backbone_rows_padding={s['backbone_rows_padding']} "
            f"backbone_rows_saved={s['backbone_rows_saved']} "
            f"computed_steps={[r.record.computed_steps for r in res]} "
            f"plan_host_ms_per_tick={plan_ms:.4f} "
            f"plan_dtoh_per_tick={per_tick:.3f} "
            f"({rb['dtoh_in_plan']} in {rb['plan_calls']} plan calls, "
            f"{rb['ticks']} ticks; {rb['host_dtoh_in_plan']} dispatched, "
            f"profiles {rb['dtoh_in_plan_tries']}; {rb['dtoh_total']} DtoH "
            f"issued in "
            f"all, {len(reqs)} of them the results; "
            f"{rb['dtoh_device_events']} DtoH device events; by "
            f"operator {rb['dtoh_by_op']}) "
            f"idle_share={rb['idle_share']:.3f} (profiled wall "
            f"{rb['wall_ms']:.1f} ms, device kernels "
            f"{rb['busy_ms']:.1f} ms) launches {launches}")
        check_plan_copies(phase, rb, 1 if name == "teacache" else 0)
        out[phase] = launches
        del eng
    del params
    torch.cuda.empty_cache()
    return out


def phase_check(torch):
    """A reduced DiT served on the card (kernels) and on the CPU (plain
    versions) from the same weights and the same noise, under each policy
    of CHECK_POLICIES."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_gate, make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl").reduced(num_layers=3, d_model=128, num_heads=4,
                                       num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    cpu_params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    gpu_params = _to(cpu_params, "cuda")
    gate = init_gate(torch.Generator().manual_seed(11), cfg.dit_in_dim)

    def noise(req):
        g = torch.Generator().manual_seed(1000 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i == 1 else 0.0)
            for i in range(3)]
    for name, kw in CHECK_POLICIES.items():
        kw = dict(kw, gate=gate) if name == "lazydit" else kw
        out = {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = DiffusionServingEngine(p, cfg, make_policy(
                name, num_steps=12, **kw), slots=2, max_steps=12,
                noise_fn=noise, device=dev)
            out[dev] = drive(eng, reqs, record=True)
        (gres, glog), (cres, clog) = out["cuda"], out["cpu"]
        margin = least_margin(clog)
        if margin is not None and margin < MARGIN:
            fail(f"check {name}: a decision of the CPU reference lies "
                 f"{margin:.3e} relative from its threshold (< {MARGIN}): "
                 f"the exact comparison is not well posed")
        steps = {d: [r.record.computed_steps for r in out[d][0]] for d in out}
        if steps["cuda"] != steps["cpu"] or glog["kinds"] != clog["kinds"]:
            for t, ((_, a), (_, b)) in enumerate(zip(glog["plans"],
                                                     clog["plans"])):
                if (a.want_cond != b.want_cond).any():
                    log(f"check {name}: tick {t} decisions differ: card "
                        f"{a.want_cond} metric {a.metric} value {a.value}; "
                        f"CPU {b.want_cond} metric {b.metric} value "
                        f"{b.value}; threshold {b.threshold}")
                    break
            fail(f"check {name}: card and CPU decide differently: computed "
                 f"steps {steps}, tick kinds {glog['kinds']} vs "
                 f"{clog['kinds']}")
        worst = rel_err(gres, cres)
        kinds = clog["kinds"]
        log(f"check {name}: reduced DiT served on the card vs the CPU: "
            f"computed steps {steps['cpu']} identical, "
            f"{len(kinds)} tick kinds identical (full {kinds.count('full')}, "
            f"cond {kinds.count('cond')}, skip {kinds.count('skip')}), "
            f"least margin {margin}, max rel err {worst:.3e} (tol 1e-3)")
        if not worst <= 1e-3:
            fail(f"check {name}: card and CPU disagree (rel err {worst})")


# serve-cfg and check-cfg: TaylorSeer's cond branch, FasterCacheCFG's
# uncond branch; both refresh every 4 steps at full width
CFG_GUIDED = (0, 1, 4, 5)
CFG_VECTOR = 5       # the request that carries a negative-prompt vector


def cfg_requests(cfg, torch, vector: bool = True):
    """serve-cfg's traffic: 8 requests of 8 and 16 steps, 0, 1, 4 and 5
    guided at cfg_scale 4.0; request 5 carries a negative-prompt vector (a
    seeded draw at the class embedding's scale, 0.02), or the class null
    when `vector` is false."""
    from repro_torch.serving.diffusion import DiffusionRequest
    vec = (0.02 * torch.randn((cfg.d_model,), generator=torch.Generator()
                              .manual_seed(5))).numpy()
    return [DiffusionRequest(i, num_steps=(8, 16)[i % 2], seed=i,
                             class_label=(37 * i) % cfg.dit_num_classes,
                             cfg_scale=4.0 if i in CFG_GUIDED else 0.0,
                             null_label=vec if vector and i == CFG_VECTOR
                             else None)
            for i in range(8)]


def check_cfg_rows(phase, res, reqs, trace, cond_pol, cfg_pol):
    """Each request's computed steps equal the cond policy's schedule, and
    its uncond computed steps the CFG policy's (0 when unguided); the plan
    gave it exactly those rows."""
    for r, req in zip(res, reqs):
        want = sum(cond_pol.static_schedule(req.num_steps))
        want_u = (sum(cfg_pol.static_schedule(req.num_steps))
                  if req.guided else 0)
        got = (r.record.computed_steps, r.record.uncond_computed_steps)
        rows = (len(trace["rows"][r.request_id]),
                len(trace["urows"][r.request_id]))
        if got != (want, want_u) or rows != got:
            fail(f"{phase}: request {r.request_id} computed {got} (cond, "
                 f"uncond) steps with {rows} rows, the schedules say "
                 f"{(want, want_u)}")
        if not math.isfinite(float(abs(r.x0).max())):
            fail(f"{phase}: request {r.request_id} x0 not finite")


def rel_err(a, b):
    """max |a - b| over max |b|, worst over the paired results."""
    return max(float(abs(x.x0 - y.x0).max() / max(abs(y.x0).max(), 1e-6))
               for x, y in zip(a, b))


def full_dit(torch):
    """serve's model: full-width DiT-XL, bf16 params, random weights from
    seed 0 with the AdaLN gates perturbed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    cfg = get_config("dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)


def phase_serve_cfg(torch, kernels, path, params, cfg):
    """Full-width DiT-XL under TaylorSeer with FasterCacheCFG on the uncond
    branch: compacted, with the class null in place of the vector, dense,
    and with a metrics registry and a tick hook."""
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.diffusion import DiffusionServingEngine

    def engine(**kw):
        eng = DiffusionServingEngine(
            params, cfg, "taylorseer", slots=4, max_steps=16,
            cfg_policy=FasterCacheCFG(interval=4, num_steps=16),
            device="cuda", **kw)
        eng.warmup()
        torch.cuda.synchronize()
        return eng

    cond_pol, cfg_pol = make_policy("taylorseer"), FasterCacheCFG(4, 16)
    reqs = cfg_requests(cfg, torch)
    eng = engine()
    t0 = time.perf_counter()
    (res, trace), launches = _count_launches(
        kernels, path, "serve-cfg", lambda: drive(eng, reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(res) != len(reqs):
        fail(f"serve-cfg: {len(res)} of {len(reqs)} requests finished")
    check_cfg_rows("serve-cfg", res, reqs, trace, cond_pol, cfg_pol)
    s, tel = eng.telemetry.summary(), eng.telemetry
    if tel.ticks_cond <= 0 or s["uncond_rows_saved"] <= 0:
        fail(f"serve-cfg: no cond-only tick ({tel.ticks_cond}) or no uncond "
             f"row saved ({s['uncond_rows_saved']})")
    plan_ms = 1e3 * sum(trace["plan_s"]) / len(trace["plan_s"])
    ev_ms = 1e3 * sum(trace["event_plan_s"]) / len(trace["event_plan_s"])
    log(f"serve-cfg: taylorseer + FasterCacheCFG(4): {s['requests']} "
        f"requests ({s['guided_requests']} guided) in {wall:.3f}s wall, "
        f"throughput_rps={s['throughput_rps']:.4f} ticks={s['ticks']} (full "
        f"{tel.ticks_full}, cond {tel.ticks_cond}, skip {tel.ticks_skip}) "
        f"tick_ms_full_mean={s['tick_ms_full_mean']:.3f} "
        f"tick_ms_cond_mean={s['tick_ms_cond_mean']:.3f} "
        f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"backbone_rows_padding={s['backbone_rows_padding']} "
        f"backbone_rows_saved={s['backbone_rows_saved']} "
        f"uncond_rows_computed={s['uncond_rows_computed']} "
        f"uncond_rows_saved={s['uncond_rows_saved']} "
        f"computed_steps={[r.record.computed_steps for r in res]} "
        f"uncond_steps={[r.record.uncond_computed_steps for r in res]} "
        f"latency_p50_s={s['latency_p50_s']:.3f} "
        f"latency_p95_s={s['latency_p95_s']:.3f} "
        f"plan_host_ms_per_tick={plan_ms:.4f} (wrapper) {ev_ms:.4f} "
        f"(TickEvent.plan_seconds) launches {launches}")

    # the same traffic with the class null on request 5: the vector must
    # have reached its uncond rows
    res_null = eng.serve(cfg_requests(cfg, torch, vector=False))
    by_id = {r.request_id: r for r in res_null}
    diff = float(abs(res[CFG_VECTOR].x0 - by_id[CFG_VECTOR].x0).max())
    same = max(float(abs(res[i].x0 - by_id[i].x0).max())
               for i in range(len(reqs)) if i != CFG_VECTOR
               and reqs[i].guided)
    log(f"serve-cfg: request {CFG_VECTOR} with its negative-prompt vector "
        f"vs the class null: max |dx0| {diff:.4e}; the other guided "
        f"requests {same:.4e}")
    if not diff > 1e-3 * float(abs(by_id[CFG_VECTOR].x0).max()):
        fail(f"serve-cfg: the vector null did not change request "
             f"{CFG_VECTOR}'s x0 ({diff})")
    del eng

    # the dense engine: whole-pool full / cond / skip ticks
    dense = engine(row_compaction=False)
    t0 = time.perf_counter()
    dres, dtrace = drive(dense, reqs)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    err = rel_err(dres, res)
    dsteps = [(r.record.computed_steps, r.record.uncond_computed_steps)
              for r in dres]
    csteps = [(r.record.computed_steps, r.record.uncond_computed_steps)
              for r in res]
    ds = dense.telemetry.summary()
    log(f"serve-cfg: dense engine: {dwall:.3f}s wall, throughput_rps="
        f"{ds['throughput_rps']:.4f} tick_ms_full_mean="
        f"{ds['tick_ms_full_mean']:.3f} tick_ms_cond_mean="
        f"{ds['tick_ms_cond_mean']:.3f} backbone_rows_computed="
        f"{ds['backbone_rows_computed']}; computed steps and tick kinds "
        f"{'identical' if (dsteps, dtrace['kinds']) == (csteps, trace['kinds']) else 'DIFFER'}"
        f", max rel err vs compacted {err:.3e} (tol 1e-3)")
    if dsteps != csteps or dtrace["kinds"] != trace["kinds"]:
        fail(f"serve-cfg: the dense engine decides differently: {dsteps} vs "
             f"{csteps}, kinds {dtrace['kinds']} vs {trace['kinds']}")
    if not err <= 1e-3:
        fail(f"serve-cfg: dense and compacted x0 differ (rel err {err})")
    del dense

    # a metrics registry and a tick hook: the counters agree with the
    # telemetry; what they cost in req/s
    eng = engine()
    reg, events = MetricsRegistry(), []
    t0 = time.perf_counter()
    eng.serve(reqs, metrics=reg, hooks=[events.append])
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    ms, mtel = eng.telemetry.summary(), eng.telemetry
    ticks = sum(reg.counter("repro_engine_ticks_total").values.values())
    rows = reg.counter("repro_engine_rows_computed_total").value(
        modality="image")
    if ticks != ms["ticks"] or rows != mtel.backbone_rows_computed \
            or len(events) != ms["ticks"]:
        fail(f"serve-cfg: registry ticks {ticks} / rows {rows} / events "
             f"{len(events)} disagree with the telemetry's {ms['ticks']} / "
             f"{mtel.backbone_rows_computed}")
    hook_ms = 1e3 * sum(e.plan_seconds for e in events) / len(events)
    log(f"serve-cfg: with a MetricsRegistry and a TickEvent hook: "
        f"{mwall:.3f}s wall, throughput_rps={ms['throughput_rps']:.4f} "
        f"(without: {s['throughput_rps']:.4f}); registry ticks {ticks:g} = "
        f"telemetry, rows {rows:g} = backbone_rows_computed; hook "
        f"plan_seconds {hook_ms:.4f} ms a tick (wrapper {plan_ms:.4f})")
    del eng
    torch.cuda.empty_cache()
    return launches, s


def phase_check_cfg(torch):
    """The reduced DiT of phase 9 served on the card (kernels) and on the
    CPU (plain versions) from the same weights and noise, guided requests
    (one with a negative-prompt vector) under FasterCacheCFG: TaylorSeer
    with both modes, TeaCache (one device-to-host copy a tick in the plan;
    0 with two static branches), and the dense engine."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl").reduced(num_layers=3, d_model=128, num_heads=4,
                                       num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    cpu_params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    gpu_params = _to(cpu_params, "cuda")
    vec = 0.02 * np.random.default_rng(7).standard_normal(
        cfg.d_model).astype(np.float32)

    def noise(req):
        g = torch.Generator().manual_seed(1000 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i in (0, 1, 3) else 0.0,
                             null_label=vec if i == 3 else None)
            for i in range(4)]
    cases = [  # name, cond policy, its kwargs, cfg mode, compacted
        ("taylorseer extrapolate", "taylorseer", {}, "extrapolate", True),
        ("taylorseer lowfreq", "taylorseer", {}, "lowfreq", True),
        ("teacache extrapolate", "teacache", CHECK_POLICIES["teacache"],
         "extrapolate", True),
        ("taylorseer extrapolate dense", "taylorseer", {}, "extrapolate",
         False)]
    for label, name, kw, mode, compact in cases:
        out, engs = {}, {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            engs[dev] = DiffusionServingEngine(
                p, cfg, make_policy(name, num_steps=12, **kw), slots=2,
                max_steps=12, cfg_policy=FasterCacheCFG(3, 12, mode=mode),
                row_compaction=compact, noise_fn=noise, device=dev)
            out[dev] = drive(engs[dev], reqs, record=True)
        (gres, glog), (cres, clog) = out["cuda"], out["cpu"]
        margin = least_margin(clog)
        if margin is not None and margin < MARGIN:
            fail(f"check-cfg {label}: a decision of the CPU reference lies "
                 f"{margin:.3e} relative from its threshold (< {MARGIN})")
        steps = {d: [(r.record.computed_steps,
                      r.record.uncond_computed_steps) for r in out[d][0]]
                 for d in out}
        if steps["cuda"] != steps["cpu"] or glog["kinds"] != clog["kinds"]:
            fail(f"check-cfg {label}: card and CPU decide differently: "
                 f"(cond, uncond) steps {steps}, tick kinds {glog['kinds']} "
                 f"vs {clog['kinds']}")
        worst = rel_err(gres, cres)
        kinds = clog["kinds"]
        extra = ""
        if compact:
            rb = plan_readbacks(torch, engs["cuda"], reqs)
            want = 1 if name == "teacache" else 0
            extra = (f", plan DtoH copies "
                     f"{check_plan_copies(f'check-cfg {label}', rb, want)}")
        log(f"check-cfg {label}: reduced DiT served on the card vs the CPU: "
            f"(cond, uncond) computed steps {steps['cpu']} identical, "
            f"{len(kinds)} tick kinds identical (full {kinds.count('full')}, "
            f"cond {kinds.count('cond')}, skip {kinds.count('skip')}), "
            f"least margin {margin}, max rel err {worst:.3e} (tol 1e-3)"
            f"{extra}")
        if not worst <= 1e-3:
            fail(f"check-cfg {label}: card and CPU disagree (rel err {worst})")


def load_example(name):
    """examples/<name>.py as a module (its `run` drives the steps)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def phase_serve_diffusion(torch, kernels, path, params, cfg):
    """examples/torch_serve_diffusion.py's three steps (autotune per traffic
    class, per-class serving, the guided FasterCacheCFG pool) on full-width
    DiT-XL, through the example's own `run`."""
    example = load_example("torch_serve_diffusion")
    out, launches = _count_launches(
        kernels, path, "serve-diffusion",
        lambda: example.run(params, cfg, "cuda",
                            log=lambda m: log(f"serve-diffusion: {m}")))
    for tc, t in out["tuned"].items():
        s = out["served"][tc]
        log(f"serve-diffusion: {tc}: picked {t.policy_name} {t.kwargs} "
            f"psnr={t.psnr:.4f} dB (agreement with the exact trajectory on "
            f"random weights, not image quality) "
            f"compute_fraction={t.compute_fraction:.4f}; served "
            f"throughput_rps={s['throughput_rps']:.4f} "
            f"latency_p50_s={s['latency_p50_s']:.4f} "
            f"latency_p95_s={s['latency_p95_s']:.4f} ticks={s['ticks']}")
    g = out["guided"]
    full, cond, skip = out["tick_mix"]
    log(f"serve-diffusion: guided pool: throughput_rps="
        f"{g['throughput_rps']:.4f} ticks full {full} cond {cond} skip "
        f"{skip}, uncond_rows_computed={g['uncond_rows_computed']} "
        f"uncond_rows_saved={g['uncond_rows_saved']}; autotune "
        f"{out['autotune_s']:.2f}s wall; launches {launches}")
    if g["uncond_rows_saved"] <= 0:
        fail("serve-diffusion: the guided pool saved no uncond row")
    return launches


# serve-video: teacache_video's threshold at full width, chosen so that the
# slots diverge (some ticks gather fewer rows than there are active slots)
VIDEO_DELTA = 0.5
# check-video (dit-video SMOKE): splits the requests' steps with every
# thresholded decision of the CPU reference >= MARGIN from it
CHECK_VIDEO_DELTA = 0.2


def full_video(torch):
    """serve-video's model: full-width, full-depth dit-video (28 layers,
    d_model 1152, 16 frames x 256 patches), bf16 params, random weights
    from seed 0 with the AdaLN gates perturbed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    cfg = get_config("dit-video")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)


def video_requests(cfg):
    """serve-video's traffic: 4 unguided requests, budgets 8 and 16."""
    from repro_torch.serving.diffusion import DiffusionRequest
    return [DiffusionRequest(i, num_steps=(8, 16)[i % 2], seed=i,
                             class_label=(37 * i) % cfg.dit_num_classes,
                             modality="video")
            for i in range(4)]


def phase_serve_video(torch, kernels, flash, forecast, params, cfg):
    """Full-width dit-video behind DiffusionServingEngine(slots=2,
    max_steps=16): TaylorSeer (forecast kernel on its skip ticks), then
    teacache_video (frames 16, max; the device want pass, 1 DtoH a tick)."""
    from repro_torch.core import make_policy
    from repro_torch.serving.diffusion import DiffusionServingEngine
    reqs = video_requests(cfg)
    passes = 2 * cfg.num_layers      # flash: spatial + temporal per layer
    out = {}
    for name, kw, path in (
            ("taylorseer", {"interval": 4, "order": 2}, (flash, forecast)),
            ("teacache_video", {"delta": VIDEO_DELTA, "frames": 16,
                                "reduce": "max"}, (flash,))):
        phase = f"serve-video-{name}"
        pol = make_policy(name, num_steps=16, **kw)
        eng = DiffusionServingEngine(params, cfg, pol, slots=2, max_steps=16,
                                     device="cuda")
        t0 = time.perf_counter()
        buckets = eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (res, trace), launches = _count_launches(
            kernels, path, phase, lambda: drive(eng, reqs, record=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if len(res) != len(reqs):
            fail(f"{phase}: {len(res)} of {len(reqs)} requests finished")
        for r in res:
            if r.x0.shape != (cfg.dit_tokens, cfg.dit_in_dim) or \
                    not math.isfinite(float(abs(r.x0).max())):
                fail(f"{phase}: request {r.request_id} x0 {r.x0.shape} not "
                     f"finite or misshapen")
        check_rows(phase, res, reqs, trace)
        s, tel = eng.telemetry.summary(), eng.telemetry
        per_pass = launches["flash_attention"] / max(tel.ticks_backbone, 1)
        if launches["flash_attention"] != passes * tel.ticks_backbone:
            fail(f"{phase}: {launches['flash_attention']} flash launches in "
                 f"{tel.ticks_backbone} backbone passes, want {passes} each")
        extra = ""
        if name == "taylorseer":
            for r, req in zip(res, reqs):
                want = sum(pol.static_schedule(req.num_steps))
                if r.record.computed_steps != want:
                    fail(f"{phase}: request {r.request_id} computed "
                         f"{r.record.computed_steps}, schedule says {want}")
        else:
            vals = sorted(float(p.value[i]) for a, p in trace["plans"]
                          for i in range(len(a)) if a[i] and not p.forced[i])
            margin = least_margin(trace)
            extra = (f"delta {VIDEO_DELTA}: {trace['split']} ticks gathered "
                     f"fewer cond rows than active slots; thresholded values "
                     f"min {vals[0]:.4f} median {vals[len(vals) // 2]:.4f} "
                     f"max {vals[-1]:.4f}, least margin {margin}; ")
            if s["backbone_rows_saved"] <= 0 or trace["split"] == 0:
                fail(f"{phase}: at delta {VIDEO_DELTA} no row saved or no "
                     f"tick split the slots ({extra})")
        plan_ms = 1e3 * sum(trace["plan_s"]) / len(trace["plan_s"])
        log(f"{phase}: {kw} {extra}{s['requests']} requests in "
            f"{wall:.3f}s wall (warmup {warm_s:.2f}s, buckets {buckets}), "
            f"throughput_rps={s['throughput_rps']:.4f} "
            f"latency_p50_s={s['latency_p50_s']:.3f} "
            f"latency_p95_s={s['latency_p95_s']:.3f} ticks={s['ticks']} "
            f"(full {tel.ticks_full}, cond {tel.ticks_cond}, skip "
            f"{tel.ticks_skip}) "
            f"tick_ms_backbone_mean={s['tick_ms_backbone_mean']:.3f} "
            f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
            f"backbone_rows_computed={s['backbone_rows_computed']} "
            f"backbone_rows_padding={s['backbone_rows_padding']} "
            f"backbone_rows_saved={s['backbone_rows_saved']} "
            f"computed_steps={[r.record.computed_steps for r in res]} "
            f"flash_per_backbone_pass={per_pass:g} (want {passes}) "
            f"forecast_launches={launches['forecast']} "
            f"plan_host_ms_per_tick={plan_ms:.4f} peak_mem_gb={peak:.2f} "
            f"cache_state_bytes_per_slot={s['cache_state_bytes_per_slot']} "
            f"launches {launches}")
        if name == "taylorseer":
            log_profile(torch, phase, lambda: eng.serve(reqs))
        else:
            rb = plan_readbacks(torch, eng, reqs)
            note = check_plan_copies(phase, rb, 1)
            log(f"{phase}: plan DtoH copies {note} ({rb['dtoh_total']} DtoH "
                f"in all, by operator {rb['dtoh_by_op']}); "
                f"idle_share={rb['idle_share']:.3f} (profiled wall "
                f"{rb['wall_ms']:.1f} ms, device kernels "
                f"{rb['busy_ms']:.1f} ms)")
        out[phase] = launches
        del eng
    torch.cuda.empty_cache()
    return out


def phase_denoise_video(torch, kernels, flash, params, cfg):
    """CachedDenoiser on full-width dit-video, batch 1, 16 DDIM steps:
    exact, pab_video (default ranges), block under FORA 2, deepcache under
    Δ-DiT 2 with shallow_n 4; ms per step, compute fraction, relative L2
    error of x0 against exact."""
    from repro_torch.core import compute_fraction, make_policy
    from repro_torch.diffusion import (CachedDenoiser, ddim_step,
                                       linear_schedule, sample)
    sched = linear_schedule(1000)
    ts = sched.spaced(16)
    xT = torch.randn((1, cfg.dit_tokens, cfg.dit_in_dim),
                     generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda")
    cases = [("exact", "model", None, {}),
             ("pab_video", "pab_video", None, {}),
             ("block fora 2", "block", "fora", {"interval": 2}),
             ("deepcache delta_dit 2", "deepcache", "delta_dit",
              {"interval": 2})]
    exact, total = None, no_launches(kernels)
    for label, gran, name, kw in cases:
        pol = make_policy(name, **kw) if name else None
        den = CachedDenoiser(params, cfg, pol, granularity=gran, shallow_n=4,
                             device="cuda")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (x0, _), launches = _count_launches(
            kernels, (flash,), f"denoise-video {label}",
            lambda: sample(den, xT, ts, sched, step_fn=ddim_step,
                           denoiser_state=den.init_state(1)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(ts)
        for k, n in launches.items():
            total[k] += n
        if not bool(torch.isfinite(x0).all()):
            fail(f"denoise-video {label}: x0 not finite")
        # the fraction of branch (pab_video) or block evaluations run
        L = cfg.num_layers
        if gran == "pab_video":
            cf = den._stack.compute_fraction(len(ts))
        elif gran == "model":
            cf = 1.0
        else:
            cf = compute_fraction(pol.static_schedule(len(ts)))
            if gran == "deepcache":       # the shallow blocks always run
                sh = min(den.shallow_n, L)
                cf = (sh + (L - sh) * cf) / L
        if exact is None:
            exact, err = x0, 0.0
        else:
            err = float(torch.linalg.vector_norm(x0 - exact)
                        / torch.linalg.vector_norm(exact))
        log(f"denoise-video {label}: {len(ts)} DDIM steps, batch 1, "
            f"ms_per_step={ms:.2f} compute_fraction={cf:.4f} "
            f"rel_l2_err_vs_exact={err:.4e} "
            f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"launches {launches}")
        del den
    torch.cuda.empty_cache()
    return total


def phase_check_video(torch):
    """dit-video SMOKE with the same weights on the card (kernels) and the
    CPU (plain versions): served under teacache_video and TaylorSeer (the
    same decisions and tick kinds, x0 within 1e-3 relative), then
    CachedDenoiser under pab_video, block and deepcache (x0 within 1e-3
    relative)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_policy
    from repro_torch.diffusion import (CachedDenoiser, ddim_step,
                                       linear_schedule, sample)
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_smoke_config("dit-video")
    gen = torch.Generator().manual_seed(3)
    cpu_params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    gpu_params = _to(cpu_params, "cuda")

    def noise(req):
        g = torch.Generator().manual_seed(100 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i == 1 else 0.0)
            for i in range(3)]
    for name, kw in (("teacache_video", {"delta": CHECK_VIDEO_DELTA}),
                     ("taylorseer", {})):
        out = {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = DiffusionServingEngine(
                p, cfg, make_policy(name, num_steps=12, frames=4, **kw),
                slots=2, max_steps=12, noise_fn=noise, device=dev)
            out[dev] = drive(eng, reqs, record=True)
        (gres, glog), (cres, clog) = out["cuda"], out["cpu"]
        margin = least_margin(clog)
        if margin is not None and margin < MARGIN:
            fail(f"check-video {name}: a decision of the CPU reference lies "
                 f"{margin:.3e} relative from its threshold (< {MARGIN})")
        steps = {d: [r.record.computed_steps for r in out[d][0]] for d in out}
        if steps["cuda"] != steps["cpu"] or glog["kinds"] != clog["kinds"]:
            fail(f"check-video {name}: card and CPU decide differently: "
                 f"computed steps {steps}, tick kinds {glog['kinds']} vs "
                 f"{clog['kinds']}")
        worst = rel_err(gres, cres)
        kinds = clog["kinds"]
        log(f"check-video {name}: dit-video SMOKE served on the card vs the "
            f"CPU: computed steps {steps['cpu']} identical, {len(kinds)} "
            f"tick kinds identical (full {kinds.count('full')}, cond "
            f"{kinds.count('cond')}, skip {kinds.count('skip')}), least "
            f"margin {margin}, max rel err {worst:.3e} (tol 1e-3)")
        if not worst <= 1e-3:
            fail(f"check-video {name}: card and CPU disagree ({worst})")
    sched = linear_schedule(1000)
    xT = noise(reqs[0])[None]
    for gran, name, kw in (("pab_video", None, {}),
                           ("block", "fora", {"interval": 2}),
                           ("deepcache", "delta_dit", {"interval": 2})):
        x0 = {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            den = CachedDenoiser(p, cfg, make_policy(name, **kw) if name
                                 else None, granularity=gran, shallow_n=1,
                                 device=dev)
            x0[dev], _ = sample(den, xT.to(dev), sched.spaced(8), sched,
                                step_fn=ddim_step,
                                denoiser_state=den.init_state(1))
        worst = float((x0["cuda"].cpu() - x0["cpu"]).abs().max()
                      / x0["cpu"].abs().max())
        log(f"check-video CachedDenoiser {gran}: 8 DDIM steps on the card "
            f"vs the CPU, max rel err {worst:.3e} (tol 1e-3)")
        if not worst <= 1e-3:
            fail(f"check-video {gran}: card and CPU disagree ({worst})")


def phase_serve_mixed(torch, kernels, path):
    """examples/torch_mixed_modality_serving.py's steps (autotune per
    modality, the mixed image + video + audio pool, the example's traffic)
    on full-width dit-xl, dit-video and dit-audio, through its `run`."""
    from repro_torch.modalities import make_workload
    example = load_example("torch_mixed_modality_serving")
    dit_cfg, dit_params = full_dit(torch)
    video_cfg, video_params = full_video(torch)
    workloads = {
        "image": make_workload("image", cfg=dit_cfg, params=dit_params),
        "video": make_workload("video", cfg=video_cfg, params=video_params),
        "audio": make_workload("audio", seed=0, device="cuda")}
    out, launches = _count_launches(
        kernels, path, "serve-mixed",
        lambda: example.run(workloads,
                            log=lambda m: log(f"serve-mixed: {m.strip()}")))
    tel = out["engine"].telemetry
    s = tel.summary()
    for m, t in out["tuned"].items():
        ms = tel.by_modality()[m]
        log(f"serve-mixed: {m}: picked {t.policy_name} {t.kwargs} "
            f"psnr={t.psnr:.4f} dB (agreement with the exact trajectory on "
            f"random weights) compute_fraction={t.compute_fraction:.4f} "
            f"autotune_s={out['autotune_s'][m]:.2f}; served "
            f"requests={ms['requests']} "
            f"throughput_rps={ms['throughput_rps']:.4f} "
            f"latency_p50_s={ms['latency_p50_s']:.4f} "
            f"latency_p95_s={ms['latency_p95_s']:.4f} "
            f"backbone_rows_computed={ms['backbone_rows_computed']} "
            f"backbone_rows_saved={ms['backbone_rows_saved']} "
            f"row_tokens={tel.row_tokens[m]} ticks={ms['ticks']}")
    log(f"serve-mixed: {s['requests']} requests in {s['elapsed_s']:.3f}s, "
        f"throughput_rps={s['throughput_rps']:.4f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"backbone_rows_saved={s['backbone_rows_saved']} "
        f"backbone_tokens_computed={s['backbone_tokens_computed']} "
        f"backbone_tokens_saved={s['backbone_tokens_saved']} "
        f"rows_by_modality={s['rows_by_modality']} launches {launches}")
    if s["requests"] != 9:
        fail(f"serve-mixed: {s['requests']} of 9 requests finished")
    return launches


# ----------------------------------------------------------------------
# slice 8: text conditioning (dit-t2i, dit-t2v)
# ----------------------------------------------------------------------

# check-text (SMOKE): TeaCache thresholds that split the requests' steps
# with every thresholded decision of the CPU reference >= MARGIN from them
CHECK_TEXT_DELTA = {"dit-t2i": 0.3, "dit-t2v": 0.3}
TEXT_PROMPTS = ("a photo of a red fox in the snow",
                "a watercolor painting of a lighthouse",
                "an isometric render of a tiny city")
TEXT_NEG = "blurry, low quality"


def full_text(torch, arch):
    """serve-t2i's / serve-t2v's model: full width and depth, bf16 params,
    random weights from seed 0 with the AdaLN gates (the cross branch's
    too) perturbed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)


class counting:
    """Count the calls of module.<name> inside the block (callers look the
    function up through the module at call time, so every call counts)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def text_requests(cfg, n, steps, guided=(), neg=None, modality="t2i"):
    """Prompted requests cycling TEXT_PROMPTS (so prompts repeat); those in
    `guided` at cfg_scale 4.0, request `neg` with TEXT_NEG."""
    from repro_torch.serving.diffusion import DiffusionRequest
    return [DiffusionRequest(i, num_steps=steps[i % len(steps)], seed=i,
                             class_label=(37 * i) % cfg.dit_num_classes,
                             cfg_scale=4.0 if i in guided else 0.0,
                             prompt_tokens=TEXT_PROMPTS[i % 3],
                             neg_prompt_tokens=TEXT_NEG if i == neg else None,
                             modality=modality)
            for i in range(n)]


def admission_waves(res):
    """The ticks at which requests were admitted (one text-table build
    each)."""
    return len({r.record.admit_tick for r in res})


def marked_profile(torch, label, targets, fn, record_shapes=False):
    """Run fn() under the profiler with every function `targets` names
    ((module, attribute) pairs; callers look them up through the module at
    call time) wrapped in record_function(label).  Returns (device ms of
    the kernels launched under the range, of all kernels linked to an
    operator, of all device events by name as `log_profile` sums them, the
    profiled wall ms, the profiler)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as prof_ctx
    origs = [getattr(m, a) for m, a in targets]

    def marked(orig):
        def run(*a, **k):
            with record_function(label):
                return orig(*a, **k)
        return run

    for (m, a), orig in zip(targets, origs):
        setattr(m, a, marked(orig))
    try:
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      record_shapes=record_shapes) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (m, a), orig in zip(targets, origs):
            setattr(m, a, orig)

    def inside(e):
        while e is not None and e.name != label:
            e = e.cpu_parent
        return e is not None

    part = total = 0.0
    for e in prof.events():
        if not str(e.device_type).endswith("CPU"):
            continue
        us = sum(k.duration for k in e.kernels)
        total += us
        if us and inside(e):
            part += us
    by_name = sum(_self_device_us(e) for e in prof.key_averages()
                  if _self_device_us(e) > 0 and e.key != label
                  and str(e.device_type).endswith("CUDA"))
    return part / 1e3, total / 1e3, by_name / 1e3, wall * 1e3, prof


def cross_attn_profile(torch, fn):
    """Run fn() under the profiler with every cross-attention branch marked;
    returns (device ms of the kernels launched under the branch, of all
    kernels linked to an operator, of all device events by name as
    `log_profile` sums them, and the profiled wall ms)."""
    from repro_torch.models import dit, video_dit
    return marked_profile(torch, "repro_cross_attn",
                          [(dit, "cross_attn_branch"),
                           (video_dit, "cross_attn_branch")], fn)[:4]


def log_cross_share(torch, label, fn):
    cross, linked, by_name, pwall = cross_attn_profile(torch, fn)
    share = cross / linked if linked else math.nan
    log(f"{label}: profiled: cross-attention {cross:.1f} ms of {linked:.1f} "
        f"ms of kernels linked to operators (share {share:.4f}); "
        f"device events by name {by_name:.1f} ms; idle share "
        f"{1 - by_name / pwall:.3f} (profiled wall {pwall:.1f} ms)")


def time_cross_attention(torch, F, label, cfg, B, T):
    """The cross-attention core (`models.dit.cross_attention`: einsum, the
    -1e9 key mask, softmax, einsum) at a path's shape, f32, against masked
    scaled_dot_product_attention on the same inputs (a yardstick: the port
    does not call it): max |difference|, ms each (CUDA events), and the
    bound."""
    from repro_torch.models.dit import cross_attention
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.dit_text_len
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((B, T, H, hd), generator=g, device="cuda")
    k = torch.randn((B, L, H, hd), generator=g, device="cuda")
    v = torch.randn((B, L, H, hd), generator=g, device="cuda")
    n = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    tm = torch.arange(L, device="cuda")[None] < n[:, None]
    k, v = k * tm[..., None, None], v * tm[..., None, None]

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=tm[:, None, None, :]).transpose(1, 2)

    err = float((cross_attention(q, k, v, tm) - sdpa()).abs().max())
    ms = cuda_ms(torch, lambda: cross_attention(q, k, v, tm))
    sdpa_ms = cuda_ms(torch, sdpa)
    nbytes = 4 * (2 * q.numel() + 2 * k.numel()) + tm.numel()
    b, by = bound(nbytes, 4.0 * B * H * T * L * hd, PEAK_FLOPS["float32"])
    log(f"{label}: cross-attention (B {B}, T {T}, L {L}, H {H}, D {hd}, "
        f"f32, prompt lengths {n.tolist()}): ms={ms:.4f} (einsum, where, "
        f"softmax, einsum) sdpa_ms={sdpa_ms:.4f} (masked SDPA, yardstick) "
        f"max_abs_diff={err:.3e} bound_ms={b:.4f} ({by})")
    if not err <= 1e-4:
        fail(f"{label}: the cross-attention and masked SDPA disagree ({err})")
    return {"ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": b}


def check_prompt_moves_x0(phase, eng, steps):
    """The same request (id, seed, class, noise) under two prompts through
    a deterministic path: x0 must differ by more than rounding (1e-5 of
    its largest value), so the prompt reached the perturbed cross gates."""
    from repro_torch.serving.diffusion import DiffusionRequest
    x0 = [eng.serve([DiffusionRequest(0, num_steps=steps, seed=0,
                                      prompt_tokens=p)])[0].x0
          for p in TEXT_PROMPTS[:2]]
    diff = float(abs(x0[0] - x0[1]).max())
    log(f"{phase}: one request under two prompts: max |dx0| {diff:.4e} "
        f"(max |x0| {float(abs(x0[0]).max()):.4e})")
    if not diff > 1e-5 * float(abs(x0[0]).max()):
        fail(f"{phase}: two prompts gave the same x0 ({diff})")


def text_kv_replays(eng) -> int:
    """Replays of the engine's "text_kv" program (a CUDA-graph replay runs
    no Python, so `counting` does not see it)."""
    return sum(p.replays for _, p, _ in eng._programs.get("text_kv", ()))


def check_text_counts(phase, eng, cond, res, builds, kv_calls, misses):
    """Text-table builds equal the admission waves, the only text_kv calls
    are those builds (none in a tick), the encoder ran once per unique
    prompt."""
    waves = admission_waves(res)
    if builds != waves or kv_calls != builds:
        fail(f"{phase}: {builds} text-table builds and {kv_calls} text_kv "
             f"calls for {waves} admission waves")
    if cond.misses != misses:
        fail(f"{phase}: {cond.misses} encoder runs, want {misses}")
    return waves


def phase_serve_t2i(torch, kernels, flash, forecast, F, cfg_summary):
    """examples/torch_text_to_image_serving.py's `run` on full-width
    dit-t2i (TeaCache 0.1 + FasterCacheCFG(4, 12), 2 slots), the same
    queue again through `drive`, then 8 prompted requests under TaylorSeer
    with FasterCacheCFG(4), 4 slots, against serve-cfg's ticks."""
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.modalities import make_workload
    from repro_torch.models import dit
    example = load_example("torch_text_to_image_serving")
    held = torch.cuda.memory_allocated() / 1e9      # earlier phases' params
    cfg, params = full_text(torch, "dit-t2i")
    wl = make_workload("t2i", cfg=cfg, params=params)
    L = cfg.num_layers
    out_paths = {}
    torch.cuda.reset_peak_memory_stats()
    with counting(dit, "text_kv") as kv:
        t0 = time.perf_counter()
        out, launches = _count_launches(
            kernels, (flash,), "serve-t2i",
            lambda: example.run(wl, log=lambda m: log(f"serve-t2i: {m.strip()}")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng, cond, res = out["engine"], out["conditioner"], out["results"]
    tel, s = eng.telemetry, eng.telemetry.summary()
    # warmup runs each backbone program once per compiled graph (its eager
    # run under the FLOP counter; a capture launches nothing) and replays
    # a graph for each input class it already covers (engine.warmup_runs)
    warm = sum(n for k, n in eng.warmup_runs.items()
               if isinstance(k, int) and k > 0)
    if launches["flash_attention"] != L * (tel.ticks_backbone + warm):
        fail(f"serve-t2i: {launches['flash_attention']} flash launches for "
             f"{tel.ticks_backbone} served + {warm} warmup backbone passes, "
             f"want {L} each")
    unique = len(set(example.PROMPTS) | {example.NEG_PROMPT})
    waves = check_text_counts("serve-t2i", eng, cond, res,
                              eng.text_table_builds,
                              kv.calls - 2 + text_kv_replays(eng), unique)
    log(f"serve-t2i: example run {wall:.3f}s wall (warmup included): "
        f"{s['requests']} requests, throughput_rps={s['throughput_rps']:.4f} "
        f"latency_p50_s={s['latency_p50_s']:.3f} "
        f"latency_p95_s={s['latency_p95_s']:.3f} ticks={s['ticks']} (full "
        f"{tel.ticks_full}, cond {tel.ticks_cond}, skip {tel.ticks_skip}) "
        f"tick_ms_full_mean={s['tick_ms_full_mean']:.3f} "
        f"tick_ms_cond_mean={s['tick_ms_cond_mean']:.3f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"backbone_rows_saved={s['backbone_rows_saved']} "
        f"uncond_rows_computed={s['uncond_rows_computed']} "
        f"computed_steps={[r.record.computed_steps for r in res]} "
        f"encoder_runs={cond.misses} (unique prompts {unique}, hits "
        f"{cond.hits}) text_table_builds={eng.text_table_builds} "
        f"(admission waves {waves}; text_kv calls {kv.calls}, two of them "
        f"warmup's) flash_per_backbone_pass={L} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"(of which {held:.2f} held by earlier phases) launches {launches}")
    out_paths["serve-t2i"] = launches

    # the example's queue again, tick by tick: the plan's rows
    reqs = example.requests()
    eng.text_table_builds, misses = 0, cond.misses
    replays = text_kv_replays(eng)
    with counting(dit, "text_kv") as kv:
        (res2, trace), launches = _count_launches(
            kernels, (flash,), "serve-t2i drive",
            lambda: drive(eng, reqs, record=True))
    check_rows("serve-t2i drive", res2, reqs, trace)
    check_text_counts("serve-t2i drive", eng, cond, res2,
                      eng.text_table_builds,
                      kv.calls + text_kv_replays(eng) - replays, misses)
    if launches["flash_attention"] != L * eng.telemetry.ticks_backbone:
        fail(f"serve-t2i drive: {launches['flash_attention']} flash launches "
             f"in {eng.telemetry.ticks_backbone} backbone passes")
    log(f"serve-t2i drive: the example's queue again: computed steps "
        f"{[r.record.computed_steps for r in res2]} = the plan's rows, "
        f"least margin {least_margin(trace)}, every encoder call a hit "
        f"({cond.hits} hits), text_table_builds={eng.text_table_builds} = "
        f"admission waves, launches {launches}")
    del eng, out, res, res2

    # TaylorSeer 4/2 + FasterCacheCFG(4): serve-cfg's traffic, prompted
    cond_pol, cfg_pol = make_policy("taylorseer"), FasterCacheCFG(4, 16)
    eng = wl.engine("taylorseer", slots=4, max_steps=16,
                    cfg_policy=FasterCacheCFG(4, 16), conditioner=cond)
    eng.warmup()
    reqs = text_requests(cfg, 8, (8, 16), guided=CFG_GUIDED, neg=CFG_VECTOR)
    misses = cond.misses + 0
    replays = text_kv_replays(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(dit, "text_kv") as kv:
        t0 = time.perf_counter()
        (res, trace), launches = _count_launches(
            kernels, (flash, forecast), "serve-t2i-taylorseer",
            lambda: drive(eng, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_cfg_rows("serve-t2i-taylorseer", res, reqs, trace, cond_pol,
                   cfg_pol)
    tel, s = eng.telemetry, eng.telemetry.summary()
    if launches["flash_attention"] != L * tel.ticks_backbone:
        fail(f"serve-t2i-taylorseer: {launches['flash_attention']} flash "
             f"launches in {tel.ticks_backbone} backbone passes")
    waves = check_text_counts("serve-t2i-taylorseer", eng, cond, res,
                              eng.text_table_builds,
                              kv.calls + text_kv_replays(eng) - replays,
                              misses)
    table_mb = 4 * L * cfg.dit_text_len * cfg.d_model * 4 / 1e6
    log(f"serve-t2i-taylorseer: {s['requests']} requests "
        f"({s['guided_requests']} guided, one negative prompt) in "
        f"{wall:.3f}s wall, throughput_rps={s['throughput_rps']:.4f} "
        f"(serve-cfg {cfg_summary['throughput_rps']:.4f}) "
        f"latency_p50_s={s['latency_p50_s']:.3f} "
        f"latency_p95_s={s['latency_p95_s']:.3f} ticks={s['ticks']} (full "
        f"{tel.ticks_full}, cond {tel.ticks_cond}, skip {tel.ticks_skip}) "
        f"tick_ms_full_mean={s['tick_ms_full_mean']:.3f} (serve-cfg "
        f"{cfg_summary['tick_ms_full_mean']:.3f}) "
        f"tick_ms_cond_mean={s['tick_ms_cond_mean']:.3f} (serve-cfg "
        f"{cfg_summary['tick_ms_cond_mean']:.3f}) "
        f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"uncond_rows_computed={s['uncond_rows_computed']} "
        f"text_table_builds={eng.text_table_builds} (admission waves "
        f"{waves}, text_kv calls {kv.calls}) text_tables_mb_per_slot="
        f"{table_mb:.1f} peak_mem_gb={peak:.2f} (of which {held:.2f} held "
        f"by earlier phases) launches {launches}")
    out_paths["serve-t2i-taylorseer"] = launches
    # eagerly: a graph replay has no operator for the profiler to mark
    eng.release_programs()
    log_cross_share(torch, "serve-t2i-taylorseer", lambda: eng.serve(reqs))
    check_prompt_moves_x0("serve-t2i", eng, 8)
    time_cross_attention(torch, F, "serve-t2i", cfg, 8, cfg.dit_tokens)
    del eng, params, wl
    torch.cuda.empty_cache()
    return out_paths


def phase_check_text(torch):
    """dit-t2i and dit-t2v SMOKE with their text encoders on the card
    (kernels) and the CPU (plain versions), the same weights, prompts and
    noise: under TeaCache with FasterCacheCFG and under TaylorSeer the same
    decisions and tick kinds (every thresholded decision of the CPU
    reference >= MARGIN from its threshold), the same text-table builds
    and encoder runs, x0 within 1e-3 relative; the prompt-less forward is
    a bit-exact no-op on the card."""
    import dataclasses
    from repro_torch.conditioning import (PromptCache, init_text_encoder,
                                          text_encoder_config)
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.models import (dit, init_params, perturb_zero_init,
                                    video_dit)
    from repro_torch.serving.diffusion import DiffusionServingEngine
    for arch in ("dit-t2i", "dit-t2v"):
        cfg = get_smoke_config(arch)
        gen = torch.Generator().manual_seed(3)
        cpu_params = perturb_zero_init(init_params(gen, cfg, device="cpu"),
                                       gen)
        tc = text_encoder_config(cfg)
        cpu_enc = init_text_encoder(torch.Generator().manual_seed(4), tc,
                                    device="cpu")
        params = {"cuda": _to(cpu_params, "cuda"), "cpu": cpu_params}
        encs = {"cuda": _to(cpu_enc, "cuda"), "cpu": cpu_enc}

        def noise(req):
            g = torch.Generator().manual_seed(100 + req.request_id)
            return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

        reqs = text_requests(cfg, 4, (8, 12), guided=(0, 1, 3), neg=0)
        reqs[2] = dataclasses.replace(reqs[2], prompt_tokens=None)
        for label, name, kw, cfg_pol in (
                ("teacache + FasterCacheCFG", "teacache",
                 {"delta": CHECK_TEXT_DELTA[arch]}, FasterCacheCFG(3, 12)),
                ("taylorseer", "taylorseer", {}, None)):
            out, counts = {}, {}
            for dev in ("cuda", "cpu"):
                cond = PromptCache(encs[dev], tc)
                eng = DiffusionServingEngine(
                    params[dev], cfg, make_policy(name, num_steps=12, **kw),
                    slots=2, max_steps=12, cfg_policy=cfg_pol,
                    conditioner=cond, noise_fn=noise, device=dev)
                out[dev] = drive(eng, reqs, record=True)
                counts[dev] = (eng.text_table_builds, cond.misses)
            (gres, glog), (cres, clog) = out["cuda"], out["cpu"]
            margin = least_margin(clog)
            if margin is not None and margin < MARGIN:
                fail(f"check-text {arch} {label}: a decision of the CPU "
                     f"reference lies {margin:.3e} relative from its "
                     f"threshold (< {MARGIN})")
            steps = {d: [(r.record.computed_steps,
                          r.record.uncond_computed_steps)
                         for r in out[d][0]] for d in out}
            if steps["cuda"] != steps["cpu"] or \
                    glog["kinds"] != clog["kinds"] or \
                    counts["cuda"] != counts["cpu"]:
                fail(f"check-text {arch} {label}: card and CPU decide "
                     f"differently: (cond, uncond) steps {steps}, kinds "
                     f"{glog['kinds']} vs {clog['kinds']}, (builds, "
                     f"encoder runs) {counts}")
            worst = rel_err(gres, cres)
            kinds = clog["kinds"]
            log(f"check-text {arch} {label}: SMOKE served on the card vs "
                f"the CPU: (cond, uncond) computed steps {steps['cpu']} "
                f"identical, {len(kinds)} tick kinds identical (full "
                f"{kinds.count('full')}, cond {kinds.count('cond')}, skip "
                f"{kinds.count('skip')}), (text-table builds, encoder runs) "
                f"{counts['cpu']} identical, least margin {margin}, max rel "
                f"err {worst:.3e} (tol 1e-3)")
            if not worst <= 1e-3:
                fail(f"check-text {arch} {label}: card and CPU disagree "
                     f"({worst})")
        # the prompt-less forward on the card: bit-exact no-op
        mod = video_dit if cfg.dit_num_frames else dit
        p = params["cuda"]
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((2, cfg.dit_tokens, cfg.dit_in_dim), generator=g,
                        device="cuda")
        t = torch.tensor([10.0, 600.0], device="cuda")
        y = torch.tensor([1, 7], device="cuda")
        skipped = mod.forward(p, x, t, y,
                              dataclasses.replace(cfg, dit_text_len=0))
        noop = mod.forward(p, x, t, y, cfg)
        masked = mod.forward(
            p, x, t, y, cfg,
            txt_embed=torch.randn((2, cfg.dit_text_len, cfg.d_model),
                                  generator=g, device="cuda"),
            txt_mask=torch.zeros((2, cfg.dit_text_len), dtype=torch.bool,
                                 device="cuda"))
        same = torch.equal(noop, skipped) and torch.equal(masked, skipped)
        log(f"check-text {arch}: prompt-less and all-masked forwards on the "
            f"card {'bit-identical' if same else 'DIFFER'} to the forward "
            f"without the cross branch")
        if not same:
            fail(f"check-text {arch}: the prompt-less forward is not a "
                 f"bit-exact no-op on the card")


def phase_serve_t2v(torch, kernels, flash, forecast, F):
    """Full-width dit-t2v, 2 slots, 4 prompted requests of 8 and 16 steps
    under TaylorSeer; CachedDenoiser under pab_video (cross_attn at range 6)
    against exact, 16 steps."""
    from repro_torch.core import make_policy
    from repro_torch.diffusion import (CachedDenoiser, ddim_step,
                                       linear_schedule, sample)
    from repro_torch.modalities import make_workload
    from repro_torch.models import dit
    held = torch.cuda.memory_allocated() / 1e9      # earlier phases' params
    cfg, params = full_text(torch, "dit-t2v")
    wl = make_workload("t2v", cfg=cfg, params=params)
    cond = wl.conditioner()
    pol = make_policy("taylorseer", interval=4, order=2, num_steps=16)
    eng = wl.engine(pol, slots=2, max_steps=16, conditioner=cond)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reqs = text_requests(cfg, 4, (8, 16), modality="t2v")
    passes = 2 * cfg.num_layers
    replays = text_kv_replays(eng)
    torch.cuda.reset_peak_memory_stats()
    with counting(dit, "text_kv") as kv:
        t0 = time.perf_counter()
        (res, trace), launches = _count_launches(
            kernels, (flash, forecast), "serve-t2v",
            lambda: drive(eng, reqs, record=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_rows("serve-t2v", res, reqs, trace)
    for r, req in zip(res, reqs):
        want = sum(pol.static_schedule(req.num_steps))
        if r.record.computed_steps != want or not math.isfinite(
                float(abs(r.x0).max())):
            fail(f"serve-t2v: request {r.request_id} computed "
                 f"{r.record.computed_steps} (schedule {want}) or x0 not "
                 f"finite")
    tel, s = eng.telemetry, eng.telemetry.summary()
    if launches["flash_attention"] != passes * tel.ticks_backbone:
        fail(f"serve-t2v: {launches['flash_attention']} flash launches in "
             f"{tel.ticks_backbone} backbone passes, want {passes} each")
    waves = check_text_counts("serve-t2v", eng, cond, res,
                              eng.text_table_builds,
                              kv.calls + text_kv_replays(eng) - replays, 3)
    log(f"serve-t2v: {s['requests']} prompted requests in {wall:.3f}s wall "
        f"(warmup {warm_s:.2f}s), throughput_rps={s['throughput_rps']:.4f} "
        f"latency_p50_s={s['latency_p50_s']:.3f} "
        f"latency_p95_s={s['latency_p95_s']:.3f} ticks={s['ticks']} "
        f"(backbone {tel.ticks_backbone}, skip {tel.ticks_skip}) "
        f"tick_ms_backbone_mean={s['tick_ms_backbone_mean']:.3f} "
        f"tick_ms_skip_mean={s['tick_ms_skip_mean']:.3f} "
        f"backbone_rows_computed={s['backbone_rows_computed']} "
        f"computed_steps={[r.record.computed_steps for r in res]} "
        f"flash_per_backbone_pass={passes} encoder_runs={cond.misses} "
        f"text_table_builds={eng.text_table_builds} (admission waves "
        f"{waves}, text_kv calls {kv.calls}) peak_mem_gb={peak:.2f} (of "
        f"which {held:.2f} held by earlier phases) launches {launches}")
    out_paths = {"serve-t2v": launches}
    eng.release_programs()      # eagerly (see serve-t2i)
    log_cross_share(torch, "serve-t2v", lambda: eng.serve(reqs))
    check_prompt_moves_x0("serve-t2v", eng, 8)
    del eng

    # single stream: exact against PAB over the four branches
    sched = linear_schedule(1000)
    ts = sched.spaced(16)
    xT = torch.randn((1, cfg.dit_tokens, cfg.dit_in_dim),
                     generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda")
    text = cond.get(TEXT_PROMPTS[0])
    exact, total = None, no_launches(kernels)
    for label, gran in (("exact", "model"), ("pab_video", "pab_video")):
        den = CachedDenoiser(params, cfg, granularity=gran, text=text,
                             device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (x0, _), launches = _count_launches(
            kernels, (flash,), f"denoise-t2v {label}",
            lambda: sample(den, xT, ts, sched, step_fn=ddim_step,
                           denoiser_state=den.init_state(1)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(ts)
        for k, n in launches.items():
            total[k] += n
        if not bool(torch.isfinite(x0).all()):
            fail(f"denoise-t2v {label}: x0 not finite")
        if gran == "pab_video":
            stack = den._stack
            if stack.intervals.get("cross_attn") != 6:
                fail(f"denoise-t2v: cross_attn range {stack.intervals}")
            cf = stack.compute_fraction(len(ts))
            err = float(torch.linalg.vector_norm(x0 - exact)
                        / torch.linalg.vector_norm(exact))
        else:
            exact, cf, err = x0, 1.0, 0.0
        log(f"denoise-t2v {label}: {len(ts)} DDIM steps, batch 1, prompted, "
            f"ms_per_step={ms:.2f} branch_compute_fraction={cf:.4f} "
            f"rel_l2_err_vs_exact={err:.4e} launches {launches}")
        del den
    out_paths["denoise-t2v"] = total
    time_cross_attention(torch, F, "serve-t2v", cfg, 2, cfg.dit_tokens)
    del params, wl, cond
    torch.cuda.empty_cache()
    return out_paths


# ----------------------------------------------------------------------
# slice 9: the online control plane and observability
# ----------------------------------------------------------------------

CONTROL_STEPS = 16
CONTROL_SWAP_TICK = 6
# the hand count of DiT-XL's products a row: 24 d^2 T L (QKV, output and
# the 4d MLP) + 4 T^2 d L (the attention's two products)
DIT_XL_HAND_FLOPS = 24 * 1152 ** 2 * 256 * 28 + 4 * 256 ** 2 * 1152 * 28


def control_requests(cfg, n, base=0):
    """n unguided requests of 8 and 16 steps."""
    from repro_torch.serving.diffusion import DiffusionRequest
    return [DiffusionRequest(base + i, num_steps=(8, 16)[i % 2],
                             seed=base + i,
                             class_label=(37 * (base + i))
                             % cfg.dit_num_classes)
            for i in range(n)]


def forced_swap(tuner, reqs, pick_name, at_tick):
    """Submit `reqs`, tick `at_tick` times, force one swap to the swept
    candidate `pick_name`, drain.  Returns (results, the ids admitted before
    the swap, the drain's wall seconds)."""
    t0 = time.perf_counter()
    tuner.submit_all(reqs)
    for _ in range(at_tick):
        tuner.tick()
    before = {rid for rid, rec in tuner.active.recs.items()
              if rec.admit_tick >= 0}
    pick = next(t for t in tuner.swept if t.policy_name == pick_name)
    if tuner.maybe_retune(force_to=pick) is not pick:
        fail(f"forced swap to {pick_name} did not apply")
    res = tuner.drain()
    return res, before, time.perf_counter() - t0


def check_swap_isolation(phase, res, reqs, before, old, new):
    """Every request admitted before the swap finishes with the computed
    steps of the policy that admitted it, every later one with the new
    policy's; every x0 finite."""
    if len(res) != len(reqs):
        fail(f"{phase}: {len(res)} of {len(reqs)} requests finished")
    for r in res:
        pol = old if r.request_id in before else new
        want = sum(pol.static_schedule(r.record.num_steps))
        if r.record.computed_steps != want:
            fail(f"{phase}: request {r.request_id} (admitted "
                 f"{'before' if r.request_id in before else 'after'} the "
                 f"swap) computed {r.record.computed_steps} steps, "
                 f"{type(pol).__name__} schedules {want}")
        if not math.isfinite(float(abs(r.x0).max())):
            fail(f"{phase}: request {r.request_id} x0 not finite")


def check_engines_released(phase, tuner):
    """After a drain no engine of the tuner still hosts a session (each
    engine hosts at most one: ServeSession refuses a second)."""
    engines = [e for es in tuner._engines.values() for e in es]
    if any(e._session_active for e in engines):
        fail(f"{phase}: an engine still hosts a session after the drain")
    return len(engines)


def phase_control(torch, kernels, path, params, cfg):
    """examples/torch_online_control_plane.py's three acts on full-width
    DiT-XL (SmoothCache at 16 steps; the OnlineTuner over the example's
    menu, 4 slots, 12 requests of 8 and 16 steps; the gate learned from
    the probes), a second tuner with one swap forced to TaylorSeer (2, 1)
    at tick 6, and the learned gate served on the compacted and the dense
    engine."""
    import numpy as np
    from repro_torch.core import make_policy
    from repro_torch.serving.control import OnlineTuner
    from repro_torch.serving.diffusion import SLA, DiffusionServingEngine
    example = load_example("torch_online_control_plane")
    reqs = control_requests(cfg, 12)
    swap_reqs = control_requests(cfg, 12, base=300)

    def main_path():
        out = example.run(params, cfg, reqs, steps=CONTROL_STEPS, slots=4,
                          learned=control_requests(cfg, 6, base=100),
                          verbose=False,
                          log=lambda m: log(f"control: {m.strip()}"))
        t0 = time.perf_counter()
        tuner = OnlineTuner(params, cfg, SLA(min_psnr=-100.0), slots=4,
                            max_steps=CONTROL_STEPS,
                            candidates=[("none", {}), ("taylorseer", {
                                "interval": 2, "order": 1})],
                            retune_every=0, initial=("none", {}))
        sweep2_s = time.perf_counter() - t0
        swap = forced_swap(tuner, swap_reqs, "taylorseer", CONTROL_SWAP_TICK)
        return out, tuner, sweep2_s, swap

    (out, tuner, sweep2_s, (res, before, swap_s)), launches = \
        _count_launches(kernels, path, "control", main_path)
    log(f"control: smoothcache 16 steps: profile "
        f"{[round(p, 4) for p in out['profile']]} schedule "
        f"{[int(b) for b in out['schedule']]} compute_fraction="
        f"{out['compute_fraction']:.4f}")
    w = out["window"].summary()
    t = out["tuner"]
    log(f"control: tuner sweep {out['sweep_s']:.2f}s ({len(t.swept)} "
        f"candidates + the exact reference, 16 steps, batch 1); "
        f"{len(reqs)} requests in {out['serve_s']:.3f}s wall, "
        f"req/s={len(reqs) / out['serve_s']:.4f}; swaps {len(t.swaps)} "
        f"{[(s['tick'], s['from'][0], s['to'][0]) for s in t.swaps]}; "
        f"policy now {t.current.policy_name}; engines built "
        f"{check_engines_released('control', t)}; window row_time_ms="
        f"{w['row_time_ms']:.4f} skip_tick_ms={w['skip_tick_ms']:.4f} "
        f"plan_time_ms={w['plan_time_ms']:.4f} occupancy={w['occupancy']} "
        f"compute_fraction={w['compute_fraction']:.4f} "
        f"backbone_ticks={w['backbone_ticks']} of {w['window_ticks']}")
    for s in t.swaps:
        log(f"control: swap at tick {s['tick']}: {s['from'][0]} -> "
            f"{s['to'][0]} priced at row_time_ms={s['row_time_ms']} "
            f"occupancy={s['occupancy']} "
            f"plan_time_ms={s['plan_time_ms']:.4f} "
            f"est_latency_ms={s['est_latency_ms']}")
    check_swap_isolation("control", res, swap_reqs, before,
                         make_policy("none"),
                         make_policy("taylorseer", interval=2, order=1))
    log(f"control: forced swap to taylorseer (2, 1) at tick "
        f"{CONTROL_SWAP_TICK}: {len(before)} requests admitted before it "
        f"kept none's computed steps, {len(swap_reqs) - len(before)} took "
        f"taylorseer's; sweep {sweep2_s:.2f}s, {len(swap_reqs)} requests "
        f"in {swap_s:.3f}s wall, req/s={len(swap_reqs) / swap_s:.4f}; "
        f"engines built {check_engines_released('control', tuner)}")
    hist = out["hist"]
    log(f"control: learned gate: {out['trace'].summary()['probes']} probes, "
        f"{len(out['pairs'])} teacher pairs of "
        f"{[tuple(i.shape) for i, _ in out['pairs']]}; fit_want_gate 120 "
        f"steps in {out['train_s']:.3f}s on the card, loss {hist[0]:.6f} -> "
        f"{hist[-1]:.6f}; served 6 requests at compute_fraction="
        f"{out['learned_cf']:.4f}, psnr={out['learned_psnr']:.4f} dB vs "
        f"exact (random weights) launches {launches}")
    if not hist[-1] < hist[0]:
        fail("control: the gate's loss did not fall")
    # the learned gate, compacted against dense
    lreqs = control_requests(cfg, 8, base=200)
    served = {}
    for compact in (True, False):
        eng = DiffusionServingEngine(
            params, cfg, make_policy("lazydit", gate=out["gate"],
                                     threshold=0.5),
            slots=4, max_steps=CONTROL_STEPS, row_compaction=compact,
            device="cuda")
        served[compact] = eng.serve(lreqs)
        del eng
    for a, b in zip(served[True], served[False]):
        if a.record.computed_steps != b.record.computed_steps:
            fail(f"control: lazydit request {a.request_id} computed "
                 f"{a.record.computed_steps} steps compacted, "
                 f"{b.record.computed_steps} dense")
        if not np.allclose(a.x0, b.x0, atol=5e-4, rtol=1e-3):
            fail(f"control: lazydit request {a.request_id} x0 differs "
                 f"compacted vs dense by {float(abs(a.x0 - b.x0).max())}")
    log(f"control: lazydit learned gate, compacted vs dense: computed steps "
        f"{[r.record.computed_steps for r in served[True]]} equal, x0 "
        f"within 5e-4 abs + 1e-3 rel (max rel err "
        f"{rel_err(served[True], served[False]):.3e})")
    return launches


def phase_observability(torch, kernels, path):
    """examples/torch_observability.py's steps on full-width DiT-XL and
    dit-video: warmup's program profiles, the mixed image + video queue
    with TraceRecorders and a registry (2 slots a pool, 8 requests), the
    four artifacts, the JSONL reconciled with telemetry exactly, the
    redundancy ratio; the same traffic without hooks, then with them
    again."""
    import tempfile
    from repro_torch.modalities import make_workload
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 flops_per_row, load_cache_events,
                                 validate_chrome_trace)
    example = load_example("torch_observability")
    dit_cfg, dit_params = full_dit(torch)
    video_cfg, video_params = full_video(torch)
    workloads = {
        "image": make_workload("image", cfg=dit_cfg, params=dit_params),
        "video": make_workload("video", cfg=video_cfg, params=video_params)}
    outdir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    out, launches = _count_launches(
        kernels, path, "observability",
        lambda: example.run(workloads, outdir,
                            log=lambda m: log(f"observability: {m.strip()}")))
    engine = out["engine"]
    rps_on = [engine.telemetry.summary()["throughput_rps"]]
    for name in example.ARTIFACTS:
        p = Path(outdir) / name
        if not p.is_file() or p.stat().st_size == 0:
            fail(f"observability: {name} not written")
    with open(Path(outdir) / "trace.json") as f:
        problems = validate_chrome_trace(json.load(f))
    if problems:
        fail(f"observability: trace.json does not validate: {problems[:5]}")
    counts = {}
    for ev in load_cache_events(str(Path(outdir) / "cache_events.jsonl")):
        c = counts.setdefault((ev["modality"], ev["request_id"]), [0, 0])
        c[0] += ev["want_compute"]
        c[1] += ev["want_uncond"]
    for m, tele in engine.telemetry.pools.items():
        for r in tele.records:
            got = counts.get((m, r.request_id))
            if got != [r.computed_steps, r.uncond_computed_steps]:
                fail(f"observability: {m} request {r.request_id}: JSONL "
                     f"{got}, telemetry [{r.computed_steps}, "
                     f"{r.uncond_computed_steps}]")
    for m, eng in sorted(engine.pools.items()):
        prof = eng.program_profile        # logged by the example's run
        buckets = sorted(k for k in prof if isinstance(k, int))
        flops = [prof[b].flops for b in buckets]
        if flops != sorted(set(flops)) or not all(f > 0 for f in flops[1:]) \
                or prof["want"].flops <= 0:
            fail(f"observability: {m} program FLOPs do not rise with the "
                 f"bucket: {dict(zip(buckets, flops))}")
        rr = out["ratios"][m]
        log(f"observability: {m} flops_per_row={flops_per_row(prof):.6e} "
            f"redundancy_ratio={rr['redundancy_ratio']:.4f} "
            f"({rr['flops_avoided']:.4e} of {rr['dense_flops']:.4e} dense "
            f"FLOPs avoided)")
    fpr = flops_per_row(engine.pools["image"].program_profile)
    off = abs(fpr / DIT_XL_HAND_FLOPS - 1)
    log(f"observability: image flops_per_row {fpr:.6e} against the hand "
        f"count 24 d^2 T L + 4 T^2 d L = {DIT_XL_HAND_FLOPS:.6e}: "
        f"{100 * off:.3f} % off (AdaLN, timestep MLP and patch layers make "
        f"the rest)")
    if off > 0.05:
        fail(f"observability: flops_per_row {fpr:.4e} is {100 * off:.2f} % "
             f"off the hand count (limit 5 %)")
    # the same traffic without hooks, then with them again
    reqs = out["requests"]
    engine.serve(reqs)
    rps_off = engine.telemetry.summary()["throughput_rps"]
    recorders = {m: TraceRecorder(policy=engine.pools[m].policy)
                 for m in engine.pools}
    engine.serve(reqs, hooks={m: [r] for m, r in recorders.items()},
                 metrics=MetricsRegistry())
    rps_on.append(engine.telemetry.summary()["throughput_rps"])
    log(f"observability: req/s with recorders + registry {rps_on[0]:.4f} "
        f"(first serve after warmup) and {rps_on[1]:.4f}, without "
        f"{rps_off:.4f}: ratio {rps_on[1] / rps_off:.4f} (JAX's "
        f"bench_serving bounds the loss at 5 %; reported, not gated) "
        f"launches {launches}")
    shutil.rmtree(outdir, ignore_errors=True)
    return launches


def phase_check_control(torch):
    """A reduced DiT on the card and on the CPU from the same weights and
    noise: the forced-swap tuner run (identical computed steps, x0 within
    1e-3 relative), the program profiles' FLOPs (identical per program:
    the kernels' counters agree with FlopCounterMode) and fit_want_gate
    from one initial gate (loss history within 1e-4 relative)."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.control import (OnlineTuner, SignalTraceLog,
                                             fit_want_gate,
                                             probe_training_set)
    from repro_torch.serving.diffusion import (SLA, DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl").reduced(num_layers=3, d_model=128, num_heads=4,
                                       num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    cpu_params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    params = {"cuda": _to(cpu_params, "cuda"), "cpu": cpu_params}

    def noise(req):
        g = torch.Generator().manual_seed(1000 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i)
            for i in range(6)]
    runs, flops = {}, {}
    for dev, p in params.items():
        tuner = OnlineTuner(p, cfg, SLA(min_psnr=-100.0), slots=2,
                            max_steps=12, candidates=[
                                ("none", {}),
                                ("taylorseer", {"interval": 2, "order": 1})],
                            retune_every=0, initial=("none", {}),
                            engine_kw={"noise_fn": noise})
        runs[dev] = forced_swap(tuner, reqs, "taylorseer", 3)
        check_swap_isolation(f"check-control {dev}", runs[dev][0], reqs,
                             runs[dev][1], make_policy("none"),
                             make_policy("taylorseer", interval=2, order=1))
        flops[dev] = {}
        for name in ("teacache", "taylorseer"):
            eng = DiffusionServingEngine(p, cfg, name, slots=2, max_steps=12,
                                         device=dev)
            eng.warmup()
            flops[dev][name] = {str(k): v.flops
                                for k, v in eng.program_profile.items()}
    (gres, gbefore, _), (cres, cbefore, _) = runs["cuda"], runs["cpu"]
    steps = {d: [r.record.computed_steps for r in runs[d][0]] for d in runs}
    if steps["cuda"] != steps["cpu"] or gbefore != cbefore:
        fail(f"check-control: the forced swap differs: computed steps "
             f"{steps}, admitted before {gbefore} / {cbefore}")
    worst = rel_err(gres, cres)
    if not worst <= 1e-3:
        fail(f"check-control: card and CPU x0 differ (rel err {worst})")
    if flops["cuda"] != flops["cpu"]:
        fail(f"check-control: program FLOPs differ: card {flops['cuda']}, "
             f"CPU {flops['cpu']}")
    # fit_want_gate on the CPU's teacher pairs, one initial gate
    log_ = SignalTraceLog(probe_every=2, max_probe_steps=12)
    DiffusionServingEngine(cpu_params, cfg, "none", slots=2, max_steps=12,
                           noise_fn=noise, device="cpu").serve(
        reqs, hooks=[log_.observe], capture_latents=True)
    pairs = probe_training_set(cpu_params, cfg, log_)
    hists = {}
    for dev in ("cuda", "cpu"):
        ps = [(i.to(dev), o.to(dev)) for i, o in pairs]
        hists[dev] = fit_want_gate(torch.Generator().manual_seed(1), ps,
                                   steps=60)[1]
    herr = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(hists["cuda"], hists["cpu"]))
    log(f"check-control: forced swap at tick 3 on the card vs the CPU: "
        f"computed steps {steps['cpu']} identical, admitted before "
        f"{sorted(cbefore)}, max rel err {worst:.3e} (tol 1e-3); program "
        f"FLOPs identical {flops['cpu']}; fit_want_gate over "
        f"{len(pairs)} pairs, 60 steps: loss {hists['cpu'][0]:.6f} -> "
        f"{hists['cpu'][-1]:.6f}, card vs CPU max rel err {herr:.3e} "
        f"(tol 1e-4)")
    if not herr <= 1e-4:
        fail(f"check-control: fit_want_gate histories differ ({herr})")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _watch_logits(eng):
    """Wrap the engine's token pick so every logit row it sees is checked
    for finiteness on the device; returns the list of device flags."""
    flags, pick = [], eng._pick

    def checked(logits, gen):
        flags.append(logits.isfinite().all())
        return pick(logits, gen)

    eng._pick = checked
    return flags


def phase_serve_llm(torch, kernels, path):
    """Full-width zamba2-2.7b behind ServingEngine, random bf16 weights."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = get_config("zamba2-2.7b")
    slots, max_prompt, cache_len, new = 4, 512, 1024, 32
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServingEngine(params, cfg, slots=slots, max_prompt=max_prompt,
                        cache_len=cache_len, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 501, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    eng.generate(prompts[:slots], max_new_tokens=2)         # warm-up
    torch.cuda.synchronize()
    log(f"serve-llm: zamba2-2.7b {cfg.num_layers} Mamba2 layers + "
        f"{cfg.num_layers // cfg.hybrid_attn_every} shared attention "
        f"applications, d_model={cfg.d_model}, params={n_params} "
        f"({cfg.dtype}), init+warm-up {time.perf_counter() - t0:.2f}s; "
        f"prompt lengths {lens.tolist()}")
    flags = _watch_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = _count_launches(
        kernels, path, "serve-llm",
        lambda: eng.generate(prompts, max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(res) != len(prompts):
        fail(f"serve-llm: {len(res)} of {len(prompts)} requests finished")
    for r in res:
        if len(r.tokens) != new or not all(0 <= t < cfg.vocab_size
                                           for t in r.tokens):
            fail(f"serve-llm: request {r.request_id} got {len(r.tokens)} "
                 f"tokens {r.tokens[:8]}")
    if not bool(torch.stack(flags).all()):
        fail("serve-llm: a logit was not finite")
    chunks = -(-len(prompts) // slots)
    want = {"ssd_scan": cfg.num_layers * chunks,
            "flash_attention": cfg.num_layers // cfg.hybrid_attn_every * chunks}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"serve-llm: {name} launched {launches[name]} times, want {n}")
    ntok = sum(len(r.tokens) for r in res)
    log(f"serve-llm: {len(res)} requests x {new} tokens in {wall:.3f}s wall, "
        f"{ntok / wall:.1f} tok/s, {len(flags)} logit rows all finite, "
        f"peak_mem_gb={peak:.2f}, launches {launches}")

    # one prefill and 16 decode steps on their own, host clock around a sync
    toks = torch.from_numpy(np.stack([np.resize(p, max_prompt)
                                      for p in prompts[:slots]])).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, cfg, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = logits[:, -1].argmax(-1)
        del logits
        pos = torch.full((slots,), max_prompt, device="cuda")
        steps = 16
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = decode_step(params, tok, pos, cache, cfg)
            tok, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    log(f"serve-llm: prefill {slots}x{max_prompt} tokens {prefill_ms:.2f} ms; "
        f"decode {decode_ms:.2f} ms per step ({slots} slots, cache_len "
        f"{cache_len})")
    with torch.no_grad():
        log_profile(torch, "serve-llm prefill",
                    lambda: prefill(params, toks, cfg, cache_len))
        log_profile(torch, "serve-llm decode x8", lambda: [
            decode_step(params, tok, pos, cache, cfg) for _ in range(8)])
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_check_llm(torch):
    """The zamba2 SMOKE config served on the card (kernels) and on the CPU
    (plain versions) from the same weights and prompts."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("zamba2-2.7b")
    cpu_params = init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    gpu_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(3, 91, size=6)]
    # max_prompt 100: two SSD tiles, the second ragged
    tokens, logits = {}, {}
    toks = torch.from_numpy(np.stack([np.resize(p, 100) for p in prompts[:4]]))
    for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = ServingEngine(p, cfg, slots=4, max_prompt=100, cache_len=128,
                            device=dev)
        tokens[dev] = [r.tokens for r in eng.generate(prompts,
                                                      max_new_tokens=12)]
        with torch.no_grad():
            lg, cache = prefill(p, toks.to(dev), cfg, 128)
            rows = [lg[:, -1]]
            tok, pos = lg[:, -1].argmax(-1), torch.full((4,), 100, device=dev)
            for _ in range(4):
                lg, cache = decode_step(p, tok, pos, cache, cfg)
                rows.append(lg)
                tok, pos = lg.argmax(-1), pos + 1
        logits[dev] = torch.stack(rows).cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    same = tokens["cuda"] == tokens["cpu"]
    log(f"check-llm: zamba2 SMOKE served on the card vs the CPU: tokens "
        f"{'identical' if same else 'DIFFER'} (6 requests x 12), logits "
        f"max_abs_err {err:.3e} over a prefill and 4 decode steps "
        f"(tol {LLM_LOGIT_TOL})")
    if not same:
        fail(f"check-llm: tokens differ: {tokens}")
    if not err <= LLM_LOGIT_TOL:
        fail(f"check-llm: logits differ by {err}")


# ----------------------------------------------------------------------
# slice 10: training
# ----------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_CKPT_EVERY = 8, 8, 4
CHECK_TRAIN_TOL = 1e-4     # check-train: losses and params, relative
TRAIN_PARTS = ("train.forward", "train.backward", "train.optimizer")


def train_profile(torch, fn):
    """Run fn() (a train step) under the profiler, with a CUDA event at each
    edge of the step's ranges ("train.forward", "train.backward",
    "train.optimizer"; the backward's operators run on autograd's thread,
    in stream order between its edges).  Returns the device ms between each
    range's edges, the flash backward's device ms, all device events' ms
    by name, the profiled wall ms and the profiler's key averages."""
    import contextlib
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    from repro_torch.train import steps
    spans, orig = [], steps.record_function

    @contextlib.contextmanager
    def marked(name):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        with orig(name):
            yield
        b.record()
        spans.append((name, a, b))

    steps.record_function = marked
    try:
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        steps.record_function = orig
    parts = dict.fromkeys(TRAIN_PARTS, 0.0)
    for name, a, b in spans:
        parts[name] += a.elapsed_time(b)
    # the ranges also appear on the device's timeline: not kernels
    kern = [e for e in prof.key_averages() if _self_device_us(e) > 0
            and str(e.device_type).endswith("CUDA")
            and e.key not in TRAIN_PARTS]
    by_name = sum(_self_device_us(e) for e in kern) / 1e3
    bwd = sum(_self_device_us(e) for e in kern if "flash_bwd" in e.key) / 1e3
    return parts, bwd, by_name, wall * 1e3, kern


def _tree_rel(torch, a, b):
    """Largest over the leaves of max |a - b| / max |b|."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.double().cpu(), y.double().cpu()
        worst = max(worst, float((x - y).abs().max())
                    / max(float(y.abs().max()), 1e-30))
    return worst


def phase_train(torch, kernels, path):
    """Full-width DiT-XL trained through launch/train.py's `train`."""
    import tempfile
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.configs import get_config
    from repro_torch.diffusion import linear_schedule
    from repro_torch.launch.train import train
    from repro_torch.models import perturb_zero_init
    from repro_torch.train.steps import (_value_and_grad, diffusion_batches,
                                         diffusion_loss, init_train_state,
                                         make_diffusion_train_step)
    from repro_torch.tree import tree_leaves, tree_paths
    flash, flash_bwd = path
    cfg = get_config("dit-xl")
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    init = [p.clone() for p in tree_leaves(state.params)]
    n_params = sum(p.numel() for p in init)
    torch.cuda.synchronize()
    log(f"train: dit-xl {cfg.num_layers} layers d_model={cfg.d_model} "
        f"params={n_params} ({cfg.dtype}, {len(init)} leaves) init "
        f"{time.perf_counter() - t0:.2f}s; batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps, warmup 0, a checkpoint every "
        f"{TRAIN_CKPT_EVERY}")
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, warmup=0, device="cuda",
              log_fn=log)
    save_s, orig_save = [], ckpt_lib.save

    def timed_save(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig_save(*a, **k)
        save_s.append(time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save = timed_save
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (state, hist), launches = _count_launches(
                kernels, path, "train", lambda: train(
                    "dit-xl", ckpt_dir=d, ckpt_every=TRAIN_CKPT_EVERY,
                    log_every=1, state=state, **kw))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ckpt_lib.save = orig_save
        peak = torch.cuda.max_memory_allocated() / 1e9
        kept = sorted(os.listdir(d))
        t0 = time.perf_counter()
        restored, at, _ = ckpt_lib.restore(d, state, step=TRAIN_CKPT_EVERY)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    log(f"train: {TRAIN_STEPS} steps in {wall:.3f}s wall (checkpoints "
        f"included), losses {losses}, peak_mem_gb={peak:.2f}; checkpoint "
        f"save_s={save_s} (kept {kept}), restore_s={restore_s:.3f} from step "
        f"{at}")
    run_launches = launches
    want = cfg.num_layers * TRAIN_STEPS
    if launches[flash.__name__] != want or launches[flash_bwd.__name__] != want:
        fail(f"train: launches {launches}, want {cfg.num_layers} forward and "
             f"{cfg.num_layers} backward flash launches a step")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train: losses {losses}")
    still = [k for (k, p), p0 in zip(tree_paths(state.params), init)
             if torch.equal(p, p0)]
    if still:
        fail(f"train: leaves that did not move in {TRAIN_STEPS} steps: "
             f"{still}")
    del init

    # restore from the step-4 checkpoint and rerun steps 5-8
    t0 = time.perf_counter()
    resumed, _ = train("dit-xl", state=restored, start_step=TRAIN_CKPT_EVERY,
                       log_every=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(state)))
    rel = _tree_rel(torch, resumed, state)
    log(f"train: restored at step {TRAIN_CKPT_EVERY} and reran steps "
        f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} in {rerun_s:.3f}s "
        f"({rerun_s / (TRAIN_STEPS - TRAIN_CKPT_EVERY) * 1e3:.1f} ms a "
        f"step): bitwise equal to the uninterrupted run: {same}; largest "
        f"relative difference over params and moments {rel:.3e}")
    if not same and not rel <= CHECK_TRAIN_TOL:
        fail(f"train: the resumed run differs by {rel} relative")
    del restored

    # one more step under the profiler: forward, backward, optimizer
    sched = linear_schedule(1000)
    step = make_diffusion_train_step(cfg, sched, peak_lr=3e-4, warmup=0,
                                     total_steps=TRAIN_STEPS + 1)
    batch = next(diffusion_batches(0, TRAIN_BATCH, cfg, "cuda",
                                   start_step=TRAIN_STEPS))
    parts, bwd_ms, busy, pwall, kern = train_profile(
        torch, lambda: step(resumed, batch))
    log(f"train: profiled step wall {pwall:.1f} ms, device kernels "
        f"{busy:.1f} ms, idle share {1 - busy / pwall:.3f}; device ms "
        f"between each part's edges (CUDA events) "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"; flash backward {bwd_ms:.2f} ms, share of device time "
        f"{bwd_ms / busy:.4f}")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:12]:
        log(f"profile: {_self_device_us(e) / 1e3:9.3f} ms "
            f"{100 * _self_device_us(e) / 1e3 / busy:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    del resumed, state

    # every leaf gets a finite, non-zero gradient once the AdaLN-zero gates
    # are perturbed (at init they block attention's gradient)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = perturb_zero_init(init_train_state(gen, cfg,
                                                device="cuda").params, gen)
    draws_gen = torch.Generator(device="cuda").manual_seed(1)

    def loss_fn(p, b):
        return diffusion_loss(p, b["latents"], b["labels"], cfg, sched,
                              draws_gen)

    (grads, metrics), launches = _count_launches(
        kernels, path, "train (perturbed gates)",
        lambda: _value_and_grad(loss_fn, params, batch))
    bad = []
    for (k, g) in tree_paths(grads):
        g = g.float()
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            bad.append(k)
        if k.split("/")[-1] in ("wq", "wk", "wv") and "attn" in k:
            zero = [i for i in range(g.shape[0]) if not bool((g[i] != 0).any())]
            if zero:
                bad.append(f"{k} layers {zero}")
    log(f"train: perturbed gates: loss {float(metrics['loss']):.4f}, "
        f"{len(tree_paths(grads))} gradients, launches {launches}; zero or "
        f"non-finite: {bad}")
    if bad:
        fail(f"train: gradients zero or non-finite: {bad}")
    if launches[flash.__name__] != cfg.num_layers \
            or launches[flash_bwd.__name__] != cfg.num_layers:
        fail(f"train: one backward launched {launches}")
    return run_launches


def phase_train_dit(torch, kernels, path):
    """examples/torch_train_dit.py's `run` at its defaults on the card."""
    example = load_example("torch_train_dit")
    t0 = time.perf_counter()
    out, launches = _count_launches(kernels, path, "train-dit",
                                    lambda: example.run(device="cuda",
                                                        log=log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = out["history"]
    log(f"train-dit: {out['params']} params, {hist[-1]['step']} steps, "
        f"steps_per_s={hist[-1]['steps_per_s']:.3f} (the loop's own), loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, restored from "
        f"step {out['restored_step']} (kept {out['kept']}), sample finite, "
        f"{wall:.2f}s wall; launches {launches}")
    return launches


def phase_check_train(torch):
    """DiT-XL SMOKE (f32) trained 3 steps on the card (kernels) and on the
    CPU (plain versions) from the same weights and injected draws; the SSD
    wrapper under grad must hand back an output autograd sees, whose
    backward launches the SSD backward kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import latent_batches
    from repro_torch.diffusion import linear_schedule
    from repro_torch.kernels import flash_attention, flash_attention_backward
    from repro_torch.kernels import ssd_scan, ssd_scan_backward
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import (TrainState, diffusion_draws,
                                         make_diffusion_train_step)
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("dit-xl")
    gen = torch.Generator().manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    cpu = TrainState(params, adamw_init(params))
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    sched = linear_schedule(1000)
    step = make_diffusion_train_step(cfg, sched, warmup=0, total_steps=3)
    lat = latent_batches(0, 8, cfg.dit_patch_tokens, cfg.dit_in_dim,
                         cfg.dit_num_classes)
    losses = []
    for k in (flash_attention, flash_attention_backward):
        k.launches = 0
    for _ in range(3):
        x, y = next(lat)
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        draws = diffusion_draws(gen, x, sched.T)
        cpu, mc = step(cpu, {"latents": x, "labels": y, "draws": draws})
        card, mg = step(card, {"latents": x.cuda(), "labels": y.cuda(),
                               "draws": tuple(d.cuda() for d in draws)})
        losses.append((float(mc["loss"]), float(mg["loss"])))
    loss_rel = max(abs(a - b) / abs(a) for a, b in losses)
    rel = _tree_rel(torch, card, cpu)
    log(f"check-train: dit-xl SMOKE ({cfg.dtype}) 3 steps, losses (cpu, "
        f"card) {losses}: largest relative difference {loss_rel:.3e}, params "
        f"and moments {rel:.3e} (tol {CHECK_TRAIN_TOL}); card launches flash "
        f"{flash_attention.launches}, backward "
        f"{flash_attention_backward.launches}")
    if not (loss_rel <= CHECK_TRAIN_TOL and rel <= CHECK_TRAIN_TOL):
        fail(f"check-train: card and CPU differ ({loss_rel}, {rel})")
    if flash_attention_backward.launches != 3 * cfg.num_layers:
        fail("check-train: the card's steps did not run the flash backward")
    x = torch.randn((1, 64, 2, 16), device="cuda", requires_grad=True)
    s = torch.randn((1, 64, 16), device="cuda")
    y, _ = ssd_scan(x, torch.rand((1, 64, 2), device="cuda"),
                    -torch.rand((2,), device="cuda"), s, s)
    before = ssd_scan_backward.launches
    if y.grad_fn is None:
        fail("check-train: ssd_scan under grad returned a detached output")
    y.sum().backward()
    if ssd_scan_backward.launches != before + 1 or x.grad is None:
        fail("check-train: ssd_scan's backward did not launch its kernel")
    log(f"check-train: ssd_scan under grad differentiates through "
        f"{type(y.grad_fn).__name__} (one backward launch)")


# ----------------------------------------------------------------------
# slice 11: the SSD scan's backward, LM training, the dense family, dlm
# ----------------------------------------------------------------------

SSD_BWD_CASES = [  # name, b, s, h, p, n, bf16 xBC views, dh_final
    ("zamba2 prefill f32", 4, 512, 80, 64, 64, False, False),
    ("zamba2 prefill bf16 xBC views, dh_final", 4, 512, 80, 64, 64, True,
     True),
    # the train-llm phase's scans: batch 8 x seq 128, bf16 views
    ("train bf16 xBC views", 8, 128, 80, 64, 64, True, False),
    ("ragged 500 f32, dh_final", 1, 500, 80, 64, 64, False, True),
]
SSD_BWD_MAIN = "train bf16 xBC views"     # the kernels line's row
# of each gradient's largest float64 value; a bf16 output (dx, dB, dC on
# bf16 views) adds one rounding, 2^-8 of each element
SSD_BWD_TOL = 1e-4
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_work(b, s, h, p, n, el, dh, xbc):
    """(bytes, operations, seconds of operations at the peak) the scan's
    VJP needs: x, B, C (el bytes), dy, dt, A and dh_final read once, dx,
    dB, dC (el bytes), ddt and dA written once.  Per (b, h, 64-token tile)
    the causal half (`causal_pairs`) of M^T dy and dy x^T over p, and five
    products over (p, n) per token: G B, H^T dy, x^T G and the two state
    passes (x B^T, dy C^T); per (b, tile) the causal half of C B^T, dCB B
    and dCB^T C over n (B and C are shared by the heads).  On bf16 xBC
    views C B^T has two bf16 operands (the bf16 peak), the other products
    with an x, B or C operand run at the 2xTF32 peak and the rest (M^T dy,
    H^T dy) at 3xTF32; f32 inputs take 3xTF32 throughout."""
    pairs = causal_pairs(s)
    f32_f32 = 2.0 * b * h * (pairs * p + s * p * n)
    cb = 2.0 * b * pairs * n
    with_xbc = (2.0 * b * h * (pairs * p + 4 * s * p * n)
                + 2.0 * b * 2 * pairs * n)
    seconds = (f32_f32 / PEAK_FLOPS["float32_3xtf32"]
               + cb / PEAK_FLOPS["bfloat16" if xbc else "float32_3xtf32"]
               + with_xbc / PEAK_FLOPS["bf16_x_f32_2xtf32" if xbc
                                       else "float32_3xtf32"])
    nbytes = (el * (2 * b * s * h * p + 4 * b * s * n)
              + 4 * (b * s * h * p + 2 * b * s * h + 2 * h)
              + (4 * b * h * p * n if dh else 0))
    return nbytes, f32_f32 + cb + with_xbc, seconds


def phase_ssd_bwd(torch):
    """The SSD backward kernels against float64 autograd of `ssd_ref` and
    against the plain VJP (`ssd_bwd_ref`), bitwise on a rerun."""
    from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_ref, ssd_scan_backward
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name, b, s, h, p, n, xbc, dh in SSD_BWD_CASES:
        args = ssd_inputs(torch, gen, b, s, h, p, n, xbc)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dhf = torch.randn((b, h, p, n), generator=gen, device="cuda") \
            if dh else None
        before = ssd_scan_backward.launches
        got = ssd_scan_backward(*args, dy, dhf)
        again = ssd_scan_backward(*args, dy, dhf)
        plain = ssd_bwd_ref(*args, dy, dhf)
        ins = [a.detach().double().requires_grad_() for a in args]
        y64, h64 = ssd_ref(*ins)
        loss = (y64 * dy.double()).sum()
        if dh:
            loss = loss + (h64 * dhf.double()).sum()
        ref = torch.autograd.grad(loss, ins)
        torch.cuda.synchronize()
        if ssd_scan_backward.launches != before + 2:
            fail(f"ssd-bwd {name}: two calls counted "
                 f"{ssd_scan_backward.launches - before} launches")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"ssd-bwd {name}: a rerun is not bitwise equal")
        errs, worst = {}, 0.0
        for g, a, pl, r in zip(SSD_GRADS, got, plain, ref):
            if a.shape != r.shape:
                fail(f"ssd-bwd {name}: {g} {tuple(a.shape)} want "
                     f"{tuple(r.shape)}")
            scale = max(float(r.abs().max()), 1e-30)
            err = (a.double() - r).abs()
            allowed = SSD_BWD_TOL * scale
            if a.dtype == torch.bfloat16:
                allowed = allowed + 2.0 ** -8 * r.abs()
            excess = float((err - allowed).max())
            errs[g] = {"max_abs_err": float(err.max()),
                       "rel": float(err.max()) / scale,
                       "plain_rel": float((pl.double() - r).abs().max())
                       / scale, "dtype": str(a.dtype)[6:]}
            worst = max(worst, float(err.max()) / scale)
            if excess > 0:
                fail(f"ssd-bwd {name}: {g} ({errs[g]['dtype']}) off float64 "
                     f"autograd by {float(err.max())} (largest |grad| "
                     f"{scale}, tol {SSD_BWD_TOL} rel, bf16 one rounding "
                     f"more)")
            if errs[g]["plain_rel"] > SSD_BWD_TOL:
                fail(f"ssd-bwd {name}: the plain VJP's {g} is off by "
                     f"{errs[g]['plain_rel']} relative")

        def call():
            return ssd_scan_backward(*args, dy, dhf)
        ms = cuda_ms(torch, call)
        dev_ms = device_ms(torch, call, "ssd_bwd")
        plain_ms = cuda_ms(torch, lambda: ssd_bwd_ref(*args, dy, dhf), reps=5)
        nbytes, flops, t_ops = ssd_bwd_work(
            b, s, h, p, n, args[0].element_size(), dh, xbc)
        b_ms, by = bound(nbytes, flops, flops / t_ops)
        log(f"ssd-bwd {name}: b={b} s={s} h={h} p={p} n={n} "
            f"{str(args[0].dtype)[6:]}: vs float64 autograd, largest error "
            f"of each gradient over its largest value "
            + ", ".join(f"{g} {e['rel']:.3e} ({e['dtype']}; plain "
                        f"{e['plain_rel']:.3e})" for g, e in errs.items())
            + f"; bitwise on a rerun; ms={ms:.4f} device_ms={dev_ms} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({by}, "
            f"{flops / 1e9:.2f} GFLOP "
            f"{'split 3x/2xTF32' if xbc else 'at 3xTF32'}, "
            f"{nbytes / 1e6:.1f} MB); no "
            f"single PyTorch call computes this function (library_ms null)")
        rows[name] = {"max_abs_err": max(e["max_abs_err"]
                                         for e in errs.values()),
                      "max_rel_err": worst, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                      "device_ms": dev_ms, "shape": name, "errors": errs,
                      "tolerance": f"{SSD_BWD_TOL} of the largest float64 "
                      f"gradient (+ 2^-8 |ref| for bf16 outputs)",
                      "parent_device_ms": PARENT_AB["ssd-bwd"]}
    report = dict(rows[SSD_BWD_MAIN])
    report.update({n: rows[n] for n in rows if n != SSD_BWD_MAIN})
    return report


LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 8, 128


def _train_lm(torch, kernels, path, arch, phase):
    """Full-width `arch` trained through launch/train.py's `train` at the
    launcher's batch 8 x seq 128; then ms a step over two more steps and
    one profiled step split into forward / backward / optimizer.  Returns
    the counts of the `train` run."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.train import train
    from repro_torch.train.steps import init_train_state, make_lm_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    torch.cuda.synchronize()
    log(f"{phase}: {arch} ({cfg.family}) {cfg.num_layers} layers d_model="
        f"{cfg.d_model} params={n_params} ({cfg.dtype}) init "
        f"{time.perf_counter() - t0:.2f}s; batch {LM_TRAIN_BATCH} x seq "
        f"{LM_TRAIN_SEQ}, {LM_TRAIN_STEPS} steps, warmup 0")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, hist), launches = _count_launches(
        kernels, path, phase, lambda: train(
            arch, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
            seq=LM_TRAIN_SEQ, warmup=0, device="cuda", log_every=1,
            log_fn=log, state=state))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if len(losses) != LM_TRAIN_STEPS or not all(
            map(math.isfinite, losses + gnorms)):
        fail(f"{phase}: losses {losses}, grad norms {gnorms}")
    log(f"{phase}: {LM_TRAIN_STEPS} steps in {wall:.3f}s wall (the first "
        f"warms up), losses {losses}, grad norms {gnorms}, "
        f"peak_mem_gb={peak:.2f}, launches {launches}")

    step = make_lm_train_step(cfg, peak_lr=3e-4, warmup=0,
                              total_steps=LM_TRAIN_STEPS + 3)
    it = lm_batches(0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab_size,
                    start_step=LM_TRAIN_STEPS)
    batches = [{"tokens": torch.from_numpy(t).cuda(),
                "targets": torch.from_numpy(y).cuda()}
               for t, y in (next(it) for _ in range(3))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:2]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    parts, flash_bwd_ms, busy, pwall, kern = train_profile(
        torch, lambda: step(state, batches[2]))
    ssd_bwd_ms = sum(_self_device_us(e) for e in kern
                     if "ssd_bwd" in e.key) / 1e3
    ssd_fwd_ms = sum(_self_device_us(e) for e in kern
                     if "ssd_cb_kernel" in e.key
                     or "ssd_scan_kernel" in e.key) / 1e3
    log(f"{phase}: ms a step {step_ms:.1f} (host clock over 2 steps, "
        f"synchronized); profiled step wall {pwall:.1f} ms, device kernels "
        f"{busy:.1f} ms, idle share {1 - busy / pwall:.3f}; device ms "
        f"between each part's edges (CUDA events) "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"; SSD backward {ssd_bwd_ms:.2f} ms (share of kernel time "
        f"{ssd_bwd_ms / busy:.4f}), SSD forward {ssd_fwd_ms:.2f} ms, flash "
        f"backward {flash_bwd_ms:.2f} ms ({flash_bwd_ms / busy:.4f})")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:12]:
        log(f"profile: {_self_device_us(e) / 1e3:9.3f} ms "
            f"{100 * _self_device_us(e) / 1e3 / busy:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    del state, batches
    return launches, cfg


def phase_train_llm(torch, kernels, path):
    """Full-width zamba2-2.7b trained on the card: 54 SSD scans, 54 SSD
    backward launches, 9 flash forward and 9 backward a step."""
    launches, cfg = _train_lm(torch, kernels, path, "zamba2-2.7b",
                              "train-llm")
    pts = cfg.num_layers // cfg.hybrid_attn_every
    want = {"ssd_scan": cfg.num_layers, "ssd_scan_backward": cfg.num_layers,
            "flash_attention": pts, "flash_attention_backward": pts}
    for name, n in want.items():
        if launches[name] != n * LM_TRAIN_STEPS:
            fail(f"train-llm: {name} launched {launches[name]} times, want "
                 f"{n} a step")
    return launches


def phase_train_dense(torch, kernels, path):
    """Full-width tinyllama-1.1b trained on the card: 22 flash forward and
    22 backward launches a step (GQA group 8 summed in the backward)."""
    launches, cfg = _train_lm(torch, kernels, path, "tinyllama-1.1b",
                              "train-dense")
    for name in ("flash_attention", "flash_attention_backward"):
        if launches[name] != cfg.num_layers * LM_TRAIN_STEPS:
            fail(f"train-dense: {name} launched {launches[name]} times, "
                 f"want {cfg.num_layers} a step")
    return launches


def _lm_state_pair(torch, arch, seed=0):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import TrainState
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    cpu = TrainState(params, adamw_init(params))
    return cfg, cpu, tree_map(lambda t: t.to("cuda", copy=True), cpu)


def _train_card_vs_cpu(torch, phase, arch, steps, seq):
    """`steps` train steps of `arch` SMOKE (f32) on the card and on the CPU
    from one state and the same batches; fail beyond CHECK_TRAIN_TOL."""
    from repro_torch.data import lm_batches
    from repro_torch.train.steps import make_lm_train_step
    cfg, cpu, card = _lm_state_pair(torch, arch)
    step = make_lm_train_step(cfg, warmup=0, total_steps=steps)
    it = lm_batches(0, 8, seq, cfg.vocab_size)
    losses = []
    for _ in range(steps):
        t, y = (torch.from_numpy(a) for a in next(it))
        cpu, mc = step(cpu, {"tokens": t, "targets": y})
        card, mg = step(card, {"tokens": t.cuda(), "targets": y.cuda()})
        losses.append((float(mc["loss"]), float(mg["loss"])))
    loss_rel = max(abs(a - b) / abs(a) for a, b in losses)
    rel = _tree_rel(torch, card, cpu)
    log(f"{phase}: {arch} SMOKE ({cfg.dtype}) {steps} steps at seq {seq}, "
        f"losses (cpu, card) {losses}: largest relative difference "
        f"{loss_rel:.3e}, params and moments {rel:.3e} (tol "
        f"{CHECK_TRAIN_TOL})")
    if not (loss_rel <= CHECK_TRAIN_TOL and rel <= CHECK_TRAIN_TOL):
        fail(f"{phase}: card and CPU differ ({loss_rel}, {rel})")
    return cfg


def phase_check_train_llm(torch):
    """zamba2 SMOKE trained 3 steps on the card (kernels, the SSD backward
    included) and on the CPU (plain versions); then a run resumed from the
    launcher's step-2 checkpoint on the card, bitwise."""
    import tempfile
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.kernels import ssd_scan_backward
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    ssd_scan_backward.launches = 0
    # seq 100: a full 64-token tile and a ragged one
    cfg = _train_card_vs_cpu(torch, "check-train-llm", "zamba2-2.7b", 3, 100)
    if ssd_scan_backward.launches != 3 * cfg.num_layers:
        fail(f"check-train-llm: the card's steps launched the SSD backward "
             f"{ssd_scan_backward.launches} times")
    kw = dict(smoke=True, steps=4, batch=8, seq=100, warmup=0, device="cuda",
              log_every=4, log_fn=lambda _m: None)
    with tempfile.TemporaryDirectory() as d:
        whole, _ = train("zamba2-2.7b", ckpt_dir=d, ckpt_every=2, **kw)
        restored, at, _ = ckpt_lib.restore(d, whole, step=2)
        resumed, _ = train("zamba2-2.7b", state=restored, start_step=2, **kw)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(whole)))
    log(f"check-train-llm: zamba2 SMOKE on the card, 4 steps with a "
        f"checkpoint every 2, restored at step {at} and rerun to step 4: "
        f"bitwise equal to the uninterrupted run: {same}")
    if not same:
        fail("check-train-llm: the resumed run is not bitwise equal")


DENSE_SERVE = ("qwen2-7b", "qwen2.5-14b", "minitron-8b")


def _serve_lm(torch, kernels, path, arch, n_requests, new, phase):
    """Full-width `arch` behind ServingEngine (4 slots, max_prompt 512,
    cache_len 1024), `n_requests` greedy requests of 64-500 prompt tokens,
    `new` tokens each; then one prefill and 8 decode steps on their own.
    Returns the counts of the served run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = get_config(arch)
    slots, max_prompt, cache_len = 4, 512, 1024
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServingEngine(params, cfg, slots=slots, max_prompt=max_prompt,
                        cache_len=cache_len, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 501, size=8)[:n_requests]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    eng.generate(prompts[:slots], max_new_tokens=2)         # warm-up
    torch.cuda.synchronize()
    log(f"{phase}: {arch} {cfg.num_layers} layers, d_model={cfg.d_model}, "
        f"heads {cfg.num_heads} over {cfg.num_kv_heads} KV heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, params={n_params} "
        f"({cfg.dtype}), init+warm-up {time.perf_counter() - t0:.2f}s; "
        f"prompt lengths {lens.tolist()}")
    flags = _watch_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = _count_launches(
        kernels, path, phase, lambda: eng.generate(prompts,
                                                   max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(res) != len(prompts):
        fail(f"{phase}: {arch}: {len(res)} of {len(prompts)} requests")
    for r in res:
        if len(r.tokens) != new or not all(0 <= t < cfg.vocab_size
                                           for t in r.tokens):
            fail(f"{phase}: {arch} request {r.request_id} got "
                 f"{len(r.tokens)} tokens {r.tokens[:8]}")
    if not bool(torch.stack(flags).all()):
        fail(f"{phase}: {arch}: a logit was not finite")
    want = cfg.num_layers * -(-len(prompts) // slots)
    if launches["flash_attention"] != want:
        fail(f"{phase}: {arch}: flash launched "
             f"{launches['flash_attention']} times, want {want}")
    ntok = sum(len(r.tokens) for r in res)
    toks = torch.from_numpy(np.stack([np.resize(p, max_prompt)
                                      for p in prompts[:slots]])).cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, cfg, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = logits[:, -1].argmax(-1)
        del logits
        pos = torch.full((slots,), max_prompt, device="cuda")
        t0 = time.perf_counter()
        for _ in range(8):
            logits, cache = decode_step(params, tok, pos, cache, cfg)
            tok, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / 8
    log(f"{phase}: {arch}: {len(res)} requests x {new} tokens in "
        f"{wall:.3f}s wall, {ntok / wall:.1f} tok/s, peak_mem_gb={peak:.2f}, "
        f"launches {launches}; prefill {slots}x{max_prompt} tokens "
        f"{prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a step ({slots} "
        f"slots, cache_len {cache_len})")
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_serve_dense(torch, kernels, path):
    """tinyllama-1.1b with serve-llm's traffic, then qwen2-7b, qwen2.5-14b
    and minitron-8b, 4 requests x 16 tokens each, one model at a time."""
    total = no_launches(kernels)
    runs = [("tinyllama-1.1b", 8, 32)] + [(a, 4, 16) for a in DENSE_SERVE]
    for arch, n, new in runs:
        gc.collect()
        torch.cuda.empty_cache()
        launches = _serve_lm(torch, kernels, path, arch, n, new,
                             "serve-dense")
        total = {k: total[k] + v for k, v in launches.items()}
    return total


def phase_check_dense(torch):
    """tinyllama and qwen2-7b SMOKE (f32) on the card (kernels) and on the
    CPU (plain versions) from the same weights: prefill and decode logits,
    the engine's greedy tokens; one tinyllama train step."""
    import numpy as np
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ServingEngine
    for arch in ("tinyllama-1.1b", "qwen2-7b"):
        cfg, cpu, card = _lm_state_pair(torch, arch, seed=5)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in rng.integers(3, 91, size=6)]
        toks = torch.from_numpy(np.stack([np.resize(p, 100)
                                          for p in prompts[:4]]))
        tokens, logits = {}, {}
        for dev, p in (("cuda", card.params), ("cpu", cpu.params)):
            eng = ServingEngine(p, cfg, slots=4, max_prompt=100,
                                cache_len=128, device=dev)
            tokens[dev] = [r.tokens for r in eng.generate(
                prompts, max_new_tokens=12)]
            with torch.no_grad():
                lg, cache = prefill(p, toks.to(dev), cfg, 128)
                rows = [lg[:, -1]]
                tok, pos = lg[:, -1].argmax(-1), torch.full((4,), 100,
                                                            device=dev)
                for _ in range(4):
                    lg, cache = decode_step(p, tok, pos, cache, cfg)
                    rows.append(lg)
                    tok, pos = lg.argmax(-1), pos + 1
            logits[dev] = torch.stack(rows).cpu()
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        same = tokens["cuda"] == tokens["cpu"]
        log(f"check-dense: {arch} SMOKE served on the card vs the CPU: "
            f"tokens {'identical' if same else 'DIFFER'} (6 requests x 12), "
            f"logits max_abs_err {err:.3e} over a prefill and 4 decode "
            f"steps (tol {LLM_LOGIT_TOL})")
        if not same:
            fail(f"check-dense: {arch} tokens differ: {tokens}")
        if not err <= LLM_LOGIT_TOL:
            fail(f"check-dense: {arch} logits differ by {err}")
    _train_card_vs_cpu(torch, "check-dense", "tinyllama-1.1b", 1, 100)


DLM_STEPS, DLM_BATCH, DLM_SEQ = 8, 2, 64
DLM_POLICIES = [("fora", {"interval": 2}), ("taylorseer", {"interval": 2})]


def phase_dlm(torch, kernels, path):
    """examples/torch_diffusion_lm.py's `run` on full-width tinyllama-1.1b:
    B 2, S 64, 8 steps, exact, FORA 2 and TaylorSeer 2."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_policy
    from repro_torch.diffusion.dlm import dlm_generate
    from repro_torch.models import init_params
    example = load_example("torch_diffusion_lm")
    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    out, launches = _count_launches(kernels, path, "dlm", lambda: example.run(
        device="cuda", log=log, cfg=cfg, batch=DLM_BATCH, seq_len=DLM_SEQ,
        num_steps=DLM_STEPS, policies=DLM_POLICIES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {"none": DLM_STEPS, "fora": DLM_STEPS // 2,
            "taylorseer": DLM_STEPS // 2}
    for name, (tokens, n) in out.items():
        if n != want[name]:
            fail(f"dlm: {name} computed {n} times, want {want[name]}")
        if tuple(tokens.shape) != (DLM_BATCH, DLM_SEQ) or not (
                0 <= int(tokens.min()) and int(tokens.max())
                < cfg.vocab_size - 1):
            fail(f"dlm: {name} left masks or bad tokens")
    computes = sum(n for _, n in out.values())
    if launches["flash_attention"] != 2 * cfg.num_layers * computes:
        fail(f"dlm: flash launched {launches['flash_attention']} times, want "
             f"2 x {cfg.num_layers} a full compute")
    log(f"dlm: tinyllama-1.1b full width, B {DLM_BATCH} x S {DLM_SEQ}, "
        f"{DLM_STEPS} steps: computes {({k: n for k, (_, n) in out.items()})}"
        f", {wall:.2f}s wall with the model's init, launches {launches}")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    for name, kw in [("none", {})] + DLM_POLICIES:
        dlm_generate(params, cfg, batch=DLM_BATCH, seq_len=DLM_SEQ,
                     num_steps=DLM_STEPS, policy=make_policy(name, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dlm_generate(params, cfg, batch=DLM_BATCH, seq_len=DLM_SEQ,
                     num_steps=DLM_STEPS, policy=make_policy(name, **kw))
        torch.cuda.synchronize()
        log(f"dlm: {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms a "
            f"generation (host clock, synchronized, after one warm run)")
    del params
    return launches


# ----------------------------------------------------------------------
# slice 13: the ssm (Mamba1), encoder-decoder and vlm families
# ----------------------------------------------------------------------

SLICE13_TOL = 1e-4     # check-ssm / -encdec / -vlm: card vs CPU, relative
WHISPER_SOT = 50258    # Whisper's <|startoftranscript|>: the first token
ENCDEC_REQUESTS, ENCDEC_NEW, WHISPER_CTX = 4, 32, 448
VLM_TEXT, VLM_NEW = 64, 32


def _rel(a, b) -> float:
    """max |a - b| / max |b| (b on the CPU, a anywhere)."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _sync_ms(torch, fn):
    """(fn(), host milliseconds around it, synchronized on both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_serve_ssm(torch, kernels, path):
    """Full-width falcon-mamba-7b (64 Mamba1 layers, bf16 params, random
    weights from a seed) behind ServingEngine with serve-llm's traffic.
    Attention-free, and Mamba1's scan is plain PyTorch (JAX has no kernel
    for it), so no kernel of the port runs on this path."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill, ssm
    from repro_torch.serving import ServingEngine
    cfg = get_config("falcon-mamba-7b")
    slots, max_prompt, cache_len, new = 4, 512, 1024, 32
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServingEngine(params, cfg, slots=slots, max_prompt=max_prompt,
                        cache_len=cache_len, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 501, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    eng.generate(prompts[:slots], max_new_tokens=2)         # warm-up
    torch.cuda.synchronize()
    log(f"serve-ssm: falcon-mamba-7b {cfg.num_layers} Mamba1 layers, "
        f"d_model={cfg.d_model}, d_inner={cfg.ssm_expand * cfg.d_model}, "
        f"state {cfg.ssm_state}, vocab {cfg.vocab_size}, params={n_params} "
        f"({cfg.dtype}), init+warm-up {time.perf_counter() - t0:.2f}s; "
        f"prompt lengths {lens.tolist()}")
    flags = _watch_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = _count_launches(
        kernels, path, "serve-ssm",
        lambda: eng.generate(prompts, max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(res) != len(prompts):
        fail(f"serve-ssm: {len(res)} of {len(prompts)} requests finished")
    for r in res:
        if len(r.tokens) != new or not all(0 <= t < cfg.vocab_size
                                           for t in r.tokens):
            fail(f"serve-ssm: request {r.request_id} got {len(r.tokens)} "
                 f"tokens {r.tokens[:8]}")
    if not bool(torch.stack(flags).all()):
        fail("serve-ssm: a logit was not finite")
    if any(launches.values()):
        fail(f"serve-ssm: the attention-free path launched {launches}")
    ntok = sum(len(r.tokens) for r in res)
    log(f"serve-ssm: {len(res)} requests x {new} tokens in {wall:.3f}s wall, "
        f"{ntok / wall:.1f} tok/s, {len(flags)} logit rows all finite, "
        f"peak_mem_gb={peak:.2f}, launches {launches}")

    toks = torch.from_numpy(np.stack([np.resize(p, max_prompt)
                                      for p in prompts[:slots]])).cuda()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        (logits, cache), prefill_ms = _sync_ms(
            torch, lambda: prefill(params, toks, cfg, cache_len))
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9
        tok = logits[:, -1].argmax(-1)
        del logits
        pos = torch.full((slots,), max_prompt, device="cuda")
        steps = 16
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = decode_step(params, tok, pos, cache, cfg)
            tok, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        log(f"serve-ssm: prefill {slots}x{max_prompt} tokens {prefill_ms:.2f} "
            f"ms (peak {prefill_peak:.2f} GB); decode {decode_ms:.2f} ms per "
            f"step ({slots} slots)")
        scan_ms, pre_ms, n_scans = scan_share(
            torch, ssm, lambda: prefill(params, toks, cfg, cache_len))
        log(f"serve-ssm: the Mamba1 scan (linear_scan_chunked, plain "
            f"PyTorch; CUDA events at its edges, {n_scans} calls) "
            f"{scan_ms:.1f} ms of the prefill's {pre_ms:.1f} device ms "
            f"(share {scan_ms / pre_ms:.4f})")
        log_profile(torch, "serve-ssm prefill",
                    lambda: prefill(params, toks, cfg, cache_len))
        log_profile(torch, "serve-ssm decode x8", lambda: [
            decode_step(params, tok, pos, cache, cfg) for _ in range(8)])
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def scan_share(torch, ssm, fn):
    """(device ms between CUDA events at the edges of every
    `ssm.linear_scan_chunked` call in fn(), device ms of all of fn(), the
    calls).  fn() must not wait on the host inside (a prefill does not),
    so the events bound exactly the scan's kernels in stream order."""
    spans, orig = [], ssm.linear_scan_chunked

    def timed_scan(*a, **k):
        a0, b0 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a0.record()
        out = orig(*a, **k)
        b0.record()
        spans.append((a0, b0))
        return out

    ssm.linear_scan_chunked = timed_scan
    try:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
    finally:
        ssm.linear_scan_chunked = orig
    return (sum(a0.elapsed_time(b0) for a0, b0 in spans),
            start.elapsed_time(end), len(spans))


def big_projections(prof, rows: int, d: int):
    """Matrix products (aten::mm / addmm, what matmul runs) in the profile
    of an activation of at least rows x d elements by a (d, d) weight."""
    hits = []
    for e in prof.events():
        if e.name not in ("aten::mm", "aten::addmm"):   # matmul's inner op
            continue
        shapes = [list(s) for s in (e.input_shapes or []) if s]
        if len(shapes) >= 2 and shapes[-1] == [d, d] \
                and shapes[-2][-1] == d and math.prod(shapes[-2]) >= rows * d:
            hits.append((e.name, shapes))
    return hits


def phase_serve_encdec(torch, kernels, path):
    """Full-width whisper-small (12 + 12 layers, bf16 params, random weights
    from a seed): 4 requests of (1500, 768) stub frames, `encode`, one
    `cross_kv`, 32 greedy `decode_step`s; then the teacher-forced
    `forward` at Whisper's 448-token decoder context."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import frame_embeddings
    from repro_torch.kernels import flash_attention
    from repro_torch.models import encdec, init_params
    cfg = get_config("whisper-small")
    B, L_enc = ENCDEC_REQUESTS, cfg.num_encoder_layers
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    frames = torch.from_numpy(frame_embeddings(
        0, B, cfg.encoder_seq, cfg.d_model)).to("cuda", getattr(torch,
                                                                cfg.dtype))

    def serve():
        with counting(encdec, "cross_kv") as ckv, torch.no_grad():
            enc = encdec.encode(params, frames, cfg)
            enc_flash = flash_attention.launches
            cache = encdec.init_dec_cache(cfg, B, WHISPER_CTX,
                                          cfg.encoder_seq, device="cuda")
            cache["xk"], cache["xv"] = encdec.cross_kv(params, enc, cfg)
            tok = torch.full((B,), WHISPER_SOT, device="cuda")
            toks, finite = [], []
            for i in range(ENCDEC_NEW):
                pos = torch.full((B,), i, device="cuda")
                logits, cache = encdec.decode_step(params, tok, pos, cache,
                                                   cfg)
                finite.append(logits.isfinite().all())
                tok = logits.argmax(-1)
                toks.append(tok)
        return (enc_flash, ckv.calls, torch.stack(toks, 1).cpu(),
                bool(torch.stack(finite).all()), enc, cache)

    serve()                                                  # warm-up
    torch.cuda.synchronize()
    log(f"serve-encdec: whisper-small {L_enc} encoder + {cfg.num_layers} "
        f"decoder layers, d_model={cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, {cfg.encoder_seq} frames, vocab {cfg.vocab_size}, "
        f"params={n_params} ({cfg.dtype}), init+warm-up "
        f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    (enc_flash, ckv_calls, toks, finite, enc, cache), launches = \
        _count_launches(kernels, path, "serve-encdec", serve)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if enc_flash != L_enc or launches["flash_attention"] != L_enc:
        fail(f"serve-encdec: flash launched {enc_flash} times by encode and "
             f"{launches['flash_attention']} in all, want {L_enc} (one a "
             f"layer; decode attends with blocked_attention)")
    if ckv_calls != 1:
        fail(f"serve-encdec: cross_kv ran {ckv_calls} times, want once")
    if not finite or tuple(toks.shape) != (B, ENCDEC_NEW) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        fail(f"serve-encdec: logits finite {finite}, tokens {toks[:, :8]}")
    log(f"serve-encdec: {B} requests, encode + one cross_kv + {ENCDEC_NEW} "
        f"greedy decode steps: logits all finite, cross_kv calls "
        f"{ckv_calls}, encoder flash launches {enc_flash}, "
        f"peak_mem_gb={peak:.2f}, launches {launches}")

    with torch.no_grad():
        enc, encode_ms = _sync_ms(
            torch, lambda: encdec.encode(params, frames, cfg))
        kv, cross_ms = _sync_ms(torch,
                                lambda: encdec.cross_kv(params, enc, cfg))
        tok = toks[:, -1].cuda()
        pos = torch.full((B,), ENCDEC_NEW, device="cuda")

        def steps(n):
            nonlocal tok, pos
            for _ in range(n):
                logits, _ = encdec.decode_step(params, tok, pos, cache, cfg)
                tok, pos = logits.argmax(-1), pos + 1

        _, decode_ms = _sync_ms(torch, lambda: steps(16))
        log(f"serve-encdec: encode {B}x{cfg.encoder_seq} frames "
            f"{encode_ms:.2f} ms, cross_kv {cross_ms:.2f} ms, decode "
            f"{decode_ms / 16:.2f} ms per step ({B} requests, self-cache "
            f"{WHISPER_CTX})")
        # the decode step reuses the cached cross K/V: no (B*1500, d) x
        # (d, d) product; cross_kv itself shows them (a control)
        rows = B * cfg.encoder_seq
        *_, prof = marked_profile(torch, "decode", [], lambda: steps(1),
                                  record_shapes=True)
        in_decode = big_projections(prof, rows, cfg.d_model)
        *_, prof = marked_profile(torch, "cross_kv", [],
                                  lambda: encdec.cross_kv(params, enc, cfg),
                                  record_shapes=True)
        in_cross = big_projections(prof, rows, cfg.d_model)
        log(f"serve-encdec: ({rows}, {cfg.d_model}) x ({cfg.d_model}, "
            f"{cfg.d_model}) products in a decode step: {len(in_decode)}; "
            f"in one cross_kv (control): {len(in_cross)}")
        if in_decode or len(in_cross) != 2 * cfg.num_layers:
            fail(f"serve-encdec: decode step projections {in_decode[:2]}, "
                 f"cross_kv {len(in_cross)} (want 0 and "
                 f"{2 * cfg.num_layers})")
        log_profile(torch, "serve-encdec decode x8", lambda: steps(8))

        # the teacher-forced forward at the decoder's 448-token context
        tgt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, WHISPER_CTX))).cuda()
        flash_attention.launches = 0
        logits, fwd_ms = _sync_ms(
            torch, lambda: encdec.forward(params, frames, tgt, cfg))
        want = L_enc + 2 * cfg.num_layers
        if flash_attention.launches != want or not bool(
                logits.isfinite().all()):
            fail(f"serve-encdec: forward launched flash "
                 f"{flash_attention.launches} times (want {want}), logits "
                 f"finite {bool(logits.isfinite().all())}")
        _, fwd_ms = _sync_ms(
            torch, lambda: encdec.forward(params, frames, tgt, cfg))
        log(f"serve-encdec: forward {B}x{cfg.encoder_seq} frames + "
            f"{B}x{WHISPER_CTX} tokens (teacher forcing) {fwd_ms:.2f} ms, "
            f"{want} flash launches (encoder {L_enc}, decoder self "
            f"{cfg.num_layers} causal + cross {cfg.num_layers})")
    flash_attention.launches = 0
    del params, cache, enc, kv, logits
    torch.cuda.empty_cache()
    return launches


def phase_serve_vlm(torch, kernels, path):
    """Full-width pixtral-12b (40 layers, head dim 160, bf16 params, random
    weights from a seed): 2 requests of (1024, 1024) stub patch embeddings
    and 16-64 text tokens (right-aligned into 64), `prefill` with
    vision_embeds, 32 greedy `decode_step`s."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import patch_embeddings
    from repro_torch.kernels import flash_attention
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("pixtral-12b")
    B, nv = 2, cfg.num_vision_tokens
    S = nv + VLM_TEXT
    cache_len = S + VLM_NEW
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    lens = rng.integers(16, VLM_TEXT + 1, size=B)
    toks = np.zeros((B, VLM_TEXT), np.int64)
    for row, n in enumerate(lens):
        toks[row, -n:] = rng.integers(1, cfg.vocab_size, size=n)
    toks = torch.from_numpy(toks).cuda()
    ve = torch.from_numpy(patch_embeddings(0, B, nv, cfg.vision_dim)).cuda()

    def serve():
        with torch.no_grad():
            logits, cache = prefill(params, toks, cfg, cache_len,
                                    vision_embeds=ve)
            pre_flash = flash_attention.launches
            finite = [logits.isfinite().all()]
            tok = logits[:, -1].argmax(-1)
            del logits
            pos = torch.full((B,), S, device="cuda")
            out = [tok]
            for _ in range(VLM_NEW):
                logits, cache = decode_step(params, tok, pos, cache, cfg)
                finite.append(logits.isfinite().all())
                tok, pos = logits.argmax(-1), pos + 1
                out.append(tok)
        return pre_flash, torch.stack(out, 1).cpu(), bool(
            torch.stack(finite).all())

    serve()                                                  # warm-up
    torch.cuda.synchronize()
    log(f"serve-vlm: pixtral-12b {cfg.num_layers} layers, d_model="
        f"{cfg.d_model}, heads {cfg.num_heads} over {cfg.num_kv_heads} KV "
        f"heads of {cfg.head_dim}, {nv} vision tokens of {cfg.vision_dim}, "
        f"vocab {cfg.vocab_size}, params={n_params} ({cfg.dtype}), "
        f"init+warm-up {time.perf_counter() - t0:.2f}s; text lengths "
        f"{lens.tolist()}")
    torch.cuda.reset_peak_memory_stats()
    (pre_flash, out, finite), launches = _count_launches(
        kernels, path, "serve-vlm", serve)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if pre_flash != cfg.num_layers or launches["flash_attention"] != \
            cfg.num_layers:
        fail(f"serve-vlm: flash launched {pre_flash} times by prefill and "
             f"{launches['flash_attention']} in all, want {cfg.num_layers}")
    if not finite or not (0 <= int(out.min())
                          and int(out.max()) < cfg.vocab_size):
        fail(f"serve-vlm: logits finite {finite}, tokens {out[:, :8]}")
    log(f"serve-vlm: {B} requests, prefill of {S} positions + {VLM_NEW} "
        f"greedy decode steps: logits all finite, peak_mem_gb={peak:.2f}, "
        f"launches {launches}")
    with torch.no_grad():
        (logits, cache), prefill_ms = _sync_ms(
            torch, lambda: prefill(params, toks, cfg, cache_len,
                                   vision_embeds=ve))
        tok = logits[:, -1].argmax(-1)
        del logits
        pos = torch.full((B,), S, device="cuda")

        def steps(n):
            nonlocal tok, pos
            for _ in range(n):
                logits, _ = decode_step(params, tok, pos, cache, cfg)
                tok, pos = logits.argmax(-1), pos + 1

        _, decode_ms = _sync_ms(torch, lambda: steps(16))
        log(f"serve-vlm: prefill {B}x{S} positions {prefill_ms:.2f} ms; "
            f"decode {decode_ms / 16:.2f} ms per step (cache_len "
            f"{cache_len})")
        evts, _ = profile(torch, lambda: prefill(params, toks, cfg, cache_len,
                                                 vision_embeds=ve))
        wide = sum(e.count for e in evts if "flash_fwd" in e.key
                   and "160" in e.key and str(e.device_type).endswith("CUDA"))
        log(f"serve-vlm: profiled prefill: {wide} launches of the head-dim "
            f"160 flash kernel")
        if wide != cfg.num_layers:
            fail(f"serve-vlm: the D 160 flash kernel ran {wide} times in a "
                 f"prefill, want {cfg.num_layers}")
        log_profile(torch, "serve-vlm prefill", lambda: prefill(
            params, toks, cfg, cache_len, vision_embeds=ve))
        log_profile(torch, "serve-vlm decode x8", lambda: steps(8))
    del params, cache
    torch.cuda.empty_cache()
    return launches


def _lm_logits_card_vs_cpu(torch, phase, arch, engine, cfg=None):
    """`arch` SMOKE (f32; or `cfg`) on the card and the CPU from one set of
    weights: the forward's logits, a prefill and 4 greedy decode steps'
    logits and tokens, and (engine) ServingEngine's greedy tokens;
    relative to the largest CPU logit, within SLICE13_TOL.  Returns (cfg,
    CPU params, vision embeds or None)."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import patch_embeddings
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = cfg or get_smoke_config(arch)
    cpu = init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    card = _to(cpu, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(3, 91, size=6)]
    toks = torch.from_numpy(np.stack([np.resize(p, 100)
                                      for p in prompts[:4]]))
    ve = None
    if cfg.family == "vlm":
        ve = torch.from_numpy(patch_embeddings(5, 4, cfg.num_vision_tokens,
                                               cfg.vision_dim))
    S = 100 + (cfg.num_vision_tokens if ve is not None else 0)
    fwd, rows, picks, tokens = {}, {}, {}, {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        kw = {} if ve is None else {"vision_embeds": ve.to(dev)}
        with torch.no_grad():
            fwd[dev] = forward(p, toks.to(dev), cfg, **kw).cpu()
            lg, cache = prefill(p, toks.to(dev), cfg, 128, **kw)
            out, pick = [lg[:, -1]], [lg[:, -1].argmax(-1)]
            pos = torch.full((4,), S, device=dev)
            for _ in range(4):
                lg, cache = decode_step(p, pick[-1], pos, cache, cfg)
                out.append(lg)
                pick.append(lg.argmax(-1))
                pos = pos + 1
        rows[dev] = torch.stack(out).cpu()
        picks[dev] = torch.stack(pick).cpu()
        if engine:
            eng = ServingEngine(p, cfg, slots=4, max_prompt=100,
                                cache_len=128, device=dev)
            tokens[dev] = [r.tokens for r in eng.generate(
                prompts, max_new_tokens=12)]
    f_err, d_err = _rel(fwd["cuda"], fwd["cpu"]), _rel(rows["cuda"],
                                                       rows["cpu"])
    same = torch.equal(picks["cuda"], picks["cpu"]) and (
        tokens.get("cuda") == tokens.get("cpu"))
    log(f"{phase}: {arch} SMOKE ({cfg.dtype}) card vs CPU: forward logits "
        f"{f_err:.3e}, prefill + 4 decode steps' logits {d_err:.3e} "
        f"(relative, tol {SLICE13_TOL}); greedy tokens "
        f"{'identical' if same else 'DIFFER'}"
        + (" (and ServingEngine's, 6 requests x 12)" if engine else ""))
    if not (f_err <= SLICE13_TOL and d_err <= SLICE13_TOL and same):
        fail(f"{phase}: card and CPU differ ({f_err}, {d_err}, tokens "
             f"{picks} {tokens})")
    return cfg, cpu, ve


def _grads_card_vs_cpu(torch, phase, what, loss_fn, cpu_params):
    """loss_fn(params, device) -> (loss, metrics) on the CPU and the card
    from the same params: the loss and every leaf's gradient within
    SLICE13_TOL relative."""
    from repro_torch.train.steps import _value_and_grad
    card = _to(cpu_params, "cuda")
    g_cpu, m_cpu = _value_and_grad(lambda p, _: loss_fn(p, "cpu"),
                                   cpu_params, None)
    g_gpu, m_gpu = _value_and_grad(lambda p, _: loss_fn(p, "cuda"), card,
                                   None)
    a, b = float(m_gpu["loss"]), float(m_cpu["loss"])
    loss_rel, grad_rel = abs(a - b) / abs(b), _tree_rel(torch, g_gpu, g_cpu)
    log(f"{phase}: {what}: loss (card, cpu) ({a:.6f}, {b:.6f}), relative "
        f"{loss_rel:.3e}; gradients, worst leaf {grad_rel:.3e} (tol "
        f"{SLICE13_TOL})")
    if not (loss_rel <= SLICE13_TOL and grad_rel <= SLICE13_TOL):
        fail(f"{phase}: {what} differs ({loss_rel}, {grad_rel})")


def _lm_loss_card_vs_cpu(torch, phase, cfg, cpu, ve):
    from repro_torch.data import lm_batches
    from repro_torch.train.steps import lm_loss
    t, y = (torch.from_numpy(a) for a in next(lm_batches(0, 4, 100,
                                                         cfg.vocab_size)))

    def loss_fn(p, dev):
        kw = {} if ve is None else {"vision_embeds": ve.to(dev)}
        return lm_loss(p, t.to(dev), y.to(dev), cfg, **kw)

    _grads_card_vs_cpu(torch, phase, "lm_loss", loss_fn, cpu)


def phase_check_ssm(torch):
    """falcon-mamba-7b SMOKE (f32) on the card and the CPU."""
    cfg, cpu, _ = _lm_logits_card_vs_cpu(torch, "check-ssm",
                                         "falcon-mamba-7b", engine=True)
    _lm_loss_card_vs_cpu(torch, "check-ssm", cfg, cpu, None)


def phase_check_vlm(torch):
    """pixtral-12b SMOKE (f32) on the card and the CPU, with patch
    embeddings (ServingEngine cannot take them)."""
    cfg, cpu, ve = _lm_logits_card_vs_cpu(torch, "check-vlm", "pixtral-12b",
                                          engine=False)
    _lm_loss_card_vs_cpu(torch, "check-vlm", cfg, cpu, ve)


def phase_check_encdec(torch):
    """whisper-small SMOKE (f32) on the card and the CPU: forward logits,
    encode + cross_kv + 12 greedy decode steps (logits and tokens), the
    token cross-entropy's gradients; on the card, decoding against the
    cached cross K/V equals decoding with them recomputed, bit for bit."""
    import torch.nn.functional as F
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import frame_embeddings, lm_batches
    from repro_torch.models import encdec, init_params
    cfg = get_smoke_config("whisper-small")
    cpu = init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    card = _to(cpu, "cuda")
    B = 4
    frames = torch.from_numpy(frame_embeddings(5, B, cfg.encoder_seq,
                                               cfg.d_model))
    t, y = (torch.from_numpy(a) for a in next(lm_batches(0, B, 24,
                                                         cfg.vocab_size)))
    fwd, rows, picks = {}, {}, {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        with torch.no_grad():
            fwd[dev] = encdec.forward(p, frames.to(dev), t.to(dev), cfg).cpu()
            enc = encdec.encode(p, frames.to(dev), cfg)
            cache = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq,
                                          device=dev)
            cache["xk"], cache["xv"] = encdec.cross_kv(p, enc, cfg)
            tok, out, pick = t[:, 0].to(dev), [], []
            for i in range(12):
                lg, cache = encdec.decode_step(
                    p, tok, torch.full((B,), i, device=dev), cache, cfg)
                tok = lg.argmax(-1)
                out.append(lg)
                pick.append(tok)
        rows[dev], picks[dev] = torch.stack(out).cpu(), torch.stack(pick).cpu()
    f_err, d_err = _rel(fwd["cuda"], fwd["cpu"]), _rel(rows["cuda"],
                                                       rows["cpu"])
    same = torch.equal(picks["cuda"], picks["cpu"])
    log(f"check-encdec: whisper-small SMOKE (f32) card vs CPU: forward "
        f"logits {f_err:.3e}, 12 decode steps' logits {d_err:.3e} "
        f"(relative, tol {SLICE13_TOL}); greedy tokens "
        f"{'identical' if same else 'DIFFER'}")
    if not (f_err <= SLICE13_TOL and d_err <= SLICE13_TOL and same):
        fail(f"check-encdec: card and CPU differ ({f_err}, {d_err})")

    with torch.no_grad():
        enc = encdec.encode(card, frames.cuda(), cfg)
        kv1, kv2 = encdec.cross_kv(card, enc, cfg), encdec.cross_kv(card, enc,
                                                                    cfg)
        exact = all(torch.equal(a, b) for a, b in zip(kv1, kv2))
        cached = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq,
                                       device="cuda")
        fresh = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq,
                                      device="cuda")
        cached["xk"], cached["xv"] = kv1
        tok = t[:, 0].cuda()
        for i in range(6):
            pos = torch.full((B,), i, device="cuda")
            fresh["xk"], fresh["xv"] = encdec.cross_kv(card, enc, cfg)
            a, cached = encdec.decode_step(card, tok, pos, cached, cfg)
            b, fresh = encdec.decode_step(card, tok, pos, fresh, cfg)
            exact = exact and torch.equal(a, b)
            tok = a.argmax(-1)
    log(f"check-encdec: on the card, cross_kv twice and 6 decode steps "
        f"against cached vs recomputed cross K/V: bit-identical {exact}")
    if not exact:
        fail("check-encdec: the cached cross K/V are not exact")

    def loss_fn(p, dev):
        logits = encdec.forward(p, frames.to(dev), t.to(dev), cfg).float()
        nll = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                              y.to(dev).reshape(-1).long())
        return nll, {"loss": nll}

    _grads_card_vs_cpu(torch, "check-encdec", "token cross-entropy through "
                       "encdec.forward", loss_fn, cpu)


# ----------------------------------------------------------------------
# slice 14: the moe family (arctic-480b with GQA, deepseek-v2-236b with MLA)
# ----------------------------------------------------------------------

# (arch, layers served): neither model fits one 80 GB card whole, so the
# depth is cut (widths, experts, top-k, capacity factor and MLA ranks stay
# as published); arctic's 2 layers are 54.6 GB of bf16, deepseek's 8 are 64.8
MOE_SERVE = (("arctic-480b", 2), ("deepseek-v2-236b", 8))
MOE_NEW = 16                 # new tokens a request
MOE_INIT_EXTRA_GB = 1.0      # init's peak above the params it holds
MOE_LOSS_TOL = 1e-5          # check-moe: lm_loss and its MoE terms, relative
MOE_MARGIN = 1e-4            # least relative gap of the k-th and (k+1)-th prob
SPLIT_KERNEL = "flash_fwdI13__nv_bfloat16Li192ELb1ELb0ELi128E"
# the training instantiations above head dim 128: the kLse forwards
# (flash_attention_lse.cu) and the wide backward's dK/dV and dQ kernels
# (flash_attention_bwd_wide.cu), at 160 and 192 over 128
WIDE_LSE_KERNELS = ("flash_fwdI13__nv_bfloat16Li160ELb1ELb1E",
                    "flash_fwdI13__nv_bfloat16Li192ELb1ELb1ELi128E")
WIDE_BWD_KERNELS = tuple(
    f"flash_bwd_{k}_wideILi{d}ELi{dv}EE"
    for d, dv in ((160, 160), (192, 128)) for k in ("dkdv", "dq"))


def ptxas_usage(fragment: str):
    """(registers, spill store bytes, spill load bytes) ptxas reported for
    the kernel whose mangled name holds `fragment` (None if absent)."""
    import re
    from repro_torch.kernels import _build
    m = re.search(rf"Function properties for \S*{fragment}\S*\n\s*\d+ bytes "
                  rf"stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                  rf"loads\n.*?Used (\d+) registers", _build.build_log())
    return None if m is None else (int(m.group(3)), int(m.group(1)),
                                   int(m.group(2)))


def wide_usage():
    """{instantiation: (registers, spill store, spill load bytes)} of the
    wide backward's kernels (WIDE_BWD_KERNELS), from the build log."""
    return {tag: ptxas_usage(tag) for tag in WIDE_BWD_KERNELS}


def bwd_vs_library(torch, B, S, H, KH, D, Dv, dtype):
    """(ms, library ms) a call at a path's attention shape (causal, one
    seeded input): the flash backward from the routed training forward's o
    and lse, and SDPA forward + backward, the yardstick the port never
    calls, in the same run."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                     ops)
    gen = torch.Generator(device="cuda").manual_seed(30)
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                   for sh in ((B, S, H, D), (B, S, KH, D), (B, S, KH, Dv),
                              (B, S, H, Dv)))
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    o = ops._forward(q, k, v, True, 0, 1.0 / math.sqrt(D), lse,
                     route_entry(ops, q, k, v, True))
    ms = cuda_ms(torch, lambda: flash_attention_backward(q, k, v, o, do, lse,
                                                         causal=True))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=KH != H)
        return torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    lib_ms = cuda_ms(torch, sdpa_fwd_bwd)
    del q, k, v, do, o, lse, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return ms, lib_ms


def moe_spans(torch, fn):
    """fn() with every `transformer.moe_forward` call bounded by CUDA events:
    (device ms inside the MoE layers, device ms of all of fn(), the calls,
    the (token, choice) pairs dropped past capacity, fn()'s result).  fn()
    must not wait on the host inside (a prefill or a decode step does not),
    so the events bound exactly the MoE's kernels in stream order."""
    from repro_torch.models import transformer
    spans, drops, orig = [], [], transformer.moe_forward

    def timed_moe(*a, **k):
        a0, b0 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a0.record()
        out = orig(*a, **k)
        b0.record()
        spans.append((a0, b0))
        drops.append(out[1]["dropped"])
        return out

    transformer.moe_forward = timed_moe
    try:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
    finally:
        transformer.moe_forward = orig
    return (sum(a0.elapsed_time(b0) for a0, b0 in spans),
            start.elapsed_time(end), len(spans),
            int(torch.stack(drops).sum()), out)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _serve_moe(torch, kernels, path, arch, depth):
    """Full-width `arch` cut to `depth` layers behind ServingEngine: 4
    slots, 4 greedy requests of 64-500 prompt tokens (max_prompt 512),
    MOE_NEW tokens each; then a prefill and decode steps on their own,
    the MoE's share of their device time, the drops, the flash kernels
    by name and the idle share."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, params_shape, \
        prefill
    from repro_torch.models.moe import capacity
    from repro_torch.serving import ServingEngine
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=depth)
    slots, max_prompt, cache_len = 4, 512, 1024
    full_gb = _tree_bytes(params_shape(full)) / 1e9
    layer_gb = (_tree_bytes(params_shape(dataclasses.replace(
        full, num_layers=2))) - _tree_bytes(params_shape(
            dataclasses.replace(full, num_layers=1)))) / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    held_gb = _tree_bytes(params) / 1e9
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    attn = (f"MLA (rank {cfg.kv_lora_rank}, q/k head dim "
            f"{cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} over v "
            f"{cfg.v_head_dim})" if cfg.use_mla else
            f"GQA {cfg.num_heads} over {cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}")
    log(f"serve-moe: {arch} {depth} of {full.num_layers} layers, d_model="
        f"{cfg.d_model}, {attn}, {cfg.num_experts} experts of d_ff "
        f"{cfg.d_ff} top-{cfg.experts_per_token}, capacity factor "
        f"{cfg.capacity_factor}, shared {cfg.num_shared_experts}, dense "
        f"residual {cfg.dense_ff}, vocab {cfg.vocab_size}; params="
        f"{n_params} ({held_gb:.2f} GB, bf16 with f32 routers), init "
        f"{init_s:.2f}s, init peak {init_peak:.2f} GB. Depth cut: the full "
        f"model is {full_gb:.1f} GB of params ({layer_gb:.2f} GB a layer), "
        f"the card {card_gb:.1f} GB; {depth} layers and the embeddings fit "
        f"beside the activations")
    if init_peak > held_gb + MOE_INIT_EXTRA_GB:
        fail(f"serve-moe: {arch}: init peaked at {init_peak:.2f} GB, over "
             f"{MOE_INIT_EXTRA_GB} GB above its {held_gb:.2f} GB of params")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 501, size=slots)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    eng = ServingEngine(params, cfg, slots=slots, max_prompt=max_prompt,
                        cache_len=cache_len, device="cuda")
    eng.generate(prompts, max_new_tokens=2)                 # warm-up
    flags = _watch_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = _count_launches(
        kernels, path, "serve-moe",
        lambda: eng.generate(prompts, max_new_tokens=MOE_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(res) != len(prompts) or any(
            len(r.tokens) != MOE_NEW or not all(0 <= t < cfg.vocab_size
                                                for t in r.tokens)
            for r in res):
        fail(f"serve-moe: {arch}: "
             f"{[(r.request_id, r.tokens[:4]) for r in res]}")
    if not bool(torch.stack(flags).all()):
        fail(f"serve-moe: {arch}: a logit was not finite")
    if launches["flash_attention"] != depth:
        fail(f"serve-moe: {arch}: flash launched "
             f"{launches['flash_attention']} times, want {depth}")
    if peak >= card_gb:
        fail(f"serve-moe: {arch}: peak {peak:.2f} GB >= the card's")
    ntok = sum(len(r.tokens) for r in res)
    log(f"serve-moe: {arch}: {len(res)} requests (prompts {lens.tolist()}) "
        f"x {MOE_NEW} tokens in {wall:.3f}s wall, {ntok / wall:.1f} tok/s, "
        f"{len(flags)} logit rows finite, peak_mem_gb={peak:.2f}, launches "
        f"{launches}")

    toks = torch.from_numpy(np.stack([np.resize(p, max_prompt)
                                      for p in prompts])).cuda()
    with torch.no_grad():
        (logits, cache), prefill_ms = _sync_ms(
            torch, lambda: prefill(params, toks, cfg, cache_len))
        if not bool(logits.isfinite().all()):
            fail(f"serve-moe: {arch}: a prefill logit was not finite")
        tok = logits[:, -1].argmax(-1)
        del logits
        pos = torch.full((slots,), max_prompt, device="cuda")

        def steps(n):
            nonlocal tok, pos
            for _ in range(n):
                lg, _ = decode_step(params, tok, pos, cache, cfg)
                tok, pos = lg.argmax(-1), pos + 1

        _, decode_ms = _sync_ms(torch, lambda: steps(8))
        log(f"serve-moe: {arch}: prefill {slots}x{max_prompt} tokens "
            f"{prefill_ms:.2f} ms; decode {decode_ms / 8:.2f} ms a step "
            f"({slots} slots, cache_len {cache_len})")
        moe_ms, pre_ms, calls, dropped, (lg, _) = moe_spans(
            torch, lambda: prefill(params, toks, cfg, cache_len))
        del lg
        log(f"serve-moe: {arch}: prefill: the MoE layers (CUDA events at "
            f"their edges, {calls} calls) {moe_ms:.2f} ms of "
            f"{pre_ms:.2f} device ms (share {moe_ms / pre_ms:.4f}); "
            f"{dropped} of "
            f"{slots * max_prompt * cfg.experts_per_token * depth} "
            f"(token, choice) pairs dropped past capacity (capacity "
            f"{capacity(cfg, slots * max_prompt)} a layer)")
        d_moe, d_ms, d_calls, d_drop, _ = moe_spans(torch, lambda: steps(1))
        log(f"serve-moe: {arch}: a decode step: the MoE {d_moe:.2f} ms of "
            f"{d_ms:.2f} device ms (share {d_moe / d_ms:.4f}, {d_calls} "
            f"calls); {d_drop} of {slots * cfg.experts_per_token * depth} "
            f"pairs dropped (capacity {capacity(cfg, slots)})")
        # a profile holding fewer flash kernels than the wrapper launched
        # lost CUPTI records (the program made them): profiled again, three
        # profiles at most, as profile_plan does for the plan's copies
        flash = next(k for k in kernels if k.__name__ == "flash_attention")
        for _ in range(3):
            before = flash.launches
            evts, _ = profile(torch, lambda: prefill(params, toks, cfg,
                                                     cache_len))
            host = flash.launches - before
            by_name = {e.key[:90]: e.count for e in evts
                       if "flash_fwd" in e.key
                       and str(e.device_type).endswith("CUDA")}
            if sum(by_name.values()) >= host:
                break
            log(f"serve-moe: {arch}: the profile holds "
                f"{sum(by_name.values())} flash kernels of the {host} "
                f"launched: CUPTI records lost, profiling again")
        log(f"serve-moe: {arch}: profiled prefill: flash kernels by name "
            f"{by_name} ({host} launched)")
        split = sum(n for k, n in by_name.items() if "192" in k)
        want = depth if cfg.use_mla else 0
        if sum(by_name.values()) != depth or host != depth or split != want:
            fail(f"serve-moe: {arch}: flash kernels {by_name} ({host} "
                 f"launched), want {depth} launches, {want} of the split "
                 f"(192 over 128) kernel")
        log_profile(torch, f"serve-moe {arch} prefill",
                    lambda: prefill(params, toks, cfg, cache_len))
        log_profile(torch, f"serve-moe {arch} decode x4", lambda: steps(4))
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe(torch, kernels, path):
    """arctic-480b (2 of 35 layers), then deepseek-v2-236b (8 of 60), at
    full width with random bf16 weights from seed 0, one at a time, each
    dropped before the next."""
    total = no_launches(kernels)
    for arch, depth in MOE_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        launches = _serve_moe(torch, kernels, path, arch, depth)
        total = {k: total[k] + v for k, v in launches.items()}
    return total


def _moe_routing_card_vs_cpu(torch, arch, cfg, cpu):
    """Each layer's MoE on one (4, 100, d) input at the config's capacity
    factor and at 0.5 (drops): routing identical on the card and the CPU
    (top-k experts, queue positions, keep) once every token's k-th and
    (k+1)-th CPU probabilities are MOE_MARGIN relative apart; outputs and
    losses within SLICE13_TOL relative; the same drops."""
    import dataclasses
    import numpy as np
    from repro_torch.core.engine import layer_list
    from repro_torch.models import moe
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 100, cfg.d_model)).astype(np.float32))
    worst, least_gap, drops = 0.0, 1.0, []
    for cf in (cfg.capacity_factor, 0.5):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        for p in layer_list(cpu["blocks"]):
            pm = p["moe"]
            got = {}
            for dev, q in (("cuda", _to(pm, "cuda")), ("cpu", pm)):
                with torch.no_grad():
                    xd = x.to(dev)
                    logits = xd.reshape(-1, c.d_model) @ q["router"]
                    r = moe.route(logits, c.experts_per_token,
                                  moe.capacity(c, 400))
                    y, aux = moe.moe_forward(q, xd, c)
                got[dev] = ([t.cpu() for t in r], y.cpu(),
                            {k: v.cpu() for k, v in aux.items()})
            probs = got["cpu"][0][0]
            top = probs.sort(-1, descending=True).values
            k = c.experts_per_token
            gap = float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min())
            least_gap = min(least_gap, gap)
            if gap < MOE_MARGIN:
                fail(f"check-moe: {arch}: a token's top-{k} margin {gap:.2e} "
                     f"< {MOE_MARGIN}: the routing comparison would hang on "
                     f"the sum order")
            same = all(torch.equal(a, b) for a, b in zip(got["cuda"][0][2:],
                                                         got["cpu"][0][2:]))
            if not same:
                fail(f"check-moe: {arch}: routing differs at capacity factor "
                     f"{cf}")
            worst = max(worst, _rel(got["cuda"][1], got["cpu"][1]),
                        *(_rel(got["cuda"][2][n], got["cpu"][2][n])
                          for n in ("load_balance_loss", "router_z_loss")))
            if int(got["cuda"][2]["dropped"]) != int(got["cpu"][2]["dropped"]):
                fail(f"check-moe: {arch}: drops differ")
            drops.append(int(got["cpu"][2]["dropped"]))
    log(f"check-moe: {arch}: routing identical on the card and the CPU at "
        f"capacity factors {cfg.capacity_factor} and 0.5 (least top-k margin "
        f"{least_gap:.2e} >= {MOE_MARGIN}; drops per layer {drops}); MoE "
        f"outputs and losses {worst:.3e} relative (tol {SLICE13_TOL})")
    if not worst <= SLICE13_TOL or not any(drops):
        fail(f"check-moe: {arch}: MoE outputs differ by {worst} or no drops "
             f"at capacity factor 0.5")


def phase_check_moe(torch):
    """arctic-480b and deepseek-v2-236b SMOKE (f32) on the card and the
    CPU: forward, prefill and decode logits, ServingEngine's tokens, the
    forward's MoE losses, the routing, lm_loss with its MoE terms and its
    gradients, one AdamW step."""
    from repro_torch.data import lm_batches
    from repro_torch.models import forward
    from repro_torch.train.steps import _value_and_grad, lm_loss
    for arch, _ in MOE_SERVE:
        cfg, cpu, _ = _lm_logits_card_vs_cpu(torch, "check-moe", arch,
                                             engine=True)
        card = _to(cpu, "cuda")
        t, y = (torch.from_numpy(a) for a in next(lm_batches(0, 4, 100,
                                                             cfg.vocab_size)))
        aux = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            with torch.no_grad():
                aux[dev] = forward(p, t.to(dev), cfg, with_aux=True)[1]
        aux_rel = max(_rel(aux["cuda"][n], aux["cpu"][n])
                      for n in ("load_balance_loss", "router_z_loss"))
        log(f"check-moe: {arch}: the forward's summed MoE losses "
            f"{aux_rel:.3e} relative (tol {SLICE13_TOL}), drops "
            f"{int(aux['cuda']['dropped'])} / {int(aux['cpu']['dropped'])}")
        if not (aux_rel <= SLICE13_TOL
                and int(aux["cuda"]["dropped"]) == int(aux["cpu"]["dropped"])):
            fail(f"check-moe: {arch}: the forward's aux differs")
        _moe_routing_card_vs_cpu(torch, arch, cfg, cpu)

        def loss_fn(p, dev):
            return lm_loss(p, t.to(dev), y.to(dev), cfg)

        g_cpu, m_cpu = _value_and_grad(lambda p, _: loss_fn(p, "cpu"), cpu,
                                       None)
        g_gpu, m_gpu = _value_and_grad(lambda p, _: loss_fn(p, "cuda"), card,
                                       None)
        m_rel = max(abs(float(m_gpu[k]) - float(m_cpu[k]))
                    / abs(float(m_cpu[k])) for k in m_cpu)
        g_rel = _tree_rel(torch, g_gpu, g_cpu)
        log(f"check-moe: {arch}: lm_loss {float(m_cpu['loss']):.6f}, "
            f"lb_loss {float(m_cpu['lb_loss']):.6f}, z_loss "
            f"{float(m_cpu['z_loss']):.6f}: card vs CPU {m_rel:.3e} relative "
            f"(tol {MOE_LOSS_TOL}); gradients, worst leaf {g_rel:.3e} (tol "
            f"{SLICE13_TOL})")
        if not (m_rel <= MOE_LOSS_TOL and g_rel <= SLICE13_TOL):
            fail(f"check-moe: {arch}: lm_loss or its gradients differ "
                 f"({m_rel}, {g_rel})")
        _adamw_step_card_vs_cpu(torch, arch)


def _adamw_step_card_vs_cpu(torch, arch):
    """One AdamW step of `arch` SMOKE (f32) from one state and batch (8 x
    100) on the card and the CPU, held in its two conditioned parts: the
    gradients within CHECK_TRAIN_TOL per leaf, and the step applied to the
    CPU's gradients on both devices (params and moments within
    CHECK_TRAIN_TOL).  The step from each device's own gradients follows:
    its moments are gated too; its params are logged, not gated, because
    AdamW's first update is lr * g / (|g| + eps), about lr * sign(g), and
    a gradient element near 0 flips sign within the gradients' own
    agreement (tools/adamw_first_step.py on the CPU: noise of 1e-6 of each
    leaf's largest gradient moves deepseek-v2 SMOKE's params 3.7e-3
    relative, arctic's 4.2e-4, tinyllama's 3.1e-4; the moments 6e-6)."""
    from repro_torch.data import lm_batches
    from repro_torch.train.steps import _optimize, _value_and_grad, lm_loss
    from repro_torch.tree import tree_map
    cfg, cpu, card = _lm_state_pair(torch, arch)
    own = tree_map(lambda t: t.clone(), card)
    t, y = (torch.from_numpy(a) for a in next(lm_batches(0, 8, 100,
                                                         cfg.vocab_size)))
    g_cpu, m = _value_and_grad(lambda p, _: lm_loss(p, t, y, cfg),
                               cpu.params, None)
    g_gpu, _ = _value_and_grad(lambda p, _: lm_loss(p, t.cuda(), y.cuda(),
                                                    cfg), card.params, None)
    kw = dict(peak_lr=3e-4, warmup=0, total_steps=1, max_grad_norm=1.0,
              weight_decay=0.1)
    g_rel = _tree_rel(torch, g_gpu, g_cpu)
    cpu, _ = _optimize(cpu, g_cpu, m, **kw)
    card, _ = _optimize(card, _to(g_cpu, "cuda"), m, **kw)
    own, _ = _optimize(own, g_gpu, m, **kw)
    same_g = _tree_rel(torch, card, cpu)
    own_mom = max(_tree_rel(torch, own.opt.mu, cpu.opt.mu),
                  _tree_rel(torch, own.opt.nu, cpu.opt.nu))
    own_par = _tree_rel(torch, own.params, cpu.params)
    log(f"check-moe: {arch} SMOKE one AdamW step at 8 x 100: gradients "
        f"{g_rel:.3e}; the step from the CPU's gradients, params and "
        f"moments {same_g:.3e}; from each device's own, moments "
        f"{own_mom:.3e} (each tol {CHECK_TRAIN_TOL}), params {own_par:.3e} "
        f"(not gated: the first update is about lr * sign(g))")
    if not max(g_rel, same_g, own_mom) <= CHECK_TRAIN_TOL:
        fail(f"check-moe: {arch}: the AdamW step differs ({g_rel}, {same_g}, "
             f"{own_mom})")


# train-wide: the two models whose attention heads are wider than 128, at
# full width on the card, depth cut as one card's 80 GB forces
TRAIN_WIDE_DEPTH = {"pixtral-12b": 4, "deepseek-v2-236b": 1}
TRAIN_WIDE_STEPS = 4         # pixtral: step 1 eager, then the captured step
TRAIN_WIDE_BATCH, TRAIN_WIDE_TEXT = 2, 64    # x (1024 patches + 64 tokens)
TRAIN_WIDE_MLA_TOKENS = (2, 512)
# check-train-wide: SMOKE with the published head dims put back, bf16
WIDE_HEADS = {"pixtral-12b": dict(head_dim=160),
              "deepseek-v2-236b": dict(qk_nope_head_dim=128,
                                       qk_rope_head_dim=64, v_head_dim=128)}
# bf16 params: every leaf's gradient within the repo's bf16 gate, 5e-2
# relative (H100 runs: pixtral's worst leaf 1.65e-2, its AdamW moments
# 1.88e-2; deepseek-v2 at top-4 of 4 1.93e-2, at its own top-2 0.127 from
# a flipped choice, so not gated there); the loss within 1e-3 (measured
# 7.8e-7, 3.1e-5 and 1.04e-4)
CHECK_WIDE_TOL, CHECK_WIDE_LOSS_TOL = 5e-2, 1e-3


def _param_gb(cfg):
    """(bf16 GB of params a layer, GB of the rest: embeddings, head,
    projections) of cfg at full width, from the meta device."""
    import dataclasses
    from repro_torch.models import params_shape
    one, two = (_tree_bytes(params_shape(dataclasses.replace(
        cfg, num_layers=n))) / 1e9 for n in (1, 2))
    return two - one, one - (two - one)


def _wide_kernels_by_name(torch, fn):
    """{flash kernel name: count} of one fn() under the profiler (names
    demangled: "flash_bwd_dq_wide<160, 160>(...")."""
    evts, _ = profile(torch, fn)
    return {e.key[:110]: e.count for e in evts
            if ("flash_bwd" in e.key or "flash_fwd" in e.key)
            and str(e.device_type).endswith("CUDA")}


def _train_wide_pixtral(torch, kernels, path):
    """Full-width pixtral-12b cut to TRAIN_WIDE_DEPTH layers, trained
    through train_loop(jit=True) (step 1 eager, then the captured step) on
    batches of 2 x (1024 patch embeddings + 64 tokens)."""
    import dataclasses
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, patch_embeddings
    from repro_torch.train.loop import StepProgram, train_loop
    from repro_torch.train.steps import init_train_state, make_lm_train_step
    from repro_torch.tree import tree_leaves
    arch, steps = "pixtral-12b", TRAIN_WIDE_STEPS
    full = get_config(arch)
    depth = TRAIN_WIDE_DEPTH[arch]
    cfg = dataclasses.replace(full, num_layers=depth)
    layer_gb, rest_gb = _param_gb(full)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"train-wide: {arch} {depth} of {full.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}. Depth cut: "
        f"{layer_gb:.3f} GB of bf16 params a layer and {rest_gb:.2f} GB of "
        f"embeddings, head and vision projection; params, gradients, the "
        f"clip's f32 copies and f32 AdamW moments take about 8x the bf16 "
        f"params, {8 * (depth * layer_gb + rest_gb):.1f} GB at {depth} "
        f"layers ({8 * (full.num_layers * layer_gb + rest_gb):.0f} GB at "
        f"{full.num_layers}) of the card's {card_gb:.1f} GB")
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    log(f"train-wide: {arch}: params={n_params} init "
        f"{time.perf_counter() - t0:.2f}s; batch {TRAIN_WIDE_BATCH} x "
        f"({cfg.num_vision_tokens} patches + {TRAIN_WIDE_TEXT} tokens), "
        f"{steps} steps, warmup 0")
    it = lm_batches(0, TRAIN_WIDE_BATCH, TRAIN_WIDE_TEXT, cfg.vocab_size)
    made = []
    for i in range(steps + 2):
        t, y = next(it)
        made.append({"tokens": torch.from_numpy(t).cuda(),
                     "targets": torch.from_numpy(y).cuda(),
                     "vision_embeds": torch.from_numpy(patch_embeddings(
                         i, TRAIN_WIDE_BATCH, cfg.num_vision_tokens,
                         cfg.vision_dim)).cuda()})
    stamps = []

    def batches():
        for b in made[:steps + 1]:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield b

    step = make_lm_train_step(cfg, peak_lr=3e-4, warmup=0,
                              total_steps=steps + 2)
    torch.cuda.reset_peak_memory_stats()
    (state, hist), launches = _count_launches(
        kernels, path, "train-wide", lambda: train_loop(
            step, state, batches(), steps, log_every=1,
            log_fn=lambda m: log(f"train-wide: {arch}: {m}"), jit=True))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])][:steps]
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train-wide: {arch}: losses {losses}")
    for name in ("flash_attention", "flash_attention_backward"):
        if launches[name] != depth * steps:
            fail(f"train-wide: {arch}: {name} launched {launches[name]} "
                 f"times, want {depth} a step")
    log(f"train-wide: {arch}: {steps} steps through train_loop(jit=True), "
        f"losses {losses}, grad norms {[h['grad_norm'] for h in hist]}; ms "
        f"a step (host clock, synchronized) {[round(x, 1) for x in ms]} "
        f"(step 1 eager, step 2 the capture and its replay, then replays: "
        f"median of steps 3-{steps} {statistics.median(ms[2:]):.1f}); "
        f"peak_mem_gb={peak:.2f}; launches {launches}")
    batch = made[steps + 1]
    parts, bwd_ms, busy, pwall, kern = train_profile(
        torch, lambda: step(state, batch))
    by_name = {e.key[:110]: e.count for e in kern if "flash_" in e.key}
    log(f"train-wide: {arch}: a profiled eager step: wall {pwall:.1f} ms, "
        f"device kernels {busy:.1f} ms; device ms between each part's "
        f"edges (CUDA events) "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f"; flash backward {bwd_ms:.2f} ms (share of kernel time "
        f"{bwd_ms / busy:.4f}); flash kernels by name {by_name}")
    for e in sorted(kern, key=_self_device_us, reverse=True)[:10]:
        log(f"profile: {_self_device_us(e) / 1e3:9.3f} ms "
            f"{100 * _self_device_us(e) / 1e3 / busy:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    wide = sum(n for k, n in by_name.items()
               if "flash_bwd_dq_wide<160, 160>" in k)
    bwd_ms, lib_ms = bwd_vs_library(
        torch, TRAIN_WIDE_BATCH, cfg.num_vision_tokens + TRAIN_WIDE_TEXT,
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.head_dim,
        torch.bfloat16)
    log(f"train-wide: {arch}: the wide backward at the layer's attention "
        f"shape {bwd_ms:.4f} ms a call against SDPA forward + backward "
        f"{lib_ms:.4f} (the yardstick); registers, spill store and load "
        f"bytes {wide_usage()}")
    if wide != depth:
        fail(f"train-wide: {arch}: the profiled step ran the D 160 dQ "
             f"kernel {wide} times, want {depth}")
    _, metrics = step(state, batch)
    prog = StepProgram(step, state, batch, metrics)
    busy, pwall, share = _idle_share(torch, lambda: prog(batch))
    log(f"train-wide: {arch}: a captured step's replay: profiled wall "
        f"{pwall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{share:.3f}")
    del state, prog, made, batch
    torch.cuda.empty_cache()
    return launches


def _train_wide_mla(torch, kernels, path):
    """Full-width deepseek-v2-236b cut to TRAIN_WIDE_DEPTH layers: lm_loss
    with its MoE terms and its gradients at 2 x 512 tokens (an AdamW step
    does not fit)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import init_params
    from repro_torch.train.steps import _value_and_grad, lm_loss
    from repro_torch.tree import tree_leaves
    arch = "deepseek-v2-236b"
    full = get_config(arch)
    depth = TRAIN_WIDE_DEPTH[arch]
    cfg = dataclasses.replace(full, num_layers=depth)
    layer_gb, rest_gb = _param_gb(full)
    held = depth * layer_gb + rest_gb
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"train-wide: {arch} {depth} of {full.num_layers} layers, d_model "
        f"{cfg.d_model}, MLA {cfg.num_heads} heads of q/k "
        f"{cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} over v "
        f"{cfg.v_head_dim}, {cfg.num_experts} experts. Depth cut: "
        f"{layer_gb:.2f} GB of bf16 params a layer, {rest_gb:.2f} GB of "
        f"embeddings and head: {held:.1f} GB at {depth}; an AdamW step "
        f"adds the clip's f32 copies and f32 moments, about "
        f"{6 * held:.0f} GB more, past the card's {card_gb:.1f} GB, so "
        f"the phase takes the loss and its gradients")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    B, S = TRAIN_WIDE_MLA_TOKENS
    t, y = (torch.from_numpy(a).cuda()
            for a in next(lm_batches(0, B, S, cfg.vocab_size)))

    def run():
        return _value_and_grad(lambda p, _: lm_loss(p, t, y, cfg), params,
                               None)

    torch.cuda.reset_peak_memory_stats()
    (grads, m), launches = _count_launches(kernels, path, "train-wide", run)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    vals = {k: float(v) for k, v in m.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    if not (all(map(math.isfinite, vals.values())) and finite):
        fail(f"train-wide: {arch}: loss {vals}, gradients finite {finite}")
    for name in ("flash_attention", "flash_attention_backward"):
        if launches[name] != depth:
            fail(f"train-wide: {arch}: {name} launched {launches[name]} "
                 f"times, want {depth}")
    del grads
    _, ms = _sync_ms(torch, run)
    by_name = _wide_kernels_by_name(torch, run)
    split = sum(n for k, n in by_name.items() if "_wide<192, 128" in k)
    bwd_ms, lib_ms = bwd_vs_library(
        torch, B, S, cfg.num_heads, cfg.num_heads,
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim,
        torch.bfloat16)
    log(f"train-wide: {arch}: the split backward at the layer's attention "
        f"shape {bwd_ms:.4f} ms a call against SDPA forward + backward "
        f"{lib_ms:.4f} (the yardstick); registers, spill store and load "
        f"bytes {wide_usage()}")
    log(f"train-wide: {arch}: lm_loss {vals} at {B} x {S} tokens, every "
        f"gradient finite; loss and gradients {ms:.1f} ms (host clock, "
        f"synchronized, second run); peak_mem_gb={peak:.2f}; launches "
        f"{launches}; flash kernels by name {by_name}")
    if split != 2 * depth:
        fail(f"train-wide: {arch}: the split backward's two product "
             f"kernels (dK/dV, dQ) ran {split} times, want {2 * depth}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_train_wide(torch, kernels, path):
    """pixtral-12b and deepseek-v2-236b trained at full width on the card
    through the head-dim-160 and split (192 over 128) training kernels,
    one at a time, each dropped before the next."""
    total = _train_wide_pixtral(torch, kernels, path)
    gc.collect()
    torch.cuda.empty_cache()
    mla = _train_wide_mla(torch, kernels, path)
    return {k: total[k] + mla[k] for k in total}


def _wide_grads_card_vs_cpu(torch, arch, cfg, what, gate_leaves):
    """lm_loss and its gradients of `cfg` (bf16 params from seed 5) on the
    card and the CPU from one batch: the loss within CHECK_WIDE_LOSS_TOL
    relative, and (gate_leaves) every leaf's gradient within
    CHECK_WIDE_TOL.  Returns (CPU params, tokens, targets, vision embeds
    or None)."""
    from repro_torch.data import lm_batches, patch_embeddings
    from repro_torch.kernels import flash_attention_backward
    from repro_torch.models import init_params
    from repro_torch.train.steps import _value_and_grad, lm_loss
    cpu = init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    t, y = (torch.from_numpy(a) for a in next(lm_batches(
        0, 4, 100, cfg.vocab_size)))
    ve = torch.from_numpy(patch_embeddings(
        5, 4, cfg.num_vision_tokens, cfg.vision_dim)) \
        if cfg.family == "vlm" else None

    def loss_fn(p, dev):
        kw = {} if ve is None else {"vision_embeds": ve.to(dev)}
        return lm_loss(p, t.to(dev), y.to(dev), cfg, **kw)

    g_cpu, m_cpu = _value_and_grad(lambda p, _: loss_fn(p, "cpu"), cpu, None)
    before = flash_attention_backward.launches
    g_gpu, m_gpu = _value_and_grad(lambda p, _: loss_fn(p, "cuda"),
                                   _to(cpu, "cuda"), None)
    n_bwd = flash_attention_backward.launches - before
    a, b = float(m_gpu["loss"]), float(m_cpu["loss"])
    loss_rel, grad_rel = abs(a - b) / abs(b), _tree_rel(torch, g_gpu, g_cpu)
    log(f"check-train-wide: {arch} {what}: lm_loss (card, cpu) ({a:.6f}, "
        f"{b:.6f}), relative {loss_rel:.3e} (tol {CHECK_WIDE_LOSS_TOL}); "
        f"gradients, worst leaf {grad_rel:.3e} "
        + (f"(tol {CHECK_WIDE_TOL})" if gate_leaves else
           "(not gated: a top-k choice near its tie flips under the two "
           "devices' bf16 sums and moves whole experts' gradients)")
        + f"; {n_bwd} flash backward launches on the card")
    if n_bwd != cfg.num_layers:
        fail(f"check-train-wide: {arch}: the flash backward launched "
             f"{n_bwd} times, want {cfg.num_layers}")
    if not (loss_rel <= CHECK_WIDE_LOSS_TOL
            and (grad_rel <= CHECK_WIDE_TOL or not gate_leaves)):
        fail(f"check-train-wide: {arch} {what}: card and CPU differ "
             f"({loss_rel}, {grad_rel})")
    return cpu, t, y, ve


def phase_check_train_wide(torch):
    """pixtral-12b and deepseek-v2-236b SMOKE with their published head
    dims put back (160; q/k 192 over v 128) and bf16 params, on the card
    and the CPU: lm_loss, every leaf's gradient and one pixtral train
    step's AdamW moments within CHECK_WIDE_TOL relative.  deepseek-v2's
    leaves are gated with every token routed to all 4 experts (top-4 of
    4), where no choice can flip; at its top-2 the loss is gated and the
    leaves logged."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import TrainState, make_lm_train_step
    from repro_torch.tree import tree_map
    arch = "pixtral-12b"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                              **WIDE_HEADS[arch])
    cpu, t, y, ve = _wide_grads_card_vs_cpu(torch, arch, cfg,
                                            str(WIDE_HEADS[arch]), True)
    # one AdamW step from one state and batch on both devices
    step = make_lm_train_step(cfg, warmup=0, total_steps=1)
    st_cpu = TrainState(cpu, adamw_init(cpu))
    st_gpu = tree_map(lambda x: x.to("cuda", copy=True), st_cpu)
    batch = {"tokens": t, "targets": y, "vision_embeds": ve}
    st_cpu, _ = step(st_cpu, batch)
    st_gpu, _ = step(st_gpu, {k: v.cuda() for k, v in batch.items()})
    mom = max(_tree_rel(torch, st_gpu.opt.mu, st_cpu.opt.mu),
              _tree_rel(torch, st_gpu.opt.nu, st_cpu.opt.nu))
    par = _tree_rel(torch, st_gpu.params, st_cpu.params)
    log(f"check-train-wide: {arch}: one AdamW step: moments {mom:.3e} "
        f"(tol {CHECK_WIDE_TOL}), params {par:.3e} (not gated: the first "
        f"update is about lr * sign(g), check-moe's note)")
    if not mom <= CHECK_WIDE_TOL:
        fail(f"check-train-wide: {arch}: the AdamW moments differ by {mom}")
    arch = "deepseek-v2-236b"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                              **WIDE_HEADS[arch])
    _wide_grads_card_vs_cpu(torch, arch, cfg, f"{WIDE_HEADS[arch]} top-"
                            f"{cfg.experts_per_token}", False)
    every = dataclasses.replace(cfg, experts_per_token=cfg.num_experts)
    _wide_grads_card_vs_cpu(torch, arch, every, f"top-{every.num_experts} "
                            f"of {every.num_experts}", True)


# ----------------------------------------------------------------------
# slice 19: the kernels' whole domain.  The general units
# (csrc/flash_attention_any.cu, csrc/flash_attention_bwd_any.cu,
# csrc/ssd_any.cu, csrc/ssd_bwd_any.cu) take every head dim, dtype and
# alignment and every SSD p and n that the earlier instantiations do not.

ANY_FLASH_CASES = [  # name, B, S, H, KH, D, Dv, causal, dtype, offset
    # pixtral-12b's training shape and deepseek-v2's MLA prefill, f32 params
    ("pixtral f32 (d 160)", 2, 1088, 32, 8, 160, 160, True, "float32", 0),
    ("mla f32 (192 over 128)", 4, 512, 128, 128, 192, 128, True, "float32",
     0),
    # the prompt encoder at dit-t2i's width: 4 heads of 1152 / 4 = 288
    ("prompt encoder (4 x 288)", 8, 77, 4, 4, 288, 288, False, "float32", 0),
    # Gemma-7B: 16 heads of 256
    ("gemma-7b d256 bf16", 2, 1024, 16, 16, 256, 256, True, "bfloat16", 0),
    ("gemma-7b d256 f32", 2, 1024, 16, 16, 256, 256, True, "float32", 0),
    # odd widths: D 200 in f32; D 136 in bf16 one element off 16 bytes
    ("odd d200 f32", 2, 300, 8, 2, 200, 200, True, "float32", 0),
    ("odd d136 bf16, offset 1", 2, 300, 8, 2, 136, 136, True, "bfloat16",
     1),
]
ANY_FWD_TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}   # one bf16 rounding
ANY_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # bf16: + one rounding
ANY_SSD_CASES = [  # name, b, s, h, p, n, bf16 xBC views, dh_final
    # zamba2-2.7b's Mamba2 layer with the published Mamba2-2.7B state
    ("zamba2 n 128 bf16 xBC views", 4, 512, 80, 64, 128, True, False),
    ("zamba2 n 128 f32", 4, 512, 80, 64, 128, False, False),
    ("ragged p 96 n 160, dh_final", 1, 500, 4, 96, 160, False, True),
]
ANY_KERNEL_TAGS = ("flash_fwd_any", "flash_bwd_dkdv_any", "flash_bwd_dq_any",
                   "ssd_cb_any", "ssd_scan_any", "ssd_bwd_scan_any",
                   "ssd_bwd_state_any", "ssd_bwd_tile_any")


def any_registers_spills():
    """{instantiation: (registers, spill store bytes, spill load bytes)}
    of every general-unit kernel, from the build log."""
    import re
    from repro_torch.kernels import _build
    out = {}
    for m in re.finditer(r"Function properties for \S*?(\d+(?:" + "|".join(
            ANY_KERNEL_TAGS) + r")\w*?)\n\s*\d+ bytes stack frame, (\d+) "
            r"bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) "
            r"registers", _build.build_log()):
        name = re.sub(r"^\d+", "", m.group(1))
        out[name[:48]] = (int(m.group(4)), int(m.group(2)), int(m.group(3)))
    return out


def phase_any_kernels(torch, F):
    """K1-K4 against their plain versions at the main paths' shapes: the
    general flash forward (serving and with the row log-sum-exp) and its
    backward against float64 autograd; the general SSD scan against the
    plain version and its backward against float64 autograd.  Times,
    bounds, plain and library times for the kernels line."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_lse_ref, attention_ref, flash_attention,
        flash_attention_backward, ops)
    from repro_torch.kernels.ssd import (ssd_bwd_ref, ssd_chunked, ssd_ref,
                                         ssd_scan, ssd_scan_backward)
    from repro_torch.kernels.ssd.ops import general
    gen = torch.Generator(device="cuda").manual_seed(19)
    fwd_rows, bwd_rows = {}, {}
    for name, B, S, H, KH, D, Dv, causal, dt, offset in ANY_FLASH_CASES:
        dtype = getattr(torch, dt)

        def randn(shape, off=0):
            flat = torch.randn((math.prod(shape) + off,), generator=gen,
                               device="cuda").to(dtype)
            return flat[off:].view(shape)

        q, k = randn((B, S, H, D), offset), randn((B, S, KH, D), offset)
        v = randn((B, S, KH, Dv), offset)
        do = randn((B, S, H, Dv))
        r = ops.route(dtype, D, Dv, ops.aligned16(D, Dv, (q, k, v)), True)
        if r != (ops.ANY_FWD, ops.ANY_BWD, False):
            fail(f"any {name}: routed to {r}, not the general units")
        scale = 1.0 / math.sqrt(D)
        out = flash_attention(q, k, v, causal=causal)
        ref = attention_ref(q, k, v, causal=causal)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        o = ops._forward(q, k, v, causal, 0, scale, lse, r.forward)
        lse_ref = attention_lse_ref(q, k, causal=causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        o_err = float((o.float() - ref.float()).abs().max())
        lse_err = float((lse - lse_ref.float()).abs().max())
        tol = ANY_FWD_TOL[dt]
        if not (err <= tol and o_err <= tol and lse_err <= LSE_TOL):
            fail(f"any {name}: the forward is off ({err}, with lse {o_err}, "
                 f"lse {lse_err})")
        del ref, lse_ref
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=causal))
        dev_ms = device_ms(torch, lambda: flash_attention(
            q, k, v, causal=causal), "flash_fwd_any")
        lse_ms = cuda_ms(torch, lambda: ops._forward(q, k, v, causal, 0,
                                                     scale, lse, r.forward))
        plain_ms = cuda_ms(torch, lambda: attention_ref(q, k, v,
                                                        causal=causal), reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril() \
            if causal else None

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=KH != H)
        lib_ms = cuda_ms(torch, sdpa)
        lib_what, lib_dev = sdpa_kernels(torch, sdpa)
        pairs = S * S if mask is None else int(mask.sum())
        el = q.element_size()
        nbytes = (B * S * H + B * S * KH) * (D + Dv) * el
        peak = PEAK_FLOPS["float32_3xtf32" if dt == "float32" else dt]
        b_ms, by = bound(nbytes, 2.0 * B * H * pairs * (D + Dv), peak)
        log(f"any {name}: flash forward B={B} S={S} H={H} KH={KH} D={D} "
            f"Dv={Dv} causal={causal} {dt}: max_abs_err={err:.3e} (tol "
            f"{tol}), with the lse {o_err:.3e}, lse {lse_err:.3e} (tol "
            f"{LSE_TOL}); ms={ms:.4f} device_ms={dev_ms} with_lse_ms="
            f"{lse_ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
            f"(device {lib_dev:.4f}; {lib_what}) bound_ms={b_ms:.4f} ({by})")
        fwd_rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": by,
                          "library_ms": lib_ms, "device_ms": dev_ms,
                          "library_device_ms": lib_dev,
                          "library_kernels": lib_what,
                          "fwd_with_lse_ms": lse_ms,
                          "lse_max_abs_err": lse_err,
                          "tolerance": f"{tol} abs"}
        # the backward: the kernel, a bitwise rerun, float64 autograd
        got = flash_attention_backward(q, k, v, o, do, lse, causal=causal)
        again = flash_attention_backward(q, k, v, o, do, lse, causal=causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"any {name}: the backward is not bitwise on a rerun")
        del again
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        ref = torch.autograd.grad(attention_ref(q64, k64, v64, causal=causal),
                                  (q64, k64, v64), do.double())
        del q64, k64, v64
        plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
        torch.cuda.synchronize()
        each_err = {g_: float((a.double() - b).abs().max())
                    for g_, a, b in zip(("dq", "dk", "dv"), got, ref)}
        plain_err = max(float((a.double() - b).abs().max())
                        for a, b in zip(plain, ref))
        abs_err = max(each_err.values())
        berr = abs_err if dt == "float32" else max(
            float(((a.double() - b).abs() - 2.0 ** -8 * b.abs()).max())
            for a, b in zip(got, ref))
        big = max(float(b.abs().max()) for b in ref)
        del got, ref, plain
        btol = ANY_BWD_TOL[dt]

        def bwd():
            return flash_attention_backward(q, k, v, o, do, lse, causal=causal)
        bms = cuda_ms(torch, bwd)
        bdev = device_ms(torch, bwd, "flash_bwd")
        bplain = cuda_ms(torch, lambda: attention_bwd_ref(
            q, k, v, o, do, lse, causal=causal), reps=3)
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot_ = do.transpose(1, 2)

        def sdpa_fwd_bwd():   # the yardstick: the port never calls it
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                 enable_gqa=KH != H)
            return torch.autograd.grad(out, (qg, kg, vg), dot_)
        blib = cuda_ms(torch, sdpa_fwd_bwd, reps=5)
        blib_what, blib_dev = sdpa_kernels(torch, sdpa_fwd_bwd)
        nbytes = (2 * B * S * H + 2 * B * S * KH) * (D + Dv) * el \
            + 4 * B * H * S
        bb_ms, bby = bound(nbytes, 2.0 * B * H * pairs * (3 * D + 2 * Dv),
                           peak)
        log(f"any {name}: flash backward vs float64 autograd max_abs_err="
            f"{abs_err:.3e} ({each_err}; the plain version from the same o "
            f"and lse {plain_err:.3e})" + ("" if dt == "float32" else
                                f", beyond one bf16 rounding {berr:.3e}")
            + f" (tol {btol}; largest |grad| {big:.3e}); bitwise on a rerun; "
            f"ms={bms:.4f} device_ms={bdev} plain_ms={bplain:.4f} "
            f"sdpa_fwd_bwd_ms={blib:.4f} (device {blib_dev:.4f}; "
            f"{blib_what}) bound_ms={bb_ms:.4f} ({bby})")
        if not berr <= btol:
            fail(f"any {name}: the backward is off float64 by {berr} > {btol}")
        bwd_rows[name] = {"max_abs_err": berr, "abs_err": abs_err, "ms": bms,
                          "plain_ms": bplain, "bound_ms": bb_ms,
                          "bound_by": bby, "library_ms": blib,
                          "library_device_ms": blib_dev,
                          "library_kernels": blib_what, "device_ms": bdev,
                          "tolerance": f"{btol} abs" + (
                              "" if dt == "float32" else
                              " + 2^-8 |ref| (max_abs_err: the excess)")}
        del q, k, v, o, do, lse, qg, kg, vg, dot_, mask, out
        torch.cuda.empty_cache()

    ssd_rows, ssd_bwd_rows = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(29)
    for name, b, s, h, p, n, xbc, dh in ANY_SSD_CASES:
        if not general(p, n):
            fail(f"any {name}: (p {p}, n {n}) is not the general unit's")
        args = ssd_inputs(torch, gen, b, s, h, p, n, xbc)
        y, hf = ssd_scan(*args)
        chunk = max(c for c in range(1, 65) if s % c == 0)
        # the plain version in float64, and in f32 for the record
        yr, hr = ssd_chunked(*(a.double() for a in args), chunk)
        y32, h32 = ssd_chunked(*args, chunk)
        torch.cuda.synchronize()

        def excess(pairs):
            return max(float(((out.double() - r).abs()
                              - SSD_TOL["rtol"] * r.abs()).max())
                       for out, r in pairs)
        worst = excess(((y, yr), (hf, hr)))
        plain_worst = excess(((y32, yr), (h32, hr)))
        err = max(float((y.double() - yr).abs().max()),
                  float((hf.double() - hr).abs().max()))
        del y, hf, yr, hr, y32, h32
        ms = cuda_ms(torch, lambda: ssd_scan(*args))
        dev_ms = device_ms(torch, lambda: ssd_scan(*args),
                           ("ssd_cb_any", "ssd_scan_any"))
        plain_ms = cuda_ms(torch, lambda: ssd_ref(*args), reps=3)
        el = args[0].element_size()
        nbytes, flops, t_ops = ssd_fwd_work(b, s, h, p, n, el, xbc)
        b_ms, by = bound(nbytes, flops, flops / t_ops)
        log(f"any ssd {name}: b={b} s={s} h={h} p={p} n={n} "
            f"{str(args[0].dtype)[6:]}: max_abs_err={err:.3e} vs the plain "
            f"version in float64 at chunk {chunk} (worst excess over "
            f"{SSD_TOL['rtol']} rel {worst:.3e}, tol {SSD_TOL['atol']}; the "
            f"plain version in f32 {plain_worst:.3e}) ms={ms:.4f} device_ms="
            f"{dev_ms} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({by}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); no single "
            f"PyTorch call computes it (library_ms null)")
        if not worst <= SSD_TOL["atol"]:
            fail(f"any ssd {name}: off by {worst} beyond {SSD_TOL}")
        ssd_rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": by,
                          "library_ms": None, "device_ms": dev_ms,
                          "tolerance": f"{SSD_TOL['atol']} abs + "
                                       f"{SSD_TOL['rtol']} rel"}
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dhf = torch.randn((b, h, p, n), generator=gen, device="cuda") \
            if dh else None
        got = ssd_scan_backward(*args, dy, dhf)
        again = ssd_scan_backward(*args, dy, dhf)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"any ssd {name}: the backward is not bitwise on a rerun")
        ins = [a.detach().double().requires_grad_() for a in args]
        y64, h64 = ssd_ref(*ins)
        loss = (y64 * dy.double()).sum()
        if dh:
            loss = loss + (h64 * dhf.double()).sum()
        ref = torch.autograd.grad(loss, ins)
        del ins, y64, h64, loss
        errs, abs_errs = {}, {}
        for g_, a, r in zip(SSD_GRADS, got, ref):
            big = max(float(r.abs().max()), 1e-30)
            e = (a.double() - r).abs()
            allowed = SSD_BWD_TOL * big + (2.0 ** -8 * r.abs()
                                           if a.dtype == torch.bfloat16
                                           else 0.0)
            abs_errs[g_] = float(e.max())
            errs[g_] = abs_errs[g_] / big
            if float((e - allowed).max()) > 0:
                fail(f"any ssd {name}: {g_} off float64 autograd by "
                     f"{float(e.max())} (largest {big})")
        del got, again, ref

        def call():
            return ssd_scan_backward(*args, dy, dhf)
        bms = cuda_ms(torch, call)
        bdev = device_ms(torch, call, "ssd_bwd")
        bplain = cuda_ms(torch, lambda: ssd_bwd_ref(*args, dy, dhf), reps=3)
        nbytes, flops, t_ops = ssd_bwd_work(b, s, h, p, n, el, dh, xbc)
        bb_ms, bby = bound(nbytes, flops, flops / t_ops)
        log(f"any ssd {name}: backward vs float64 autograd, each gradient's "
            f"largest error over its largest value {errs} (tol "
            f"{SSD_BWD_TOL}, bf16 outputs one rounding more); bitwise on a "
            f"rerun; ms={bms:.4f} device_ms={bdev} plain_ms={bplain:.4f} "
            f"bound_ms={bb_ms:.4f} ({bby}, {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB); library_ms null")
        ssd_bwd_rows[name] = {"max_abs_err": max(abs_errs.values()),
                              "max_rel_err": max(errs.values()),
                              "errors": errs, "ms": bms, "plain_ms": bplain,
                              "bound_ms": bb_ms, "bound_by": bby,
                              "library_ms": None, "device_ms": bdev,
                              "tolerance": f"{SSD_BWD_TOL} of the largest "
                              f"float64 gradient (+ 2^-8 |ref| for bf16)"}
        del args, dy, dhf
        torch.cuda.empty_cache()
    usage = any_registers_spills()
    log(f"any: registers, spill store and load bytes of the general units' "
        f"instantiations {usage}")
    if len(usage) < 12:
        fail(f"any: ptxas reported {len(usage)} general-unit instantiations")
    spilled = [k for k, u in usage.items() if u[1] or u[2]]
    if spilled:
        fail(f"any: a general unit (flash or SSD, forward or backward) "
             f"spills in {spilled}")

    def row(rows, main):
        out = dict(rows[main])
        out.update({k: v for k, v in rows.items() if k != main})
        out["registers_spills"] = usage
        return out
    return {"flash_attention_any": row(fwd_rows, "pixtral f32 (d 160)"),
            "flash_attention_backward_any": row(bwd_rows,
                                                "pixtral f32 (d 160)"),
            "ssd_any": row(ssd_rows, "zamba2 n 128 bf16 xBC views"),
            "ssd_backward_any": row(ssd_bwd_rows,
                                    "zamba2 n 128 bf16 xBC views")}


# zamba2 at 6: one hybrid group (6 Mamba2 layers, then the shared block);
# num_layers // hybrid_attn_every groups run, so fewer layers run none
ANY_DEPTH = {"pixtral-12b serve": 4, "pixtral-12b train": 4,
             "deepseek-v2-236b": 1, "zamba2-2.7b": 6}
#: the general units' C entry points
ANY_ENTRIES = ("flash_attention_fwd_any", "flash_attention_bwd_any",
               "ssd_fwd_any", "ssd_bwd_any")
ANY_TRAIN_STEPS = 3          # step 1 eager, step 2 the capture, step 3 replay
ANY_MLA_TOKENS = (2, 512)
ANY_ZAMBA2_TOKENS = (4, 512)


def _any_counted(torch, kernels, phase, want, run):
    """run() with every count at 0; fail unless each general unit in
    `want` launched exactly its count there.  Returns (run's result,
    {kernel: launches})."""
    out, launches = _count_launches(kernels, (), phase, run)
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{phase}: {name} launched {launches[name]} times, want {n} "
                 f"({launches})")
    return out, launches


def _any_pixtral(torch, kernels):
    """pixtral-12b with f32 params at full width: a served prefill with
    vision embeds and decode steps (ANY_DEPTH serve layers), then train
    steps through train_loop(jit=True) (ANY_DEPTH train layers)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, patch_embeddings
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.train.loop import train_loop
    from repro_torch.train.steps import init_train_state, make_lm_train_step
    full = get_config("pixtral-12b")
    depth = ANY_DEPTH["pixtral-12b serve"]
    cfg = dataclasses.replace(full, num_layers=depth, dtype="float32")
    B, nv = 2, cfg.num_vision_tokens
    S = nv + VLM_TEXT
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, VLM_TEXT))).cuda()
    ve = torch.from_numpy(patch_embeddings(0, B, nv, cfg.vision_dim)).cuda()

    def serve():
        with torch.no_grad():
            logits, cache = prefill(params, toks, cfg, S + 8,
                                    vision_embeds=ve)
            finite = [logits.isfinite().all()]
            tok, pos = logits[:, -1].argmax(-1), torch.full((B,), S,
                                                            device="cuda")
            for _ in range(8):
                logits, cache = decode_step(params, tok, pos, cache, cfg)
                finite.append(logits.isfinite().all())
                tok, pos = logits.argmax(-1), pos + 1
        return bool(torch.stack(finite).all())

    serve()                                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    finite, launches = _any_counted(torch, kernels, "any-paths pixtral serve",
                                    {"flash_attention_fwd_any": depth}, serve)
    _, ms = _sync_ms(torch, serve)
    log(f"any-paths: pixtral-12b f32, {depth} of {full.num_layers} layers "
        f"(depth cut: f32 params), d_model {cfg.d_model}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}: prefill of {B} x "
        f"({nv} patches + {VLM_TEXT} tokens) and 8 decode steps {ms:.1f} ms "
        f"(host clock, synchronized); logits finite {finite}; peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; launches {launches}")
    if not finite:
        fail("any-paths: pixtral-12b f32 served non-finite logits")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    depth = ANY_DEPTH["pixtral-12b train"]
    cfg = dataclasses.replace(full, num_layers=depth, dtype="float32")
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    it = lm_batches(0, B, VLM_TEXT, cfg.vocab_size)
    made = []
    for i in range(ANY_TRAIN_STEPS):
        t, y = next(it)
        made.append({"tokens": torch.from_numpy(t).cuda(),
                     "targets": torch.from_numpy(y).cuda(),
                     "vision_embeds": torch.from_numpy(patch_embeddings(
                         i, B, nv, cfg.vision_dim)).cuda()})
    step = make_lm_train_step(cfg, peak_lr=3e-4, warmup=0,
                              total_steps=ANY_TRAIN_STEPS + 1)
    torch.cuda.reset_peak_memory_stats()
    steps = ANY_TRAIN_STEPS
    t0 = time.perf_counter()
    (state, hist), train = _any_counted(
        torch, kernels, "any-paths pixtral train",
        {"flash_attention_fwd_any": depth * steps,
         "flash_attention_bwd_any": depth * steps},
        lambda: train_loop(step, state, iter(made), steps, log_every=1,
                           log_fn=lambda m: None, jit=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    log(f"any-paths: pixtral-12b f32 train, {depth} of {full.num_layers} "
        f"layers (depth cut: f32 params, gradients and AdamW moments, about "
        f"4.6 GB a layer): {steps} steps through "
        f"train_loop(jit=True) in {wall:.2f} s, losses {losses}; peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; launches {train}")
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"any-paths: pixtral-12b f32 train losses {losses}")
    del state, made
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + train[k] for k in launches}


def _any_mla(torch, kernels):
    """deepseek-v2-236b with f32 params at full width, ANY_DEPTH layers: a
    prefill, then lm_loss and its gradients at ANY_MLA_TOKENS."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import init_params, prefill
    from repro_torch.train.steps import _value_and_grad, lm_loss
    from repro_torch.tree import tree_leaves
    full = get_config("deepseek-v2-236b")
    depth = ANY_DEPTH["deepseek-v2-236b"]
    cfg = dataclasses.replace(full, num_layers=depth, dtype="float32")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    B, S = ANY_MLA_TOKENS
    t, y = (torch.from_numpy(a).cuda()
            for a in next(lm_batches(0, B, S, cfg.vocab_size)))

    def serve():
        with torch.no_grad():
            logits, _ = prefill(params, t, cfg, S)
            return bool(logits.isfinite().all())

    torch.cuda.reset_peak_memory_stats()
    finite, pre = _any_counted(torch, kernels, "any-paths mla prefill",
                               {"flash_attention_fwd_any": depth}, serve)
    _, pre_ms = _sync_ms(torch, serve)

    def run():
        return _value_and_grad(lambda p, _: lm_loss(p, t, y, cfg), params,
                               None)
    (grads, m), train = _any_counted(
        torch, kernels, "any-paths mla train",
        {"flash_attention_fwd_any": depth, "flash_attention_bwd_any": depth},
        run)
    ok = finite and all(bool(torch.isfinite(g).all())
                        for g in tree_leaves(grads))
    del grads
    _, ms = _sync_ms(torch, run)
    log(f"any-paths: deepseek-v2-236b f32, {depth} of {full.num_layers} "
        f"layers (depth cut: f32 params and gradients), MLA {cfg.num_heads} "
        f"heads of q/k {cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim} over v "
        f"{cfg.v_head_dim}: prefill {B} x {S} {pre_ms:.1f} ms, lm_loss "
        f"{float(m['loss']):.5f} and its gradients {ms:.1f} ms (host clock, "
        f"synchronized); finite {ok}; peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; launches {pre} and "
        f"{train}")
    if not ok:
        fail("any-paths: deepseek-v2 f32 gave non-finite logits or grads")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: pre[k] + train[k] for k in pre}


def _any_zamba2(torch, kernels):
    """zamba2-2.7b at full width with ssm_state 128 (the published
    Mamba2-2.7B's state; p 64, 80 heads), ANY_DEPTH layers (one hybrid
    group): a prefill at ANY_ZAMBA2_TOKENS, then lm_loss and its
    gradients."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import init_params, prefill
    from repro_torch.train.steps import _value_and_grad, lm_loss
    from repro_torch.tree import tree_leaves
    full = get_config("zamba2-2.7b")
    depth = ANY_DEPTH["zamba2-2.7b"]
    cfg = dataclasses.replace(full, num_layers=depth, ssm_state=128)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    B, S = ANY_ZAMBA2_TOKENS
    t, y = (torch.from_numpy(a).cuda()
            for a in next(lm_batches(0, B, S, cfg.vocab_size)))

    def serve():
        with torch.no_grad():
            logits, _ = prefill(params, t, cfg, S)
            return bool(logits.isfinite().all())

    torch.cuda.reset_peak_memory_stats()
    finite, pre = _any_counted(torch, kernels, "any-paths zamba2 prefill",
                               {"ssd_fwd_any": depth}, serve)
    _, pre_ms = _sync_ms(torch, serve)

    def run():
        return _value_and_grad(lambda p, _: lm_loss(p, t, y, cfg), params,
                               None)
    (grads, m), train = _any_counted(
        torch, kernels, "any-paths zamba2 train",
        {"ssd_fwd_any": depth, "ssd_bwd_any": depth}, run)
    ok = finite and all(bool(torch.isfinite(g).all())
                        for g in tree_leaves(grads))
    del grads
    _, ms = _sync_ms(torch, run)
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    log(f"any-paths: zamba2-2.7b {depth} of {full.num_layers} layers at "
        f"ssm_state {cfg.ssm_state} (d_model {cfg.d_model}, {nh} heads of "
        f"{cfg.ssm_head_dim}, {cfg.dtype}): prefill "
        f"{B} x {S} {pre_ms:.1f} ms, lm_loss {float(m['loss']):.5f} and its "
        f"gradients {ms:.1f} ms (host clock, synchronized); finite {ok}; "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"launches {pre} and {train}")
    if not ok:
        fail("any-paths: zamba2 at state 128 gave non-finite values")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: pre[k] + train[k] for k in pre}


def phase_any_paths(torch, kernels):
    """The paths that need the general units, on the card at full width
    with the depth cut (ANY_DEPTH): pixtral-12b and deepseek-v2's MLA with
    f32 params, and zamba2-2.7b's Mamba2 layer at ssm_state 128.  Returns
    the launches of every wrapper in `kernels` and every C entry point."""
    total = no_launches(kernels)
    for part in (_any_pixtral, _any_mla, _any_zamba2):
        got = part(torch, kernels)
        total = {k: total[k] + got[k] for k in total}
    for entry in ANY_ENTRIES:
        if total[entry] <= 0:
            fail(f"any-paths: {entry} was not launched")
    for name, shape in (("pixtral-12b", (2, 1088, 32, 8, 160, 160)),
                        ("deepseek-v2-236b", (2, 512, 128, 128, 192, 128))):
        bwd_ms, lib_ms = bwd_vs_library(torch, *shape, torch.float32)
        log(f"any-paths: {name} f32: the general backward at the path's "
            f"attention shape {bwd_ms:.4f} ms a call against SDPA forward + "
            f"backward {lib_ms:.4f} (the yardstick)")
    usage = {k: u for k, u in any_registers_spills().items()
             if k.startswith("flash_bwd")}
    log(f"any-paths: the general backward's registers, spill store and "
        f"load bytes {usage}")
    return total


def phase_check_any(torch):
    """pixtral-12b (head dim 160), deepseek-v2's MLA (q/k 192 over v 128,
    every token routed to every expert, so no top-k choice can flip) and
    zamba2-2.7b (ssm_state 128) at SMOKE size with f32 params, on the card
    and the CPU: logits, lm_loss and every leaf's gradient within
    SLICE13_TOL relative, through the general units on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _build
    dsv = dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                              **WIDE_HEADS["deepseek-v2-236b"])
    for arch, over, want in (
            ("pixtral-12b", WIDE_HEADS["pixtral-12b"],
             ("flash_attention_fwd_any", "flash_attention_bwd_any")),
            ("deepseek-v2-236b", {**WIDE_HEADS["deepseek-v2-236b"],
                                  "experts_per_token": dsv.num_experts},
             ("flash_attention_fwd_any", "flash_attention_bwd_any")),
            ("zamba2-2.7b", {"ssm_state": 128},
             ("ssd_fwd_any", "ssd_bwd_any"))):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  **over)
        for entry in ANY_ENTRIES:
            setattr(_build.launches, entry, 0)
        cfg, cpu, ve = _lm_logits_card_vs_cpu(torch, "check-any", arch,
                                              engine=False, cfg=cfg)
        _lm_loss_card_vs_cpu(torch, "check-any", cfg, cpu, ve)
        counts = {e: getattr(_build.launches, e) for e in ANY_ENTRIES}
        log(f"check-any: {arch} SMOKE {over}: general-unit launches on the "
            f"card {counts}")
        if not all(counts[w] > 0 for w in want):
            fail(f"check-any: {arch} did not run {want} ({counts})")


VERIFY_STEPS = 16      # the verify phase's engines: max_steps, 4 slots


def _verify_engines(cfg, params):
    """The verify phase's two full-width engines' makers: TeaCache with
    FasterCacheCFG (the device plan and the uncond rows), and TaylorSeer
    (host plan; forecast kernel on its skip ticks)."""
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.serving.diffusion import DiffusionServingEngine

    def teacache():
        return DiffusionServingEngine(
            params, cfg, make_policy("teacache", delta=TEACACHE_DELTA),
            slots=4, max_steps=VERIFY_STEPS,
            cfg_policy=FasterCacheCFG(2, VERIFY_STEPS), device="cuda")

    def taylorseer():
        return DiffusionServingEngine(params, cfg, "taylorseer", slots=4,
                                      max_steps=VERIFY_STEPS, device="cuda")

    return {"teacache+fastercache_cfg": teacache, "taylorseer": taylorseer}


def _injected_syncs(torch, eng):
    """Record one tick of `eng` with a `.item()` and then a `.cpu()`
    injected after it: (issues of the first, issues of the second).  The
    tick's inputs go into the engine's static latents and states, fresh
    slots of zeros, which the plan reads."""
    import numpy as np
    from repro_torch.analysis.ir.op_checks import check_record, record_program
    from repro_torch.core import SlotBatchedPolicy
    S = eng.slots
    xs, states = eng._xs, eng._states
    xs.zero_()
    for slot in range(S):
        SlotBatchedPolicy.reset_slot(states, slot, eng._fresh)
    z = np.zeros((S,), np.float32)
    ab = np.full((S,), 0.5, np.float32)
    steps = np.zeros((S,), np.int32)
    wc, wu, _, sig = eng._plan_all(states, steps, xs, z)
    nv = torch.zeros((S, eng.cfg.d_model), device="cuda")
    nm = torch.zeros((S,), dtype=torch.bool, device="cuda")

    def tick():
        return eng._tick("full", None, states, steps, xs, z, z, ab, ab, nv,
                         nm, {}, wc, wu, sig)[0]

    _, rec_item = record_program("inject-item", lambda: tick().sum().item())
    _, rec_cpu = record_program("inject-cpu", lambda: tick().sum().cpu())
    return rec_item, rec_cpu, check_record(rec_item), check_record(rec_cpu)


def log_findings(label, findings):
    """One line per distinct (rule, source line, message), with its count."""
    from collections import Counter
    groups = Counter((f.rule, f"{f.path}:{f.line}", f.message[:160])
                     for f in findings)
    for (rule, where, msg), n in sorted(groups.items()):
        log(f"{label}: {n}x {where} [{rule}] {msg}")


def phase_verify(torch, kernels, path):
    """The analysis package on the card (see the module docstring, 43)."""
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.ir import RetraceSentinel
    from repro_torch.analysis.ir.launch_lint import lint_launches
    from repro_torch.configs import get_config
    from repro_torch.diffusion import linear_schedule
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.train.loop import train_loop
    from repro_torch.train.steps import (init_train_state,
                                         make_diffusion_train_step)
    from repro_torch.tree import tree_leaves

    # 1-2. the lint, every rule on the card, and the launch plans
    t0 = time.perf_counter()
    res = run_analysis(root=str(ROOT), device="cuda")
    lint_s = time.perf_counter() - t0
    log(f"verify: lint of src/repro_torch on the card in {lint_s:.2f}s: "
        f"{len(res.findings)} finding(s), {len(res.suppressed)} suppressed, "
        f"{res.files_scanned} files, rules {res.rules}, not run "
        f"{res.not_run}")
    if res.exit_code != 0 or res.not_run:
        log_findings("verify: lint", res.findings)
        fail("verify: the lint of src/repro_torch did not exit 0 with every "
             "rule run")
    # the launch lint again, for its plans (the lint above reports only
    # its findings)
    lint = lint_launches()
    if lint.issues or not lint.plans:
        fail(f"verify: the launch lint: {len(lint.issues)} issue(s), "
             f"{len(lint.plans)} plan(s)")
    sites = sorted({p.site for p in lint.plans})
    log(f"verify: launch lint: {lint.captures} calls, {len(lint.plans)} "
        f"plans, entries {lint.entries}, {len(sites)} sites {sites}")
    for line in lint.site_lines():
        log(f"verify: launch site {line}")

    # 3. two full-width DiT-XL engines, verified, served under the sentinel
    cfg = get_config("dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = perturb_zero_init(init_params(gen, cfg, device="cuda"), gen)
    reqs = serve_requests(cfg)
    launches, inject_eng = {}, None
    for name, make in _verify_engines(cfg, params).items():
        make().warmup()                      # the shapes' first runs
        torch.cuda.synchronize()
        plain, verified = make(), make()
        t0 = time.perf_counter()
        plain.warmup()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = verified.warmup(verify=True)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        ops = {str(k): r.ops for k, r in verified.program_records.items()}
        log(f"verify: {name}: warmup() {plain_s:.3f}s, warmup(verify=True) "
            f"{verify_s:.3f}s ({verify_s / plain_s:.2f}x), programs {runs}, "
            f"aten ops a run {ops}, findings {len(verified.ir_findings)}")
        if verified.ir_findings != []:
            log_findings(f"verify: {name}", verified.ir_findings)
            fail(f"verify: {name}: warmup(verify=True) found "
                 f"{len(verified.ir_findings)} issue(s)")
        live = RetraceSentinel().selftest()
        t0 = time.perf_counter()
        with RetraceSentinel() as sentinel:
            out, n = _count_launches(kernels, path[:1] if name.startswith(
                "teacache") else path, f"verify {name}",
                lambda: verified.serve(reqs))
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        log(f"verify: {name}: {len(out)} requests in {serve_s:.3f}s under "
            f"the sentinel: count {sentinel.count} {sentinel.compiled_names}"
            f", selftest {live}, launches {n}")
        if len(out) != len(reqs) or not all(
                math.isfinite(float(abs(r.x0).max())) for r in out):
            fail(f"verify: {name}: {len(out)} of {len(reqs)} requests, or a "
                 f"non-finite x0")
        if sentinel.count != 0 or not live:
            fail(f"verify: {name}: sentinel count {sentinel.count}, selftest "
                 f"{live}")
        inject_eng = verified
        del plain
    for k in path:
        if launches[k.__name__] <= 0:
            fail(f"verify: kernel {k.__name__} was not launched on this path")

    # 4. an injected .item() fires both sync channels; a .cpu() the copies'
    rec_item, rec_cpu, item_issues, cpu_issues = _injected_syncs(
        torch, inject_eng)
    log(f"verify: injected .item(): {len(rec_item.syncs)} operator sync(s) "
        f"{[e.op for e in rec_item.syncs]}, {len(rec_item.sync_warnings)} "
        f"sync-debug warning(s); injected .cpu(): "
        f"{[e.op for e in rec_cpu.syncs]}, {len(rec_cpu.sync_warnings)} "
        f"warning(s); {len(item_issues)} + {len(cpu_issues)} findings")
    if not (any(e.kind == "sync" for e in rec_item.syncs)
            and rec_item.sync_warnings and item_issues):
        fail("verify: the injected .item() did not fire both sync channels")
    if not (any(e.kind == "dtoh" for e in rec_cpu.syncs)
            and rec_cpu.sync_warnings):
        fail("verify: the injected .cpu() did not fire the copy channel")
    del inject_eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the full-width train step updates every leaf in place
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    step_fn = make_diffusion_train_step(cfg, linear_schedule(1000),
                                        total_steps=10)
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = ({"latents": torch.randn((TRAIN_BATCH, cfg.dit_tokens,
                                        cfg.dit_in_dim), generator=g,
                                       device="cuda"),
                "labels": torch.randint(0, cfg.dit_num_classes,
                                        (TRAIN_BATCH,), generator=g,
                                        device="cuda"),
                "generator": g} for _ in range(2))
    leaves = len(tree_leaves(state))
    t0 = time.perf_counter()
    state, hist = train_loop(step_fn, state, batches, 2, log_every=1,
                             log_fn=lambda m: None, verify_donation=True)
    torch.cuda.synchronize()
    log(f"verify: train_loop(verify_donation=True): 2 steps of dit-xl at "
        f"batch {TRAIN_BATCH} in {time.perf_counter() - t0:.3f}s, all "
        f"{leaves} leaves updated in place; losses "
        f"{[round(h['loss'], 5) for h in hist]}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail("verify: a train loss is not finite")
    del state
    return launches


DIST_TOL = 1e-4          # dist: sharded against unsharded forward, relative
EP_TOL = 1e-5            # dist-moe: moe_forward_ep against moe_forward
DIST_TOKENS = (4, 512)   # qwen2-7b prefill
DIST_DIT_BATCH = 8
EP_DEPTH = 2             # deepseek-v2-236b layers in dist-moe (serve-moe: 8)
EP_TOKENS = (2, 64)      # the MoE layer's input in dist-moe
DRYRUN_TIMEOUT = 900
PERF_DIT_ROUNDS = 4      # perf-dit: timing rounds, in turns


def nccl_world(torch):
    """A world-size-1 NCCL process group on the card (a free localhost
    port); fails rather than fall back to another backend."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    except Exception as e:         # the phase fails; no gloo on the card
        fail(f"dist: NCCL process group: {type(e).__name__}: {e}")
    if dist.get_backend() != "nccl":
        fail(f"dist: backend {dist.get_backend()}, not nccl")
    return dist


def logical_mesh_1(torch):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1, 1), ("data", "attn", "ffn"))
    if mesh.device_type != "cuda":
        fail(f"dist: the mesh is on {mesh.device_type}, not cuda")
    return mesh


def _comm_counts(comm):
    return {str(k).split(".")[-1]: v
            for k, v in comm.get_comm_counts().items()}


def phase_dist(torch, kernels, path):
    """Sharded forwards on the card at world size 1 (module docstring,
    44).  Returns (launches, the qwen2-7b prefill's peak GB)."""
    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import dit, init_params, transformer
    host = make_host_mesh()
    mesh = logical_mesh_1(torch)
    log(f"dist: NCCL world 1; host mesh {host.mesh_dim_names} "
        f"{tuple(host.shape)} on {host.device_type}, logical mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}")
    total = no_launches(kernels)

    # qwen2-7b prefill (the prefill case's forward: logits and the K/V)
    cfg = get_config("qwen2-7b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, DIST_TOKENS)).cuda()
    with torch.no_grad():
        ref, ref_kv = transformer.forward(params, toks, cfg, collect_kv=True)
        dp = shd.distribute(params, shd.params_sharding(params, mesh), mesh)
        dt = shd.distribute({"t": toks}, shd.inputs_sharding({"t": toks},
                                                             mesh), mesh)["t"]
        args_gb = (_tree_bytes(params) + toks.numel() * 8) / 1e9
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def run():
            with CommDebugMode() as comm, implicit_replication():
                out = transformer.forward(dp, dt, cfg, collect_kv=True)
            return out, comm

        (out, comm), launches = _count_launches(kernels, path, "dist", run)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        logits, kv = out
        err = _rel(logits.full_tensor(), ref)
        kv_err = max(_rel(a.full_tensor(), b) for pair_a, pair_b in
                     zip(kv, ref_kv) for a, b in zip(pair_a, pair_b))
    counts = _comm_counts(comm)
    act_gb = peak_gb - base / 1e9
    log(f"dist: qwen2-7b prefill {DIST_TOKENS[0]}x{DIST_TOKENS[1]} on DTensor "
        f"params (logits {tuple(logits.placements)}): logits {err:.3e} "
        f"relative, K/V {kv_err:.3e} (tol {DIST_TOL}); collectives {counts} "
        f"({cfg.num_layers} layers: 2 a layer + the embedding's 1); flash "
        f"{launches['flash_attention']}; card peak {peak_gb:.2f} GB, "
        f"{act_gb:.2f} GB of it above the {base / 1e9:.2f} GB resident (the "
        f"DTensor params and tokens, {args_gb:.2f} GB, and the reference's "
        f"logits and K/V)")
    if not (err <= DIST_TOL and kv_err <= DIST_TOL):
        fail(f"dist: qwen2-7b sharded forward differs ({err}, {kv_err})")
    if counts.get("all_reduce") != 2 * cfg.num_layers + 1 or \
            set(counts) - {"all_reduce"}:
        fail(f"dist: qwen2-7b collectives {counts}")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"dist: flash launched {launches['flash_attention']} times")
    total = {k: total[k] + v for k, v in launches.items()}
    del dp, dt, ref, ref_kv, out, logits, kv
    gc.collect()
    torch.cuda.empty_cache()

    # DiT-XL: one denoiser step
    cfg, params = full_dit(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    B = DIST_DIT_BATCH
    lat = torch.randn((B, cfg.dit_patch_tokens, cfg.dit_in_dim),
                      generator=g, device="cuda").to(torch.bfloat16)
    t = torch.rand((B,), generator=g, device="cuda") * 999
    y = torch.randint(0, cfg.dit_num_classes, (B,), generator=g,
                      device="cuda")
    batch = {"latents": lat, "t": t, "labels": y}
    with torch.no_grad():
        ref = dit.forward(params, lat, t, y, cfg)
        dp = shd.distribute(params, shd.params_sharding(params, mesh), mesh)
        db = shd.distribute(batch, shd.inputs_sharding(batch, mesh), mesh)

        def run_dit():
            with CommDebugMode() as comm, implicit_replication():
                out = dit.forward(dp, db["latents"], db["t"], db["labels"],
                                  cfg)
            return out, comm

        (eps, comm), launches = _count_launches(kernels, path, "dist",
                                                run_dit)
        err = _rel(eps.full_tensor(), ref)
    log(f"dist: DiT-XL denoiser step at batch {B} on DTensor params: eps "
        f"{err:.3e} relative (tol {DIST_TOL}); collectives "
        f"{_comm_counts(comm)}; flash {launches['flash_attention']}")
    if not err <= DIST_TOL:
        fail(f"dist: DiT-XL sharded forward differs ({err})")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"dist: DiT flash launched {launches['flash_attention']} times")
    total = {k: total[k] + v for k, v in launches.items()}
    del params, dp, db, eps, ref
    return total, (args_gb, act_gb)


def _top_k_margin(torch, logits, k):
    """Least relative gap of every token's k-th and (k+1)-th probability."""
    top = torch.softmax(logits.float(), -1).sort(-1, descending=True).values
    return float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min())


def phase_dist_moe(torch, kernels, path):
    """Expert parallelism on the card at world size 1 (module docstring,
    45)."""
    import dataclasses
    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.core.engine import layer_list
    from repro_torch.launch.specs import _ep_kwargs
    from repro_torch.models import init_params, moe, transformer
    mesh = logical_mesh_1(torch)
    ep = _ep_kwargs(mesh)
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=EP_DEPTH)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    dp = shd.distribute(params, shd.params_sharding(params, mesh), mesh)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (*EP_TOKENS, cfg.d_model)).astype(np.float32)).cuda().to(
            torch.bfloat16)
    p0 = layer_list(params["blocks"])[0]["moe"]
    d0 = layer_list(dp["blocks"])[0]["moe"]
    with torch.no_grad():
        margin = _top_k_margin(torch, x.reshape(-1, cfg.d_model).float()
                               @ p0["router"], cfg.experts_per_token)
        if margin < MOE_MARGIN:
            fail(f"dist-moe: a token's top-{cfg.experts_per_token} margin "
                 f"{margin:.2e} < {MOE_MARGIN}")
        y, aux = moe.moe_forward(p0, x, cfg)
        dx = shd.distribute({"x": x}, shd.inputs_sharding({"x": x}, mesh),
                            mesh)["x"]
        with CommDebugMode() as comm, implicit_replication():
            ye, auxe = moe.moe_forward(d0, dx, cfg, ep=ep)
        errs = {"y": _rel(ye.full_tensor(), y)}
        errs.update({k: _rel(auxe[k].full_tensor(), aux[k])
                     for k in ("load_balance_loss", "router_z_loss")})
        drops = (int(auxe["dropped"].full_tensor()), int(aux["dropped"]))
    log(f"dist-moe: deepseek-v2-236b MoE layer (full width: "
        f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}) on "
        f"{EP_TOKENS[0]}x{EP_TOKENS[1]} tokens: least top-k margin "
        f"{margin:.2e} >= {MOE_MARGIN}; moe_forward_ep against moe_forward "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol {EP_TOL}), drops "
        f"{drops}; collectives {_comm_counts(comm)}")
    if max(errs.values()) > EP_TOL or drops[0] != drops[1]:
        fail(f"dist-moe: moe_forward_ep differs from moe_forward ({errs}, "
             f"drops {drops})")
    if _comm_counts(comm).get("all_to_all_single") != 2:
        fail(f"dist-moe: collectives {_comm_counts(comm)}, want 2 "
             f"all_to_all_single")

    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         EP_TOKENS)).cuda()
    with torch.no_grad():
        ref, ref_aux = transformer.forward(params, toks, cfg, with_aux=True)
        dt = shd.distribute({"t": toks}, shd.inputs_sharding({"t": toks},
                                                             mesh), mesh)["t"]

        def run():
            with implicit_replication():
                return transformer.forward(dp, dt, cfg, with_aux=True, ep=ep)

        (logits, aux_e), launches = _count_launches(kernels, path,
                                                    "dist-moe", run)
        err = _rel(logits.full_tensor(), ref)
        aux_err = max(_rel(aux_e[k].full_tensor(), ref_aux[k])
                      for k in ("load_balance_loss", "router_z_loss"))
    log(f"dist-moe: deepseek-v2-236b {EP_DEPTH} layers forward with ep= on "
        f"DTensors against the unsharded forward: logits {err:.3e}, aux "
        f"{aux_err:.3e} relative (tol {EP_TOL}); flash (MLA split) "
        f"{launches['flash_attention']}")
    if not (err <= EP_TOL and aux_err <= EP_TOL):
        fail(f"dist-moe: the ep forward differs ({err}, {aux_err})")
    del params, dp
    return launches


def start_dryruns(out: Path):
    """The dryrun and perf-dit phases' CPU subprocesses, started before the
    build so that they run beside it and the card's phases: the dry-run
    CLI, qwen2-7b's prefill traced on a (1, 1, 1) fake world, and
    perf_dit's traces.  Each writes its output to `out/<name>.out` and
    `.err` (a pipe nobody reads for minutes could fill and stall it)."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    qwen = textwrap.dedent(f"""
        import json, torch
        from repro_torch import sharding as shd
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import init_fake_world, trace
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.specs import _params_specs, _sds
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.models import transformer
        cfg = get_config("qwen2-7b")
        init_fake_world(1)
        mesh = make_mesh((1, 1, 1), ("data", "attn", "ffn"), device="cpu")
        pspec = _params_specs(cfg)
        toks = _sds({DIST_TOKENS}, torch.long)
        def fn(p, t):
            with implicit_replication():
                return transformer.forward(p, t, cfg, collect_kv=True)
        counter, arg, outb, s = trace(fn, (pspec, toks),
            (shd.params_sharding(pspec, mesh), shd.inputs_sharding(toks,
             mesh)), mesh)
        print(json.dumps({{"bytes_per_device": arg + counter.peak,
                          "argument_bytes": arg, "peak": counter.peak,
                          "trace_s": s}}))
    """)
    cmds = {"tinyllama": [sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "tinyllama-1.1b", "--shape", "train_4k",
                          "--out", str(out)],
            "qwen": [sys.executable, "-c", qwen],
            "perf_dit": [sys.executable, "-m", "repro_torch.launch.perf_dit",
                         "--out", str(out)]}
    procs = {}
    for name, cmd in cmds.items():
        with open(out / f"{name}.out", "w") as so, \
                open(out / f"{name}.err", "w") as se:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=so,
                                           stderr=se, text=True)
    return procs


def stop_dryruns(procs) -> None:
    """Kill what is left of start_dryruns' subprocesses."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collect(procs, out: Path, name):
    """Wait for one of start_dryruns' subprocesses (killed at the
    timeout); its stdout, or fail."""
    p = procs[name]
    try:
        p.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        fail(f"dryrun: {name} did not end in {DRYRUN_TIMEOUT}s")
    if p.returncode != 0:
        se = (out / f"{name}.err").read_text()
        fail(f"dryrun: {name} exited {p.returncode}: {se[-3000:]}")
    return (out / f"{name}.out").read_text()


def phase_perf_dit(torch, kernels, path, out: Path):
    """perf_dit's three variants on the card (module docstring, 46)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import perf_dit
    cfg, params = full_dit(torch)
    B = perf_dit.per_rank_batch(cfg)
    pol = perf_dit.policy()
    state, batch = perf_dit.variant_inputs(cfg, B, pol,
                                           device=torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"latents": torch.randn(batch["latents"].shape, generator=g,
                                    device="cuda").to(torch.bfloat16),
             "t": torch.rand((B,), generator=g, device="cuda") * 999,
             "labels": torch.randint(0, cfg.dit_num_classes, (B,),
                                     generator=g, device="cuda")}
    fns = {k: perf_dit.variant_fn(k, cfg, pol) for k in perf_dit.VARIANTS}
    with torch.no_grad():
        _, warm = fns["refresh"](params, state, batch)   # n_valid 1: skips
        args = {"uncached": state, "refresh": state, "skip": warm}

        def run():
            return {k: fn(params, args[k], batch) for k, fn in fns.items()}

        outs, launches = _count_launches(kernels, path, "perf-dit", run)
        # host-paced at batch 4: 4 rounds in turns (forward order, then
        # reversed), the median of each variant's rounds
        rounds = {k: [] for k in fns}
        for r in range(PERF_DIT_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                rounds[k].append(cuda_ms(
                    torch, lambda k=k: fns[k](params, args[k], batch),
                    reps=10))
        ms = {k: statistics.median(v) for k, v in rounds.items()}
    log(f"perf-dit: CUDA-event ms a call, {PERF_DIT_ROUNDS} rounds of 10 in "
        f"turns: { {k: [round(t, 4) for t in v] for k, v in rounds.items()} }")
    for k, (y, _) in outs.items():
        if not bool(torch.isfinite(y.float()).all()):
            fail(f"perf-dit: {k}: eps not finite")
    if launches["forecast"] != 1:
        fail(f"perf-dit: forecast launched {launches['forecast']} times "
             f"(the skip variant: 1)")
    rec = json.load(open(out / "perf_dit_decode.json"))
    amort = (ms["refresh"] + 3 * ms["skip"]) / 4
    for row in rec["variants"]:
        k = row["kind"]
        log(f"perf-dit: {k}: {ms[k]:.4f} ms on the card (B {B}, world 1, "
            f"all {cfg.num_heads} heads) beside the dry run's terms per rank "
            f"of {rec['mesh']} (B {rec['per_rank_batch']}, tp 8): compute "
            f"{row['compute_s'] * 1e3:.4f} ms, memory "
            f"{row['memory_s'] * 1e3:.4f} ms, collective "
            f"{row['collective_s'] * 1e3:.4f} ms")
    log(f"perf-dit: amortised N=4 {amort:.4f} ms (medians) against uncached "
        f"{ms['uncached']:.4f} ms ({ms['uncached'] / amort:.2f}x); the dry "
        f"run's amortised terms {rec['amortized_N4']}, speed-up of the "
        f"terms {rec['speedup_terms']}; launches {launches}")
    del params
    return launches


def phase_dryrun(torch, procs, out: Path, dist_gb):
    """The dry run on this machine's CPU (module docstring, 47); it waits
    for the subprocesses, so that perf-dit's timings after it share the
    host with nothing of this script's."""
    collect(procs, out, "tinyllama")
    rec = json.load(open(out / "dryrun_tinyllama-1.1b_train_4k_sp.json"))
    if rec["status"] != "ok" or not rec["fits_80gb_hbm"] or \
            rec["roofline"]["dominant"] not in ("compute", "memory",
                                                "collective"):
        fail(f"dryrun: tinyllama-1.1b train_4k: {rec}")
    rl = rec["roofline"]
    log(f"dryrun: tinyllama-1.1b train_4k on {rec['mesh']} (fake process "
        f"group, torch {torch.__version__}): ok in {rec['lower_s']} s of "
        f"tracing ({rec.get('traced_microbatches', 'whole')}); per rank "
        f"{rec['bytes_per_device'] / 1e9:.2f} GB (fits 80 GB), flops "
        f"{rl['flops']:.4e}, hbm bytes {rl['hbm_bytes']:.4e}, collectives "
        f"{rl['coll_bytes']}; compute {rl['compute_s']:.4f} s, memory "
        f"{rl['memory_s']:.4f} s, collective {rl['collective_s']:.4f} s "
        f"(H100 SXM data-sheet peaks): {rl['dominant']}")
    q = json.loads(collect(procs, out, "qwen").strip().splitlines()[-1])
    collect(procs, out, "perf_dit")
    log(f"dryrun: qwen2-7b prefill {DIST_TOKENS[0]}x{DIST_TOKENS[1]} on a "
        f"(1, 1, 1) fake world: {q['bytes_per_device'] / 1e9:.2f} GB per "
        f"device ({q['argument_bytes'] / 1e9:.2f} GB of arguments, "
        f"{q['peak'] / 1e9:.2f} GB of activation peak, the plain "
        f"attention's score chunks included) beside the dist phase on the "
        f"card: {dist_gb[0]:.2f} GB of arguments, {dist_gb[1]:.2f} GB of "
        f"peak above the resident")

GRAPH_TOL = 1e-5          # graphs: x0 of a warmed engine vs an unwarmed one
GRAPH_LLM = (("zamba2-2.7b", ("flash_attention", "ssd_scan")),
             ("tinyllama-1.1b", ("flash_attention",)))
GRAPH_DECODE_STEPS = 8    # graphs: decode steps timed per engine (4 profiled)


#: the trace categories of work on the device's timeline (ranges, user
#: annotations and synchronizations lie there too, and are not work)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _idle_share(torch, fn):
    """(device busy ms, profiled wall ms, idle share) of fn().  Busy is the
    union of the intervals of the kernels, copies and fills in the
    exported trace of the device's activity (streams that overlap count
    once); it fails when the profile holds no device work or more than
    the wall."""
    import tempfile
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") in DEVICE_WORK)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy /= 1e3
    if not spans or busy > wall:
        fail(f"idle share: {len(spans)} device work events, busy "
             f"{busy:.3f} ms in a profiled wall of {wall:.3f} ms")
    return busy, wall, 1 - busy / wall


def _graph_serve_pair(torch, kernels, path, label, make, reqs):
    """The same traffic through an unwarmed engine (every program eager)
    and a warmed one (every program a CUDA graph): x0 bitwise or within
    GRAPH_TOL relative, computed steps and rows, tick kinds and plan
    decisions identical, launch counts equal, no build, capture or cold
    program under a RetraceSentinel around the warmed engine's ticks; tick
    ms and idle share both ways, capture seconds, graphs and pool bytes.
    Returns the warmed run's launch counts.  The idle share comes from a
    profile of the first four requests (profiling the whole traffic would
    take most of the phase); the plan's one copy a tick on warmed engines
    is held by serve-adaptive, check-cfg and serve-video."""
    from repro_torch.analysis.ir.retrace import RetraceSentinel
    runs, short, t_pair = {}, reqs[:4], time.perf_counter()
    for mode in ("eager", "graphs"):
        eng = make()
        warm_s = None
        if mode == "graphs":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        with RetraceSentinel() as sen:
            (res, trace), launches = _count_launches(
                kernels, path, f"{label} {mode}",
                lambda: drive(eng, reqs, record=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        ticks = eng.telemetry.summary()["ticks"]
        tick_ms = (time.perf_counter() - t0) * 1e3 / ticks
        idle = _idle_share(torch, lambda: eng.serve(short))[2]
        stats = eng.graph_stats()
        runs[mode] = dict(res=res, trace=trace, launches=launches,
                          sentinel=sen.count, names=sen.compiled_names,
                          tick_ms=tick_ms, idle=idle, stats=stats,
                          warm_s=warm_s, ticks=ticks)
        prof = eng.program_profile
        if mode == "graphs":
            if stats["graphs"] != stats["programs"] or not stats["graphs"]:
                fail(f"{label}: {stats['graphs']} CUDA graphs of "
                     f"{stats['programs']} programs")
            caps = stats["capture_seconds"]
            log(f"{label} graphs: warmup {warm_s:.2f}s, {stats['graphs']} "
                f"graphs over keys {sorted(map(str, prof))}, pool_bytes="
                f"{stats['pool_bytes']}, capture seconds per key (first "
                f"graph) " + ", ".join(f"{k!r} {p.compile_seconds:.4f}"
                                       for k, p in prof.items())
                + f"; all graphs {sum(caps.values()):.3f}s (max "
                f"{max(caps.values()):.4f}s)")
        del eng
    e, g = runs["eager"], runs["graphs"]
    worst, bitwise = 0.0, True
    for a, b in zip(g["res"], e["res"]):
        bitwise &= bool((a.x0 == b.x0).all())
        worst = max(worst, float(abs(a.x0 - b.x0).max())
                    / max(float(abs(b.x0).max()), 1e-30))
        if (a.record.computed_steps, a.record.uncond_computed_steps) != (
                b.record.computed_steps, b.record.uncond_computed_steps):
            fail(f"{label}: request {a.request_id} computed "
                 f"{a.record.computed_steps}/{a.record.uncond_computed_steps}"
                 f" steps on graphs, {b.record.computed_steps}/"
                 f"{b.record.uncond_computed_steps} eagerly")
    if worst > GRAPH_TOL:
        fail(f"{label}: x0 differs by {worst:.3e} relative (> {GRAPH_TOL})")
    for k in ("kinds", "rows", "urows"):
        if g["trace"][k] != e["trace"][k]:
            fail(f"{label}: {k} differ between graphs and eager")
    plans = [[(list(p.want_cond), list(p.want_uncond))
              for _, p in r["trace"]["plans"]] for r in (g, e)]
    if plans[0] != plans[1]:
        fail(f"{label}: the device plans decided differently")
    if g["launches"] != e["launches"]:
        fail(f"{label}: launches {g['launches']} on graphs, "
             f"{e['launches']} eagerly")
    if g["sentinel"] != 0:
        fail(f"{label}: {g['sentinel']} builds, captures or cold programs "
             f"while serving on graphs: {g['names'][:5]}")
    log(f"{label}: x0 bitwise equal {bitwise} (largest relative "
        f"difference {worst:.3e}), computed steps, rows, tick kinds and "
        f"{len(g['trace']['plans'])} device plans identical, launches "
        f"equal {g['launches']}; sentinel around the served ticks: graphs "
        f"{g['sentinel']}, eager {e['sentinel']} (cold programs); tick_ms "
        f"graphs {g['tick_ms']:.3f} eager {e['tick_ms']:.3f} over "
        f"{g['ticks']} ticks; idle share graphs {g['idle']:.3f} eager "
        f"{e['idle']:.3f} (profiled: the first 4 requests); "
        f"{time.perf_counter() - t_pair:.1f}s for the pair")
    return g["launches"]


def _graph_llm(torch, kernels, arch, path):
    """`arch` at full width: a plain prefill / decode_step loop run
    eagerly, then ServingEngine, whose first generate captures prefill and
    decode: greedy tokens equal, launches equal, no capture in a second
    generate; decode ms a step, device kernel ms, idle share and peak
    memory both ways, capture seconds and pool bytes of both graphs."""
    import numpy as np
    from repro_torch.analysis.ir.retrace import RetraceSentinel
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = get_config(arch)
    slots, max_prompt, cache_len, new = 4, 512, 1024, 8
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(64, 501, size=slots)]
    toks = np.zeros((slots, max_prompt), np.int64)
    for row, p in enumerate(prompts):
        toks[row, -len(p):] = p
    toks = torch.from_numpy(toks).cuda()
    st = {}

    def plain():
        """The engine's work on one chunk, as plain calls: prefill (the
        last position's logits), then decode steps."""
        logits, st["cache"] = prefill(params, toks, cfg, cache_len,
                                      last_only=True)
        st["tok"] = logits[:, -1].argmax(-1)
        st["pos"] = torch.full((slots,), max_prompt, device="cuda")
        out = [st["tok"]]
        for _ in range(new - 1):
            eager_decode()
            st["tok"] = st["logits"].argmax(-1)
            out.append(st["tok"])
        return torch.stack(out, 1).cpu().numpy()

    def eager_decode():
        """The decode program's work: a step, its positions advanced."""
        st["logits"], _ = decode_step(params, st["tok"], st["pos"],
                                      st["cache"], cfg)
        st["pos"].add_(1)

    out, launches = {}, {}
    for mode in ("eager", "graphs"):
        eng = ServingEngine(params, cfg, slots=slots, max_prompt=max_prompt,
                            cache_len=cache_len, device="cuda") \
            if mode == "graphs" else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            if eng is None:
                ref, launches[mode] = _count_launches(
                    kernels, path, f"graphs {arch} {mode}", plain)
                ref, first = ref.tolist(), None
            else:
                first = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if eng is not None:
            with RetraceSentinel() as sen:
                res, launches[mode] = _count_launches(
                    kernels, path, f"graphs {arch} {mode}",
                    lambda: eng.generate(prompts, max_new_tokens=new))
            for r in first + res:
                if r.tokens != ref[r.request_id]:
                    fail(f"graphs {arch}: request {r.request_id}'s greedy "
                         f"tokens differ from the plain prefill/decode_step "
                         f"loop")
            if sen.count:
                fail(f"graphs {arch}: {sen.count} builds or captures in a "
                     f"second generate: {sen.compiled_names[:4]}")
            decode = lambda: eng._run("decode", eng._decode_static)  # noqa: E731
        else:
            decode = eager_decode
        with torch.no_grad():
            decode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_DECODE_STEPS):
                decode()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / GRAPH_DECODE_STEPS
            busy, pwall, idle = _idle_share(torch, lambda: [
                decode() for _ in range(4)])
        out[mode] = (ms, idle, peak, first_s, busy / 4)
        if eng is None:
            what = "plain loop (prefill + 7 decode steps)"
        else:
            what = "first generate (captures " + ", ".join(
                f"{k}: {p.compile_seconds:.4f}s pool_bytes="
                f"{eng.programs[k].pool_bytes}"
                for k, p in eng.program_profile.items()) + \
                "), tokens equal the plain loop's"
        log(f"graphs {arch} {mode}: {what} {first_s:.3f}s; decode "
            f"{ms:.3f} ms a step (host clock, {slots} slots, cache_len "
            f"{cache_len}), device kernels {busy / 4:.3f} ms a step, idle "
            f"share {idle:.3f} (4 steps profiled, {pwall:.3f} ms); "
            f"peak_mem_gb={peak:.2f}; launches {launches[mode]}")
        del eng
        st.clear()
    if launches["graphs"] != launches["eager"]:
        fail(f"graphs {arch}: launches {launches['graphs']} on graphs, "
             f"{launches['eager']} eagerly")
    del params
    torch.cuda.empty_cache()
    return launches["graphs"], out


def _graph_train(torch, kernels, path):
    """DiT-XL trained 8 steps through train_loop with jit=True (the step
    captured after its first eager run) and jit=False from one state:
    params within CHECK_TRAIN_TOL relative, launches equal; ms a step and
    idle share both ways."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.diffusion import linear_schedule
    from repro_torch.optim.adamw import CHUNK, global_norm
    from repro_torch.train.loop import StepProgram, train_loop
    from repro_torch.train.steps import (diffusion_batches, init_train_state,
                                         make_diffusion_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("dit-xl")
    eager = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    graphs = tree_map(lambda t: t.clone(), eager)
    step_fn = make_diffusion_train_step(cfg, linear_schedule(1000),
                                        peak_lr=3e-4, warmup=0,
                                        total_steps=TRAIN_STEPS)
    launches, ms = {}, {}
    for mode, state in (("eager", eager), ("graphs", graphs)):
        stamps = []

        def batches():
            for b in diffusion_batches(0, TRAIN_BATCH, cfg, "cuda"):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield b

        (_, hist), launches[mode] = _count_launches(
            kernels, path, f"graphs train {mode}", lambda: train_loop(
                step_fn, state, batches(), TRAIN_STEPS,
                log_every=TRAIN_STEPS, log_fn=lambda m: None,
                jit=mode == "graphs"))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        # a stamp as each batch is fetched (the loop fetches one past its
        # last step) and one at the end: step n ran between stamps n and n+1
        steps = [(b - a) * 1e3
                 for a, b in zip(stamps, stamps[1:])][:TRAIN_STEPS]
        ms[mode] = (statistics.median(steps[2:]), steps)
    rel = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1e-30)
              for a, b in zip(tree_leaves(graphs), tree_leaves(eager)))
    if not rel <= CHECK_TRAIN_TOL:
        fail(f"graphs train: jit=True and jit=False params differ by {rel}")
    if launches["graphs"] != launches["eager"]:
        fail(f"graphs train: launches {launches['graphs']} on graphs, "
             f"{launches['eager']} eagerly")
    batch = step_fn.prepare_batch(next(diffusion_batches(
        0, TRAIN_BATCH, cfg, "cuda", start_step=TRAIN_STEPS)))
    _, metrics = step_fn(graphs, batch)
    prog = StepProgram(step_fn, graphs, batch, metrics)
    idle = {"eager": _idle_share(torch, lambda: step_fn(eager, batch)),
            "graphs": _idle_share(torch, lambda: prog(batch))}
    for mode in ("graphs", "eager"):
        busy, pwall, share = idle[mode]
        log(f"graphs train {mode}: ms a step {ms[mode][0]:.1f} (median of "
            f"steps 3-{TRAIN_STEPS}, host clock; all {[round(x, 1) for x in ms[mode][1]]}); "
            f"profiled step wall {pwall:.1f} ms, device kernels {busy:.1f} "
            f"ms, idle share {share:.3f}; launches {launches[mode]}")
    log(f"graphs train: {TRAIN_STEPS} steps jit=True against jit=False: "
        f"params and moments within {rel:.3e} relative (tol "
        f"{CHECK_TRAIN_TOL}); capture {prog.profile.compile_seconds:.3f}s, "
        f"pool_bytes {prog.program.pool_bytes}")
    # the clip's global norm sums a leaf above adamw.CHUNK elements slice
    # by slice: its effect against one reduction a leaf, on the first
    # moments (the gradients' average) and the params
    for name, tree in (("first moments", graphs.opt.mu),
                       ("params", graphs.params)):
        leaves = tree_leaves(tree)
        sliced = float(global_norm(tree))
        whole = float(torch.sqrt(sum(torch.sum(torch.square(x.float()))
                                     for x in leaves)))
        big = sum(x.numel() > CHUNK for x in leaves)
        log(f"graphs train: global_norm of the {name} ({big} of "
            f"{len(leaves)} leaves above {CHUNK} elements) {sliced!r}, one "
            f"reduction a leaf {whole!r}, relative difference "
            f"{abs(sliced - whole) / whole:.3e}")
    del eager, graphs, prog
    torch.cuda.empty_cache()
    return launches["graphs"]


def phase_graphs(torch, kernels, path):
    """Every program of the served and trained paths captured per shape
    key (engine.warmup, the first generate, train_loop(jit=True)) against
    the same work run eagerly."""
    from repro_torch.core import FasterCacheCFG
    from repro_torch.modalities import make_workload
    from repro_torch.serving.diffusion import DiffusionServingEngine
    total = no_launches(kernels)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    t0 = time.perf_counter()
    cfg, params = full_dit(torch)
    for label, pol, cfg_pol, reqs in (
            ("graphs dit-xl taylorseer", "taylorseer", None,
             serve_requests(cfg)),
            ("graphs dit-xl teacache+fastercache_cfg", "teacache",
             FasterCacheCFG(4, 16), cfg_requests(cfg, torch))):
        add(_graph_serve_pair(
            torch, kernels, path[:1] + (path[1:2] if pol == "taylorseer"
                                        else ()), label,
            lambda: DiffusionServingEngine(params, cfg, pol, slots=4,
                                           max_steps=16, cfg_policy=cfg_pol,
                                           device="cuda"), reqs))
    del params
    torch.cuda.empty_cache()
    cfg, params = full_text(torch, "dit-t2i")
    wl = make_workload("t2i", cfg=cfg, params=params)
    reqs = text_requests(cfg, 8, (8, 16), guided=CFG_GUIDED, neg=CFG_VECTOR)
    conds = []

    def make_t2i():
        conds.append(wl.conditioner())
        return wl.engine("taylorseer", slots=4, max_steps=16,
                         cfg_policy=FasterCacheCFG(4, 16),
                         conditioner=conds[-1])

    add(_graph_serve_pair(torch, kernels, path[:2], "graphs dit-t2i", make_t2i,
                          reqs))
    if conds[-1]._program is None or conds[-1]._program.graph is None \
            or not conds[-1]._program.replays:
        fail("graphs dit-t2i: the prompt encoder was not captured and "
             "replayed")
    del params, wl, conds
    torch.cuda.empty_cache()
    log(f"graphs: DiT serving {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for arch, names in GRAPH_LLM:
        add(_graph_llm(torch, kernels, arch, tuple(
            k for k in kernels if k.__name__ in names))[0])
    log(f"graphs: LLM serving {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    add(_graph_train(torch, kernels, (path[0], path[3])))
    log(f"graphs: train {time.perf_counter() - t0:.1f}s")
    return total


def timed(name, fn, *args):
    """fn(*args), logging the phase's wall seconds and its own peak device
    memory: what earlier phases left is collected first, the peak counter
    is reset, and the bytes still allocated at the start are logged."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{name}: phase wall {time.perf_counter() - t0:.2f}s "
        f"phase_peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"(resident at its start {resident / 1e9:.3f} GB)")
    return out


def on_model(build, phase):
    """phase(torch, *args, params, cfg) on a model `build(torch)` makes for
    it alone (random weights from seed 0: every phase gets the same), so
    no phase's params outlive it."""
    def run(torch, *args):
        cfg, params = build(torch)
        return phase(torch, *args, params, cfg)
    return run


def start_sass(lib: Path):
    """cuobjdump -sass of the built library into `sass.txt` beside it,
    started now so that it runs beside the card's phases; None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = lib.parent / "sass.txt"
    with open(out, "w") as f:
        proc = subprocess.Popen([tool, "-sass", str(lib)], stdout=f,
                                stderr=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


#: the kernels whose tensor-core instructions the build phase checks: (what,
#: name fragments, the instructions of which each must issue one or more).
#: mma.sync shows as HMMA in the SASS, the warpgroup wgmma as HGMMA (which
#: does not contain "HMMA"); the wide backward runs every product on wgmma.
TENSOR_CORE_CHECKS = (
    ("SSD forward", SSD_KERNELS, ("HMMA", "HGMMA")),
    ("flash backward", ("flash_bwd_dkdv", "flash_bwd_dq"), ("HMMA", "HGMMA")),
    ("SSD backward", ("ssd_bwd_state_kernel", "ssd_bwd_tile_kernel"),
     ("HMMA", "HGMMA")),
    ("wide flash backward", ("flash_bwd_dkdv_wide", "flash_bwd_dq_wide"),
     ("HGMMA",)),
    ("general flash forward", ("flash_fwd_any",), ("HMMA", "HGMMA")),
    ("general SSD forward", ("ssd_cb_any", "ssd_scan_any"), ("HMMA", "HGMMA")),
    ("general SSD backward", ("ssd_bwd_state_any", "ssd_bwd_tile_any"),
     ("HMMA", "HGMMA")),
)


def tensor_core_counts(listing: str):
    """{function: {"HMMA": n, "HGMMA": n}} of a `cuobjdump -sass` listing:
    each function's mma.sync (HMMA) and wgmma (HGMMA) instructions."""
    counts, fn = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            if "HGMMA" in line:
                counts[fn]["HGMMA"] += 1
            elif "HMMA" in line:
                counts[fn]["HMMA"] += 1
    return counts


def check_tensor_cores(counts):
    """(log lines, failures) of TENSOR_CORE_CHECKS over tensor_core_counts'
    result: a group none of whose kernels is in the listing, or a kernel
    that issues none of its group's instructions, fails."""
    lines, failures = [], []
    for what, frags, kinds in TENSOR_CORE_CHECKS:
        group = {f: n for f, n in counts.items()
                 if any(k in f for k in frags)}
        bad = [f for f, n in group.items() if not any(n[k] for k in kinds)]
        hmma = sum(n["HMMA"] for n in group.values())
        hgmma = sum(n["HGMMA"] for n in group.values())
        lines.append(
            f"{len(group) - len(bad)} of {len(group)} {what} kernels issue "
            f"{' or '.join(kinds)}; HMMA {hmma}, HGMMA {hgmma} in all")
        if not group:
            failures.append(f"no {what} kernel in the SASS")
        for f in bad:
            failures.append(f"the {what} kernel {f[:100]} issues no "
                            f"{' or '.join(kinds)} instruction")
    return lines, failures


def log_hmma(sass) -> None:
    """Count the tensor-core instructions of each flash and SSD kernel in
    start_sass' output, mma.sync (HMMA) and wgmma (HGMMA) apart; fail
    where check_tensor_cores finds a kernel without its instructions."""
    if sass is None:
        log("build: cuobjdump not found; HMMA / HGMMA count not taken")
        return
    proc, out = sass
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("build: cuobjdump -sass did not end in 300 s")
    if proc.returncode != 0:
        fail(f"build: cuobjdump -sass exited {proc.returncode}")
    waited = time.perf_counter() - t0
    counts = tensor_core_counts(out.read_text())
    flash = {f: n["HMMA"] for f, n in counts.items() if "flash_fwd" in f}
    log(f"build: sass: {sum(n > 0 for n in flash.values())} of {len(flash)} "
        f"flash_fwd kernels use HMMA; "
        f"{sum(flash.values())} HMMA instructions in all (cuobjdump beside "
        f"the phases; {waited:.2f}s waited for it, "
        f"{time.perf_counter() - t0:.2f}s with the count)")
    for tag in ("flash_fwdIfLi72ELb1E", "flash_fwdI13__nv_bfloat16Li80ELb1E"):
        hits = [n for f, n in flash.items() if tag in f]
        log(f"build: sass: {tag}: HMMA {hits}")
    for f, n in counts.items():   # the backwards above head dim 128
        if ("flash_bwd_dkdv" in f or "flash_bwd_dq" in f) \
                and ("_wide" in f or "_any" in f):
            log(f"build: sass: {f[:90]}: HMMA {n['HMMA']}, HGMMA {n['HGMMA']}")
    lines, failures = check_tensor_cores(counts)
    for line in lines:
        log(f"build: sass: {line}")
    if failures:
        fail(f"build: {'; '.join(failures)}")


def kernels_line(by_path, flash, fc, ssd, flash_bwd, ssd_bwd, any_rows):
    """The kernels line's rows: each kernel's numbers from its phase, and
    its launches on each path from the counts of its C entry points;
    fail unless the rows hold each entry point once and every path's
    entry counts add up to its wrappers' counts."""
    from repro_torch.kernels import KERNELS, _build
    # the backward above head dim 128 (flash_attention_bwd_wide.cu): its
    # numbers are the pixtral row's
    wide_bwd = dict(flash_bwd[BWD_WIDE[0]])
    wide_bwd[BWD_WIDE[1]] = flash_bwd[BWD_WIDE[1]]
    wide_bwd["registers_spills"] = flash_bwd["wide_registers_spills"]
    # each row: its source, the TPU code it replaces, its numbers, and the
    # C entry points whose launches on the paths are its launches
    fa = "src/repro_torch/kernels/flash_attention/csrc/"
    autodiff = "src/repro/models/layers.py:86 (JAX autodiff of " \
        "blocked_attention"
    table = (
        ("flash_attention", fa + "flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:75", flash,
         ("flash_attention_fwd", "flash_attention_fwd_split",
          "flash_attention_fwd_lse", "flash_attention_fwd_split_lse")),
        ("forecast", "src/repro_torch/kernels/forecast/csrc/forecast.cu",
         "src/repro/kernels/forecast/forecast.py:32", fc,
         ("forecast_fwd", "forecast_basis_fwd")),
        ("ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
         "src/repro/kernels/ssd/ssd.py:73", ssd, ("ssd_fwd",)),
        ("flash_attention_backward", fa + "flash_attention_bwd.cu",
         autodiff + "; no Pallas kernel)", flash_bwd,
         ("flash_attention_bwd",)),
        ("ssd_backward", "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
         "src/repro/models/ssm.py:207 (JAX autodiff of ssd_chunked; no "
         "Pallas kernel)", ssd_bwd, ("ssd_bwd",)),
        ("flash_attention_backward_wide", fa + "flash_attention_bwd_wide.cu",
         autodiff + " above head dim 128; no Pallas kernel)", wide_bwd,
         ("flash_attention_bwd_wide",)),
        # the general units (slice 19), numbers from the any-kernels phase
        ("flash_attention_any", fa + "flash_attention_any.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:75 (any "
         "head dim and dtype)", any_rows["flash_attention_any"],
         ("flash_attention_fwd_any",)),
        ("flash_attention_backward_any", fa + "flash_attention_bwd_any.cu",
         autodiff + " at any head dim; no Pallas kernel)",
         any_rows["flash_attention_backward_any"],
         ("flash_attention_bwd_any",)),
        ("ssd_any", "src/repro_torch/kernels/ssd/csrc/ssd_any.cu",
         "src/repro/kernels/ssd/ssd.py:73 (any p and n)",
         any_rows["ssd_any"], ("ssd_fwd_any",)),
        ("ssd_backward_any", "src/repro_torch/kernels/ssd/csrc/ssd_bwd_any.cu",
         "src/repro/models/ssm.py:207 (JAX autodiff of ssd_chunked at any p "
         "and n; no Pallas kernel)", any_rows["ssd_backward_any"],
         ("ssd_bwd_any",)))
    if sorted(e for *_, entries in table for e in entries) \
            != sorted(_build.ENTRIES):
        fail("kernels line: the rows do not hold each C entry point once")
    for path, n in by_path.items():
        entries = sum(n.get(e, 0) for e in _build.ENTRIES)
        wrappers = sum(n.get(k.__name__, 0) for k in KERNELS)
        if entries != wrappers:
            fail(f"{path}: the wrappers counted {wrappers} launches, the C "
                 f"entry points {entries} ({n})")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = []
    for name, src, replaces, rep, entries in table:
        per_path = {path: sum(n.get(e, 0) for e in entries)
                    for path, n in by_path.items()}
        per_path = {path: c for path, c in per_path.items() if c > 0}
        # the contract's keys first, then each phase's extra numbers
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
                     **{k: rep[k] for k in keys},
                     **{k: v for k, v in rep.items() if k not in keys}})
    return rows


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (SRC / "repro_torch" / "kernels").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    # the dry runs (CPU subprocesses) run beside the build and the phases
    dry_out = ROOT / "dryrun_out" / "chip_smoke"
    procs = start_dryruns(dry_out)
    atexit.register(stop_dryruns, procs)

    from repro_torch.kernels import KERNELS, _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f}s")
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) \
                or line.startswith("=="):
            log(f"build: {line.strip()}")
    sass = start_sass(lib)

    (flash_attention, forecast, ssd_scan, flash_attention_backward,
     ssd_scan_backward) = KERNELS
    if "--graphs-only" in sys.argv[1:]:
        timed("forecast", phase_forecast, torch, 4)
        timed("graphs", phase_graphs, torch, KERNELS,
              (flash_attention, forecast, ssd_scan,
               flash_attention_backward))
        log_hmma(sass)
        log(card)
        return 0
    flash = timed("flash", phase_flash, torch, F)
    flash_bwd = timed("flash-bwd", phase_flash_bwd, torch, F)
    if "--flash-only" in sys.argv[1:]:
        log_hmma(sass)
        log(card)
        return 0
    fc = timed("forecast", phase_forecast, torch, 4)
    ssd = timed("ssd", phase_ssd, torch)
    ssd_bwd = timed("ssd-bwd", phase_ssd_bwd, torch)
    by_path = {}
    by_path["serve"], fc["serve_skip_tick_ms"] = timed(
        "serve", phase_serve, torch, KERNELS, (flash_attention, forecast))
    by_path.update(timed("serve-adaptive", phase_serve_adaptive, torch,
                         KERNELS, flash_attention, forecast))
    timed("check", phase_check, torch)
    # each phase builds the models it serves and drops them at its end
    by_path["serve-cfg"], cfg_summary = timed(
        "serve-cfg", on_model(full_dit, phase_serve_cfg), torch, KERNELS,
        (flash_attention, forecast))
    timed("check-cfg", phase_check_cfg, torch)
    by_path["serve-diffusion"] = timed(
        "serve-diffusion", on_model(full_dit, phase_serve_diffusion), torch,
        KERNELS, (flash_attention,))
    # slice 7: the video and audio DiTs, the temporal policies, the
    # structural granularities and the mixed-modality pool
    by_path.update(timed("serve-video", on_model(full_video,
                                                 phase_serve_video),
                         torch, KERNELS, flash_attention, forecast))
    by_path["denoise-video"] = timed(
        "denoise-video", on_model(full_video, phase_denoise_video), torch,
        KERNELS, flash_attention)
    timed("check-video", phase_check_video, torch)
    by_path["serve-mixed"] = timed("serve-mixed", phase_serve_mixed, torch,
                                   KERNELS, (flash_attention,))
    # slice 8: text conditioning
    by_path.update(timed("serve-t2i", phase_serve_t2i, torch, KERNELS,
                         flash_attention, forecast, F, cfg_summary))
    timed("check-text", phase_check_text, torch)
    by_path.update(timed("serve-t2v", phase_serve_t2v, torch, KERNELS,
                         flash_attention, forecast, F))
    # slice 9: the online control plane and observability
    by_path["control"] = timed("control", on_model(full_dit, phase_control),
                               torch, KERNELS, (flash_attention, forecast))
    by_path["observability"] = timed("observability", phase_observability,
                                     torch, KERNELS, (flash_attention,))
    timed("check-control", phase_check_control, torch)
    by_path["serve-llm"] = timed("serve-llm", phase_serve_llm, torch,
                                 KERNELS, (flash_attention, ssd_scan))
    timed("check-llm", phase_check_llm, torch)
    # slice 10: training, the flash kernel in both directions
    train_path = (flash_attention, flash_attention_backward)
    by_path["train"] = timed("train", phase_train, torch, KERNELS, train_path)
    by_path["train-dit"] = timed("train-dit", phase_train_dit, torch, KERNELS,
                                 (*train_path, forecast))
    timed("check-train", phase_check_train, torch)
    # slice 11: zamba2 training on the card, the dense family, dlm
    by_path["train-llm"] = timed(
        "train-llm", phase_train_llm, torch, KERNELS,
        (*train_path, ssd_scan, ssd_scan_backward))
    timed("check-train-llm", phase_check_train_llm, torch)
    by_path["serve-dense"] = timed("serve-dense", phase_serve_dense, torch,
                                   KERNELS, (flash_attention,))
    timed("check-dense", phase_check_dense, torch)
    by_path["train-dense"] = timed("train-dense", phase_train_dense, torch,
                                   KERNELS, train_path)
    by_path["dlm"] = timed("dlm", phase_dlm, torch, KERNELS,
                           (flash_attention, forecast))
    # slice 13: the ssm (Mamba1), encoder-decoder and vlm families
    by_path["serve-ssm"] = timed("serve-ssm", phase_serve_ssm, torch, KERNELS,
                                 ())
    timed("check-ssm", phase_check_ssm, torch)
    by_path["serve-encdec"] = timed("serve-encdec", phase_serve_encdec, torch,
                                    KERNELS, (flash_attention,))
    timed("check-encdec", phase_check_encdec, torch)
    by_path["serve-vlm"] = timed("serve-vlm", phase_serve_vlm, torch, KERNELS,
                                 (flash_attention,))
    timed("check-vlm", phase_check_vlm, torch)
    # slice 14: the moe family
    by_path["serve-moe"] = timed("serve-moe", phase_serve_moe, torch, KERNELS,
                                 (flash_attention,))
    timed("check-moe", phase_check_moe, torch)
    # slice 18: training above head dim 128 (pixtral-12b, deepseek-v2's MLA)
    by_path["train-wide"] = timed("train-wide", phase_train_wide, torch,
                                  KERNELS, train_path)
    timed("check-train-wide", phase_check_train_wide, torch)
    # slice 19: the kernels' whole domain (any head dim, any SSD p and n)
    any_rows = timed("any-kernels", phase_any_kernels, torch, F)
    by_path["any-paths"] = timed("any-paths", phase_any_paths, torch,
                                 KERNELS)
    timed("check-any", phase_check_any, torch)
    # slice 15: the analysis package on the card
    by_path["verify"] = timed("verify", phase_verify, torch, KERNELS,
                              (flash_attention, forecast))
    # slice 17: every program captured per shape key in CUDA graphs
    by_path["graphs"] = timed("graphs", phase_graphs, torch, KERNELS,
                              (flash_attention, forecast, ssd_scan,
                               flash_attention_backward))
    # slice 16: distribution on a world-size-1 NCCL group
    try:
        nccl_world(torch)
        by_path["dist"], dist_gb = timed("dist", phase_dist, torch,
                                         KERNELS, (flash_attention,))
        by_path["dist-moe"] = timed("dist-moe", phase_dist_moe, torch,
                                    KERNELS, (flash_attention,))
        timed("dryrun", phase_dryrun, torch, procs, dry_out, dist_gb)
        by_path["perf-dit"] = timed("perf-dit", phase_perf_dit, torch,
                                    KERNELS, (flash_attention, forecast),
                                    dry_out)
    finally:
        stop_dryruns(procs)
        import torch.distributed as tdist
        if tdist.is_initialized():
            tdist.destroy_process_group()

    log_hmma(sass)
    rows = kernels_line(by_path, flash, fc, ssd, flash_bwd, ssd_bwd, any_rows)
    log(f"chip_smoke: total wall {time.perf_counter() - t_start:.2f}s")
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
