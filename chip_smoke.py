#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # all phases, one CUDA card

Run from the repository root on a machine with an NVIDIA H100. It builds
the six kernel libraries from `src/repro_torch/kernels/csrc` (one nvcc per
source, all started together; seven kernels), then:

  1. kernels — each kernel against its plain PyTorch twin on the card, in
     f32 (TF32 off) and bf16: the fastvlm-1.7b path's four at its
     serving shapes (d_model 1536, F 8960, H 12, Hkv 2, Dh 128; decode
     M = 4, prefill M = 320, attention S = L = 320, paged decode B = 4,
     W = 128, max_len 512), and the mobilevlm-3b shapes (d_model 2560,
     F 6912, H = Hkv = 20, G = 1, Dh 128): qkv_proj, ffn_act_int8,
     ffn_act and fused_norm at decode M = 4 and prefill M = 256,
     paged_decode_flat and paged_decode_tiered at B = 4 slots,
     attn_stream at S = L = 256; qkv_proj at M = 1, 3, 4 (the GEMV),
     5 (the first GEMM row count) and prefill, at both models (fastvlm
     with bias), and at M = 64 (a prefix hit's padded question tail;
     fused_norm and ffn_act there too); attn_stream also on an extend
     chunk (S = 64 at q_offset 256 over a strided slice of the
     (1, 512, Hkv, 128) workspace: the hit tail's attention), at
     ragged S = L = 200 and at fastvlm-0.6b's Dh 64; in f32 also at the
     training shape (8, 12, 256, 128) G 6, on extends of 1 and 16
     query rows over 300 keys and a 16-row prefill at Dh 128 and 64,
     and with a NaN in one q feature and in one k feature (the kernel
     must give NaN exactly where the twin does), the form that ran
     asserted on every attention case (f32: "tf32x3" at Dh 64 / 128 /
     160, each tf32x3 case's error held to and printed beside the bound
     of its 3xTF32 split, `tf32x3_attn_bound`; "fma" at Dh 256);
     fused_norm at M = 1, 4, 64, 320 and D 1536, 2560, 1000 and 1001
     (the scalar kernel), LayerNorm with bias, a scale in the other
     type and strided rows (pitch 1544: vector kernel; pitch 1542 or a
     base one element in: scalar kernel); paged_decode_flat at lengths
     0, 1, 127, 128, with a slot's last live page dead, at max_len 500
     (ragged tail page), at every head dim, at G 1 to 16 and at
     B * Hkv = 160 (no key split);
     paged_decode_tiered at lengths 0, 1, W - 1, W, W + 1 and max_len - 1,
     with dead pages (a slot's last live one, a slot with none), at G 1,
     2, 3, 4, 6, 8 and 16, every head dim, B * Hkv = 160, and the sparse
     read (tau = 1e-3, split 1) against the twin at the same tau, once on
     inputs where it really skips pages; its fastvlm (Hkv 2, G 6) and
     mobilevlm-3b (Hkv 20, G 1) shapes are timed beside their bound, the
     device time also from CUDA events (`event_ms`);
     ffn_act and ffn_act_int8 in every form, the one that ran asserted:
     in bf16 the stream form at M 1, 3, 4 and 5 (each beside the bound
     of its 16-bit rounding of h) and the wgmma form at M 63, 65, 256,
     257 and 320, the FMA tiles in f32 at every M, at D 320 (a ragged
     k-tile), F 1000 / 1024, every activation, int8 gated and not, and
     the FMA tiles for rows that are not whole 16-byte vectors (int8 F
     1000 or D 200, bf16 F 1004); the FFN's decode and prefill shapes of
     both models are timed beside their bound and, as a yardstick only,
     the cuBLAS chain mm, mm, silu * mul, mm (a chain of kernels, not
     one call);
     plus ragged, dead-page, unaligned-row and sparse-read cases.
     The banner prints the tensor-core kernels', the FFN forms' and the
     paged decodes' tiles and plans (the decodes' planned splits too)
     from their Python mirrors and holds each mirrored shared-memory size
     against the built library's; the SASS of the tensor-core libraries
     (attn_stream, qkv_proj, ffn_act, ffn_act_int8) must hold HGMMA and
     LDGSTS, every instance of the paged decode library's two kernel
     functions LDGSTS (their cp.async key rings), and every instance of
     the tf32x3 kernels (`attn_tf32_kernel`, `qkv_tf32_kernel`,
     `ffn_up_tf32_kernel`, `ffn_down_tf32_kernel`) HGMMA with TF32
     operands and LDGSTS; every tiered instance
     must leave room for the planner's 2 blocks an SM. Tolerances:
     max-abs error <= 1e-4 in f32 (f32 sums in another order) and <= 2e-2
     in bf16 (inputs are scaled so outputs stay below magnitude 2, where
     one bf16 rounding step is <= 7.8e-3); the paged decodes, whose
     outputs are softmax means of V rows (1e-2 to 1 here), are held to
     the same numbers times each (slot, kv head)'s largest output, and
     the sparse case's skip must move the output by more than twice
     that. Call times are the median of
     25 CUDA-event timed calls after warm-up, device times the
     profiler's kernel time a call, for the kernels and for the library
     call beside them (SDPA; torch.addmm at decode and prefill;
     F.rms_norm; SDPA with a boolean length mask beside the flat decode),
     with the device kernels each library call launches; and
     deepseek-v2-lite's dense first layer: ffn_act at D 2048, F 10944
     (85.5 slices of 128: a ragged last one) at M 4 (stream) and 256
     (wgmma), f32 and bf16, the bf16 ones timed beside their bound and
     the cuBLAS chain, and fused_norm at D 2048, M 4 and 256 (bf16 timed
     beside F.rms_norm); the recurrent archs' widths: fused_norm
     LayerNorm + bias at rwkv6-7b's D 4096 (M 1, 4, 256; beside
     F.layer_norm) and zamba2-1.2b's shared attention block: qkv_proj at
     D 2048, N 3 x 2048 (M 1, 4, 5, 256; beside torch.addmm),
     attn_stream at Dh 64, G 1, H 32 (S = L = 256 beside SDPA; extend
     chunks S 128 at L 256 and S 44 at L 300), paged_decode_tiered at
     Hkv 32, G 1, Dh 64 (the decode shape timed; lengths around the
     window and the pages, dead pages) and ffn_act gelu_gated at D 2048,
     F 8192 (M 4 stream, M 256 wgmma, beside the cuBLAS chain); and the
     dense archs' widths (stablelm-12b,
     starcoder2-7b, paligemma-3b): fused_norm LayerNorm + bias at D 5120
     / 4608 and rms at 2048; qkv_proj at D 5120 (N 5120 / 1280 / 1280),
     D 4608 with bias (4608 / 512 / 512) and D 2048 (2048 / 256 / 256) at
     M 1, 4, 5 and prefill; attn_stream at Dh 160 (H 32, Hkv 8), Dh 128
     G 9 (36 / 4) and Dh 256 (8 / 1), prefill S = L, an extend chunk and
     a ragged one; paged_decode_tiered at Dh 160 G 4 and Dh 256 G 8 at
     the decode shape (timed), around the window and pages, dead pages,
     G 1 and 9, tau = 1e-3, B * Hkv = 160; paged_decode_flat at Dh 128 G
     9 (starcoder2, timed beside masked SDPA), Dh 160 and 256, page
     edges, a dead page, a ragged tail page; ffn_act at D 5120 F 13824
     silu_gated and D 2048 F 16384 gelu_gated at M 4 and prefill (the
     bf16 ones timed beside the cuBLAS chain) and ffn_act_int8 at D 5120
     in every form; the bf16 rows beside their bound and the library
     call (F.layer_norm / F.rms_norm, torch.addmm, SDPA); and this
     slice's shapes: hubert-xlarge's LayerNorm + bias at D 1280, its
     qkv_proj GEMM (N 3 x 1280) and its ungated gelu ffn_act (F 5120),
     each at M 2000 (4 clips x 500 frames: ragged for every tile);
     llama4-maverick-400b's rms at D 5120, qkv_proj at N 5120 / 1024 /
     1024 (M 1, 4, 5, 256), attn_stream at H 40, Hkv 8, Dh 128 (G 5)
     and paged_decode_tiered at Hkv 8, G 5, Dh 128;
  2. parity — f32 at full width and depth, the serving Engine's tokens
     against `generate` on 2 VQA + 2 text requests, for fastvlm-1.7b over
     the tiered store, for mobilevlm-3b on path A (flat store, fused
     decode in the Engine, the unfused store_read + softmax decode in
     `generate`) and on path B (tiered store, hot window 64, int8 FFN
     weights); a differing token passes only where `generate`'s top-2
     logit margin at that step is below the run's tie threshold: 4 x the
     largest |logit| difference measured between the two runs at the
     steps before their streams part, never below 1e-3 (`TIE_FACTOR`,
     `TIE_FLOOR`; each tie prints margin, drift and threshold); and path B
     preempted: 2 slots, 2 verbatim spill lanes, 2 priority-0 VQA
     requests, then after 3 steps a priority-1 text request that evicts
     one; its tokens against the same requests on an unpressured Engine
     (same tie rule); and fastvlm-paged: fastvlm-1.7b, tiered (hot
     window 64), 2 slots, max_len 512, paged + prefix cache, 4 VQA
     requests on one image (64 patches) and one 192-token system prompt
     (a 256-token head, 2 blocks of 128) with questions of 36-48 tokens
     and 16 new tokens, the first committed before the rest are
     submitted: its tokens against a slot-pool Engine's (same tie rule),
     3 hits of 256 tokens; and deepseek-parity: deepseek-v2-lite in f32
     at full width with the depth cut to 6 layers (1 dense + 5 MoE; the
     cut is printed), tiered latent store (hot window 64), 2 slots, 4
     text requests of 128 tokens, 16 new: Engine == generate (tie rule;
     6 of 27 layers, for the script's time; full depth, 62.8 GB in f32,
     is the phase deepseek-full, not run by default; on a MoE model a
     failure names where the two runs' routing, logged, first parts);
     every parity run prints its peak device memory;
  3. serving — three bf16 runs through the Engine at full width and
     depth, each the main path of its configuration: the kernels' launch
     counters are zeroed just before each run and read just after, and
     each run must launch its own set of kernels exactly once per layer
     per model call:
       * fastvlm-1.7b, tiered store (hot window 128, max_len 512): 8
         requests (4 VQA with 64 visual + 192 text tokens, 4 text with
         256) at concurrency 4, 64 new tokens each;
       * A, the DRAM-only arm: mobilevlm-3b, flat store, fused decode
         resolved on through the backend knob (paged_decode_flat);
       * B, the CHIME mapping: mobilevlm-3b, tiered store (hot window
         128) with int8 FFN weights (ffn_act_int8);
     A and B serve 8 requests (4 VQA with 144 visual + 112 text tokens,
     4 text with 256) at concurrency 4, max_len 512, 64 new tokens each.
     Each run is priced by chime_sim on the CHIME platform (and on the
     M3D-DRAM-only one) from its served trace, after the timed window:
     analytic tok/J and J with the per-domain split, not a measurement
     of the card. A decode-step profile and a whole-prompt prefill
     profile (torch.profiler) follow each run; in each, every kernel's
     launches in the profile are compared with its launch counter over
     the same window (a mismatch is printed), and the run's paged decode
     is timed alone on its last call's operands (profiler and CUDA
     events). Then path B under priority traffic, 4 slots and 4 RRAM
     spill lanes, with a Telemetry hub: 8 priority-0 requests (as
     above), 3 engine steps, then 4 priority-1 text requests (64-token
     prompts, 16 new tokens) that preempt runners:
       * B-preempt: verbatim lanes;
       * B-offload: int8-compressed lanes and idle offload after 16
         resident decode steps.
     Each must finish every request with evictions (and idle offloads)
     > 0 and every parked request restored, exact launch counts,
     write-once on the cold tier, the lanes' RRAM counters equal to
     `expected_spill_block_writes` over the eviction contexts, the
     ledger equal to `simulated_efficiency` (==), and a valid Perfetto
     trace and Prometheus exposition (written to chiprun_out/); it
     prints lane bytes (verbatim and compressed) and one evict_slot and
     one restore_slot's device time (CUDA events, median of 5) beside
     the bound of their bytes. Before them, B-stream, on the host: B's
     weights with RRAM weight streaming at W = 2. Streaming is
     accounting only (the same loop over the same device-resident
     weights, so nothing is served again): resident B charged for its
     weights under the CHIME budget must be refused ("weight working
     set"), the streamed engine, which charges its 632.5 MiB DRAM
     working set by itself, must admit 4 slots, and chime_sim prices
     B's served trace with a weight_stream term above B's resident
     figure; it prints the DRAM / RRAM weight split and both tok/J. Last, fastvlm-prefix, many
     questions about one camera frame: bf16 fastvlm-1.7b, tiered (hot
     window 128), 4 slots, max_len 512, paged + prefix cache, a
     Telemetry hub, 8 VQA requests with the 256-token head above,
     48-token questions and 64 new tokens, the first committed before
     the other 7 are submitted: 7 hits of 256 tokens, every block
     written at most once, no refcount left after the drain, write-once
     on the cold tier, exact launches with the uncommitted rerun of each
     registering commit counted, the ledger equal to
     simulated_efficiency; it prints the peak prefix bytes pinned by
     live admissions (read as each hit is released), hit and cold TTFT
     p50, one hit-tail extend's device ms
     against the whole 304-token prefill's (profiler) and chime_sim's
     tok/J. Then deepseek, MLA and the dropless MoE: bf16
     deepseek-v2-lite at full width and depth (31.4 GB of weights built
     on the card), tiered latent store (hot window 128), 4 slots,
     max_len 512, a Telemetry hub, 8 text requests of 256 tokens with 64
     new: exact launches (fused_norm 55 and ffn_act 1 a model call, no
     other kernel), write-once on the cold latent tier, the ledger equal
     to simulated_efficiency, chime_sim on CHIME and M3D-DRAM-only, the
     timing and both profiles (each with the top torch ops by device
     time: the experts' aten::bmm, MLA's einsums), the peak device
     memory after init and after the run; last, `apply_moe` and
     `apply_mla_decode` run again on one decode step's inputs with the
     device's sync debug mode at "error" (a host sync fails the run).
  4. stablelm, starcoder2, paligemma — the dense attention archs, each
     an f32 parity run at full width and depth (<arch>-parity: Engine ==
     generate, tie rule; stablelm-12b 40 layers, 48.6 GB, starcoder2-7b
     32, 29.6 GB, paligemma-3b 18, 10.0 GB, each printing its peak
     memory; 2 VQA + 2 text requests on paligemma)
     and a bf16 run at full width and depth, weights built on the card,
     4 slots, max_len 512, 8 requests of 256 tokens with 64 new
     (paligemma: 4 of them VQA, 256 image + 64 text tokens) and a
     Telemetry hub: stablelm-12b over the tiered store (hot window 128),
     starcoder2-7b over the flat store with fused decode
     (paged_decode_flat at G 9; its biased FFN is plain, as in the
     reference), paligemma-3b tiered. Each: exact launches a model call
     (fused_norm 81 / 65 / 37, qkv_proj 40 / 32 / 18, ffn_act 40 / 0 /
     18, attn_stream a layer an extend, the paged decode a layer a
     decode step), write-once, the ledger == simulated_efficiency,
     chime_sim on CHIME and M3D-DRAM-only, the timing and both profiles,
     the peak device memory after init and after the run.
  5. rwkv6, zamba2 — the recurrent archs (`models/ssm.py`; the WKV6 and
     SSD scans are plain PyTorch ops, as the reference has no kernel for
     them), each an f32 parity run at full width and depth
     (<arch>-parity, tie rule: rwkv6-7b's 32 layers, 30.5 GB in f32, 4
     text requests of 128; zamba2-1.2b's 38 positions, tiered (hot window
     64), 2 requests of 128 and 2 of 300 tokens, the Engine prefilling in
     chunks of at most 128 on the SSM grid, `generate` whole) and a bf16
     run as the dense archs' at full width and a depth cut
     (`SERVE_LAYERS`: for the script's time limit; 8 text requests of
     256, 64 new, 4 slots, max_len 512, a Telemetry hub): rwkv6-7b's
     first 8 of 32 layers with no KV store (CHIME tiering does not
     apply), zamba2-1.2b's first 12 of 38 (10 Mamba2 + 2 shared-block
     applications) over the tiered store (hot window 128; KV in the
     shared-attention applications only). Exact launches a model call
     (rwkv6: fused_norm 17 and nothing else, the channel mix plain as in
     the reference; zamba2: fused_norm 15, qkv_proj 2, ffn_act 2,
     attn_stream 2 an extend, paged_decode_tiered 2 a decode step; 65 /
     45 / 6 at full depth), write-once, ledger == simulated_efficiency,
     chime_sim, and in both profiles the device time and launches under
     the recurrences' ranges (the mixers, the scans, the channel mix).
  6. hubert — hubert-xlarge encoder inference through `Model.forward`
     (the full-sequence forward) at full width and depth: 48 layers,
     d_model 1280, 16 heads x 80, LayerNorm, gelu F 5120, learned
     positions, the linear audio connector, non-causal attention (plain,
     as in the reference). bf16 on 4 clips x 500 frames (10 s of 16 kHz
     audio at 20 ms frames; random frame embeddings, the reference's
     frontend stub): exact launches a forward (fused_norm 97, qkv_proj
     48, ffn_act 48 in its wgmma form at M 2000, nothing else), finite
     logits, wall and device ms, busy share, frames/s, top ops, peak
     memory; f32 at full depth: clip 0 on the card against the host
     CPU's forward (<= 1e-3 of the largest |logit|, argmax agreement),
     and clip 0 alone against its row of the batch (<= 1e-5 relative).
  7. llama4 — first the MoE determinism check: `apply_moe` twice on one
     input must be `torch.equal` (one deepseek-v2-lite MoE layer at full
     width, bf16 and f32, T 4 and 256; llama4's layer 0 in bf16, T 4
     and 256). Then llama4-maverick-400b at full width (GQA 40 / 8 x
     128, G 5; 128 experts top-1 of F 8192 + 1 shared; vocab 202,048)
     at a 2-layer cut in bf16 (its 48 layers hold 32.2 GB of experts
     each): the dense archs' run (tiered W 128, 8 text requests of 256,
     64 new; exact launches fused_norm 5, qkv_proj 2, attn_stream 2 an
     extend, paged_decode_tiered 2 a step; write-once, ledger == sim,
     profiles, peak memory), decode busy beside the all-weights floor
     and the floor of the <= 4 experts a layer 4 slots can touch,
     `apply_moe` under sync debug mode "error"; then llama4-parity: f32
     at a 1-layer cut (73.5 GB), Engine == generate (tie rule) on 4
     text requests of 128 with 16 new, the free memory before the build
     and the peak printed.
  8. train — fastvlm-1.7b training in f32 (TF32 off), as the train CLI
     trains. Each kernel Function of the training path (`fused_norm`,
     `qkv_proj` with bias, `attn_stream` causal, `ffn_act` silu_gated)
     at the training shapes (M = 8 x 256 rows; q (8, 256, 12, 128), 2
     kv heads; F 8960): its output (the kernel) and every input gradient
     (the twin's VJP) against autograd through the plain twin, <= 1e-4
     of the largest element, each forward timed beside the twin, one
     library call and its f32 bound; the tf32x3 forms of `qkv_proj`,
     `attn_stream` and `ffn_act` also by profiler and CUDA events beside
     their 3xTF32 bound, the library call's device time (SDPA in f32,
     TF32 off, beside attn_stream) and the fma form's earlier time. At a
     2-layer cut (full width, B 2 x S 128):
     the loss and every gradient leaf on the card against the host
     CPU's, <= 1e-4 of the leaf's largest element, no leaf None,
     non-finite or all zero, remat "none" and "full". At full width and
     depth (28 layers, ~1.55 B parameters): six `make_train_step` steps
     on the pipeline's VQA batches (8 x 256: 64 visual + 192 text) with
     the CLI's AdamW at --steps 6; step 1's gradients all present and
     finite, finite losses, exactly fused_norm 57 and qkv_proj /
     attn_stream / ffn_act 28 launches a step (none in backward); step
     ms, tokens/s, peak memory, 6 N T FLOP beside its f32 floor, a
     profiled step (busy, idle share, the forward kernels, each
     wrapper's among them, against the rest). Then checkpoint + resume
     at the cut under deterministic algorithms: a `FaultTolerantLoop` with an injected failure past
     its retry, and a fresh resume from the checkpoint, each `torch.equal`
     to an uninterrupted run (params, mu, nu, step); save and restore
     seconds.
  9. sharded — the serve path through `make_backend("sharded",
     mesh=get_mesh("1x1"))` over NCCL at world size 1 (the phase fails
     if NCCL cannot initialise): fastvlm-1.7b at full width and depth,
     bf16, tiered (W 128), 4 slots, max_len 512, 2 VQA + 2 text
     requests, 64 new tokens each, first on `LocalBackend` (the oracle):
     every pool leaf against its `cache_shardings` local shape, token
     streams identical to the local ones, exact launches, one decode
     step's launches and collectives (by kind and per layer, from
     `repro_torch.sharding`'s counter), the NCCL kernels' device time in
     a profiled window of 4 decode steps, decode p50 / p95 beside the
     local run's, peak memory. The kernel phase holds the sharded
     executor's 2- and 4-way shard shapes (fastvlm-1.7b, stablelm-12b)
     against their twins too.
 10. sharded-train — training through the mesh: `launch.train.run` (the
     train CLI's mesh function) on `get_mesh("1x1")` over NCCL at world
     size 1, fastvlm-1.7b f32 (TF32 off) at full width and depth, 3
     steps of 8 x 256 VQA rows from seed 0 with the CLI's AdamW at
     --steps 3, after the same 3 steps through the local
     `make_train_step` on the same init and batches: a step's loss and
     grad norm against the local one's (<= 1e-5 relative), exact
     launches (57 / 28 / 28 / 28 a step), the collectives a step by
     kind, the NCCL kernels' device time in a profiled step, step p50
     and peak memory beside the local run's; then at a 2-layer cut
     (B 2 x S 128, deterministic algorithms) every parameter leaf after
     2 steps of the placed step against the local step's (<= 1e-4 of
     the leaf's largest element; `torch.equal` printed). The loop keeps
     no checkpoint (the CPU suite checks mesh checkpoints).
 11. dryrun — the analytic walk (`launch.hlo_analysis`: the step run once
     on meta tensors under a dispatch mode) of the train phase's step
     and of the sharded-train phase's (on an abstract 1 x 1 mesh),
     building no model: the walk's argument bytes equal the bytes of
     the params, mu, nu, step and batch the card held, and its
     collective counts and bytes by kind equal what the live wrappers
     counted in a step (exact); printed: FLOPs, the kernel Functions'
     recompute FLOPs and 6 N T, temp + argument bytes against the card's
     peak allocation, the walk's bound beside the measured step p50.
     Then the three examples on the card at their reduced sizes
     (examples/quickstart_torch.py, serve_vlm_torch.py with its own
     checks, train_lm_torch.py --steps 20), and the dry run of
     granite-3-2b @ decode_32k on the 16 x 16 mesh on the host
     (`launch.dryrun.run_cell`): its roofline line and seconds.
  Decode profiles cover 4 steady steps.
  Every dense, MoE and recurrent bf16 run prints its decode busy beside
  the weight floor: every weight read once a step (the embedding table
  left out unless it is the tied head; a shared block once an
  application).

It prints the card (name, power limit), the kernel build time, the
phases' results, then one JSON line {"kernels": [...]} (launches summed
over every serving run, the train phase's six steps and the
sharded-train run's three; host_ms is call ms minus device ms) and,
last, the device JSON line. It fails
(non-zero exit, no result lines) without a card, outside the repository,
or when any check fails. `--phases` selects a subset (e.g. `--phases
kernels` for a quick compile check; `--phases kernels,deepseek` for the
kernels and only the deepseek-v2-lite parity and serving runs;
`--phases kernels,stablelm,starcoder2,paligemma` for the kernels and
the dense archs' runs; `--phases kernels,rwkv6,zamba2` for the
recurrent archs'; `--phases kernels,hubert,llama4` for the full-sequence
forward's; `--phases kernels,train` for training; `--phases
sharded-train` for training through the mesh; `--phases
train,sharded-train,dryrun` for the analytic walks against them;
`--phases deepseek-full` for deepseek-v2-lite's f32 parity at full
depth (27 layers, not a default phase; it runs after every other
phase).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# fastvlm-1.7b serving shapes
D_MODEL, D_FF, HEADS, KV_HEADS, HEAD_DIM = 1536, 8960, 12, 2, 128
# mobilevlm-3b serving shapes (MHA: G = 1)
D3, F3, H3 = 2560, 6912, 20
# a prefix hit's tail prefill: 33-64 question tokens after a 256-token
# shared head, padded to the 64-row admission bucket (attn_stream S = 64
# at q_offset 256, the FFN, projections and norms at M = 64)
HIT_TAIL = 64
# deepseek-v2-lite: d_model and its dense first layer's d_ff (F / 128 =
# 85.5: the stream form's last slice is ragged); the f32 parity run cuts
# the depth to 1 dense + 5 MoE layers, for the script's time (full depth,
# 62.8 GB of f32 weights, is the phase deepseek-full)
DS_D, DS_F, DS_PARITY_LAYERS = 2048, 10944, 6
# stablelm-12b's d_model: the widest the FFN kernels take on this path
DENSE_D = 5120
# rwkv6-7b's d_model (LayerNorm + bias); zamba2-1.2b's shared attention
# block: d_model 2048, 32 heads of 64 (G 1), gelu_gated F 8192
SSM_D = 4096
ZAMBA_D, ZAMBA_H, ZAMBA_DH, ZAMBA_F = 2048, 32, 64, 8192
# hubert-xlarge: d_model 1280, gelu F 5120; its input, 4 clips of 10 s of
# 16 kHz audio at 20 ms frames (M 2000 rows: ragged for every tile)
HUBERT_D, HUBERT_F, HUBERT_CLIPS, HUBERT_FRAMES = 1280, 5120, 4, 500
# llama4-maverick-400b: d_model 5120, 40 / 8 heads of 128 (G 5)
LLAMA_D, LLAMA_H, LLAMA_HKV = 5120, 40, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

REPLACES = {
    "fused_norm": "src/repro/kernels/fused_norm.py:35",
    "attn_stream": "src/repro/kernels/attn_stream.py:90",
    "ffn_act": "src/repro/kernels/ffn_act.py:71",
    "ffn_act_int8": "src/repro/kernels/ffn_act.py:148",
    "qkv_proj": "src/repro/kernels/qkv_proj.py:36",
    "paged_decode_tiered": "src/repro/kernels/paged_decode.py:147",
    "paged_decode_flat": "src/repro/kernels/paged_decode.py:267",
}
SOURCES = {
    "fused_norm": "src/repro_torch/kernels/csrc/fused_norm.cu",
    "attn_stream": "src/repro_torch/kernels/csrc/attn_stream.cu",
    "ffn_act": "src/repro_torch/kernels/csrc/ffn_act.cu",
    "ffn_act_int8": "src/repro_torch/kernels/csrc/ffn_act_int8.cu",
    "qkv_proj": "src/repro_torch/kernels/csrc/qkv_proj.cu",
    "paged_decode_tiered": "src/repro_torch/kernels/csrc/paged_decode.cu",
    "paged_decode_flat": "src/repro_torch/kernels/csrc/paged_decode.cu",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets); "tf32" is
    the TF32 tensor cores' rate, and "tf32x3" the f32 work it does in
    the 3xTF32 split (three TF32 products a product)."""
    if "PCIe" in name:
        pk = {"bw": 2.0e12, "bfloat16": 756e12, "float32": 51e12,
              "tf32": 378e12}
    elif "NVL" in name:
        pk = {"bw": 3.9e12, "bfloat16": 835e12, "float32": 60e12,
              "tf32": 417.5e12}
    else:  # SXM
        pk = {"bw": 3.35e12, "bfloat16": 989e12, "float32": 67e12,
              "tf32": 495e12}
    return dict(pk, tf32x3=pk["tf32"] / 3)


def bound(pk: dict, nbytes: float, flops: float, dtype: str):
    t_b, t_f = nbytes / pk["bw"], flops / pk[dtype]
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of one call, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


# `device_ms` windows by outcome: device events recorded, or none at all.
# Across three full runs on the H100 the profiler lost the first device
# events of a window whatever their time (a lead-in spin kernel of 5 to
# 80 ms, or the first norm and projection of a profiled step after a
# 0.5 ms spin) and, late in a run, every event of a short window; a
# warm-up step on the profiler's schedule neither stopped the first loss
# nor kept the per-call times (3-5x the CUDA-event times), so windows
# open plainly, with spins at both ends, and a lost window is read again
# (ROADMAP Queue 3).
DROPPED = {"measured": 0, "empty": 0}


def _name(fn) -> str:
    """A short name of a timed callable (never a tensor's repr)."""
    fn = getattr(fn, "func", fn)
    return getattr(fn, "__qualname__", type(fn).__name__)


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one call: the summed time of the device events
    (kernels, copies) that ``reps`` calls launch, per call, from
    torch.profiler — the wrapper's host time excluded. The calls sit
    between two spin kernels (`lead_in`, `lead_out`; left out of the
    sum), which take the profiler's loss of a window's first events. A
    window that recorded no device event is read again, up to ``tries``
    windows (counted in DROPPED); after that the time is None (not
    measured), never 0."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with device_profile() as prof:
            lead_in()
            for _ in range(reps):
                fn()
            lead_out()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and "spin_kernel" not in e.key]
        if evs:
            DROPPED["measured"] += 1
            return sum(e.self_device_time_total for e in evs) / 1e3 / reps
        DROPPED["empty"] += 1
        print(f"[time] a profiled window of {_name(fn)} recorded no device "
              f"event; windows so far {DROPPED}")
    print(f"[time] the profiler recorded no device event of {_name(fn)} "
          f"in {tries} windows: its device time is not measured")
    return None


def us(ms, digits: int = 2, unit: str = "us") -> str:
    """A device time in ms, printed in ``unit`` (us or ms), or "not
    measured" where it is None."""
    if ms is None:
        return "not measured"
    return f"{(1e3 if unit == 'us' else 1) * ms:.{digits}f} {unit}"


def event_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call from CUDA events: ``n`` calls enqueued
    behind a `torch.cuda._sleep` of ~5 ms, so the host has queued them all
    before the first runs and the events bracket the kernels back to back
    (launch gaps on the card included, the host's excluded); the median
    of ``reps`` such runs, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda._sleep(10_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / n)
    return statistics.median(ts)


def device_kernels(fn, reps: int = 10) -> dict:
    """Device kernels (and copies) one call of ``fn`` launches, by name,
    from torch.profiler: how many kernels a library call is."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        lead_in()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.count / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and "spin_kernel" not in e.key}


def require(cond, msg) -> None:
    """A check of this script; unlike ``assert`` it survives ``-O``."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# the 3xTF32 split's bound on one term of a sum, relative to |a b|
# (csrc/tf32x3.cuh): sum_k a_k b_k moves by <= TF32X3_TERM sum_k |a_k b_k|
TF32X3_TERM = 3 * 2.0 ** -22


def tf32x3_qkv_bound(x, ws) -> float:
    """The split's bound on the tf32x3 projection's largest error:
    TF32X3_TERM max sum_d |x_md w_dn| over the three weights (the f32
    accumulation error, which the twin's sum has as well, left out)."""
    return TF32X3_TERM * max(float((x.abs() @ w.abs()).max()) for w in ws)


def tf32x3_ffn_bound(x, wu, wg, wd, kind) -> float:
    """The split's bound on the tf32x3 FFN's largest error: phase 1's
    errors (TF32X3_TERM sum_d |x w| in u and g) carried through act (its
    slope: |silu'| <= 1.1, |gelu'| <= 1.13, relu2's 2|u|) and the gate
    into h, times |W_down|, plus phase 2's own TF32X3_TERM sum_f |h w|
    (f32 accumulation's error left out, as for the projection)."""
    from repro_torch.kernels import ffn_act as FF
    u = x @ wu
    du = TF32X3_TERM * (x.abs() @ wu.abs())
    slope = 2 * u.abs() if kind == "relu2" else 1.13
    a = FF.activation(u, kind)
    if wg is None:
        h, dh = a, slope * du
    else:
        g = x @ wg
        dg = TF32X3_TERM * (x.abs() @ wg.abs())
        h, dh = a * g, slope * du * g.abs() + a.abs() * dg
    return float((dh @ wd.abs() + TF32X3_TERM * (h.abs() @ wd.abs())).max())


def tf32x3_attn_bound(q, k, v, causal: bool = True) -> float:
    """The bound on the tf32x3 attention's largest error against exact
    math (csrc/attn_stream.cu), q (B, H, S, D), k / v (B, Hkv, L, D): a
    score moves by at most delta = (TF32X3_TERM + 3 (D / 8) 2^-23) scale
    sum_d |q_d k_d| (the split and the tensor cores' truncating adds
    over D), which moves each softmax weight pi_j by at most
    (e^(2 max delta) - 1) pi_j; the P.V product adds its split, its
    truncating adds inside a key tile (3 BK / 8 of 2^-23), exp2f's 2 ulp
    in P and in the sum of P, and the f32 rescale and add of each tile
    and the final division ((2 tiles + 5) 2^-24); all times sum_j pi_j
    |v_jd|, the largest over rows and features."""
    import torch

    from repro_torch.kernels import attn_stream as AS
    B, H, S, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    G, scale = H // Hkv, D ** -0.5
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    live = torch.ones(S, L, dtype=torch.bool, device=q.device)
    if causal:
        live = (torch.arange(L, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (L - S))
    mag = torch.einsum("bkgsd,bkld->bkgsl", qf.abs(), kf.abs()) * scale
    delta = (TF32X3_TERM + 3 * (D // 8) * 2.0 ** -23) * torch.where(
        live, mag, 0.0).amax(-1)
    del mag
    pi = torch.softmax(torch.where(
        live, torch.einsum("bkgsd,bkld->bkgsl", qf, kf) * scale,
        AS.NEG_INF), -1)
    pv = torch.einsum("bkgsl,bkld->bkgsd", pi, vf.abs())
    bk = AS.tf32x3_bk(D)
    c = (TF32X3_TERM + 3 * (bk // 8) * 2.0 ** -23 + 4 * 2.0 ** -22
         + (2 * -(-L // bk) + 5) * 2.0 ** -24)
    return float(((torch.expm1(2 * delta) + c)[..., None] * pv).max())


# what the SASS of each library must hold: the bf16 tensor-core kernels
# warpgroup MMAs (HGMMA) over shared-memory tiles filled by cp.async
# (LDGSTS; the FFN's stream form fills its ring with it too); the paged
# decode library's two split-K kernels their cp.async key rings, and the
# f32 3xTF32 GEMMs and attention TF32 warpgroup MMAs (HGMMA ... .TF32)
# over cp.async rings, counted in every instance of each kernel function
SASS_NEEDS = {"attn_stream": ("HGMMA", "LDGSTS"),
              "qkv_proj": ("HGMMA", "LDGSTS"),
              "ffn_act": ("HGMMA", "LDGSTS"),
              "ffn_act_int8": ("HGMMA", "LDGSTS"),
              "paged_decode": ("LDGSTS",)}
TF32_NEEDS = ("HGMMA", "LDGSTS", "TF32")
SASS_PER_FUNCTION = {
    "paged_decode": {"paged_decode_tiered_kernel": ("LDGSTS",),
                     "paged_decode_flat_kernel": ("LDGSTS",)},
    "ffn_act": {"ffn_up_tf32_kernel": TF32_NEEDS,
                "ffn_down_tf32_kernel": TF32_NEEDS},
    "qkv_proj": {"qkv_tf32_kernel": TF32_NEEDS},
    "attn_stream": {"attn_tf32_kernel": TF32_NEEDS}}


def sass_functions(sass: str) -> dict:
    """cuobjdump -sass text -> {kernel function (mangled): its SASS}."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def sass_count(sass: str, op: str) -> int:
    """Instructions of kind ``op`` in SASS text; "TF32" counts the HGMMA
    instructions with TF32 operands."""
    if op == "TF32":
        return sum(1 for line in sass.splitlines()
                   if "HGMMA" in line and "TF32" in line)
    return sass.count(op)


def sass_check() -> dict:
    """Count HGMMA and LDGSTS instructions in the built libraries of
    SASS_NEEDS with cuobjdump (beside nvcc) and require what each
    needs; for SASS_PER_FUNCTION also what each named kernel function
    needs, in every instance of it."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for name, needs in SASS_NEEDS.items():
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        out[name] = {"HGMMA": sass.count("HGMMA"),
                     "LDGSTS": sass.count("LDGSTS")}
        print(f"[sass] {name}: {out[name]['HGMMA']} HGMMA, "
              f"{out[name]['LDGSTS']} LDGSTS instructions")
        for op in needs:
            require(out[name][op] > 0,
                    f"{name}: no {op} instruction in the built library")
        funcs = sass_functions(sass)
        for kern, ops in SASS_PER_FUNCTION.get(name, {}).items():
            bodies = [f for k, f in funcs.items() if kern in k]
            out[name][kern] = {"instances": len(bodies)}
            for op in ops:
                counts = [sass_count(f, op) for f in bodies]
                out[name][kern].update({f"{op}_min": min(counts, default=0),
                                        f"{op}_max": max(counts,
                                                         default=0)})
                print(f"[sass]   {kern}: {len(counts)} instances, {op} "
                      f"{min(counts, default=0)}-{max(counts, default=0)} "
                      f"each")
                require(counts and min(counts) > 0,
                        f"{name}: an instance of {kern} has no {op}")
    return out


def tile_banner(dev: str = "cuda") -> dict:
    """Print the bf16 tensor-core kernels' and the paged decodes' tiles and
    planned splits from their Python mirrors (the constants the CPU tests check
    against Hopper's shared memory) and, on the card, hold each mirrored
    shared-memory size against the one the built library reports, so a
    drift between the two shows."""
    import ctypes

    import torch

    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import build
    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import qkv_proj as QK

    # the FFN's mirrors: the stream form at its row counts, both models'
    # widths and every D split; the GEMM phases at both warpgroup counts,
    # per weight size (2: bf16, 1: int8)
    stream_at = [(m, d, ds) for m in (1, 4, 8)
                 for d in (D_MODEL, D3, DENSE_D) for ds in (1, 2, 4, 8)]
    ffn_stream = {f"w{es} M{m} D{d} ds{ds}":
                  FF.stream_smem_bytes(m, d, ds, es == 1)
                  for es in (2, 1) for (m, d, ds) in stream_at}
    ffn_tc = {f"w{es} phase{ph} wgs{w}": FF.wgmma_smem_bytes(ph, es, w)
              for es in (2, 1) for ph in (1, 2) for w in (1, 2)}
    # the tiered decode's instances (table entries, dtype code, head dim,
    # G): every dtype, head dim and G form (up to 8 at Dh 256) at 4 pages,
    # 1 and 5 pages at fastvlm-1.7b's (bf16, 128, G 6 -> 8)
    tiered_at = {f"{n}p {dt} D{hd} G{g}": (n, code, hd, g)
                 for (code, dt) in ((0, "float32"), (1, "bfloat16"))
                 for hd in PD.HEAD_DIMS for g in (1, 2, 4, 8, 16)
                 if g <= PD.max_group(hd)
                 for n in ((1, 4, 5) if (dt, hd, g) == ("bfloat16", 128, 8)
                           else (4,))}
    tiles = {"ffn_act": {
                 "stream_threads": FF.STREAM_THREADS,
                 "stream_slice": FF.STREAM_SLICE,
                 "stream_stages": FF.STREAM_STAGES,
                 "stream_stage_bytes": [FF.STREAM_STAGE_BYTES,
                                        FF.STREAM_INT8_STAGE_BYTES],
                 "stream_max_m": FF.STREAM_MAX_M,
                 "stream_plans (ds, cluster, blocks)": {
                     f"F{f}": FF.stream_plan(f, 132) for f in (D_FF, F3)},
                 "wgmma_plans (wgs, ks, k_chunk)": {
                     f"M{m} D{d} F{f}": FF.wgmma_plan(m, d, f, 132)
                     for (m, d, f) in ((320, D_MODEL, D_FF),
                                       (256, D3, F3))},
                 "wgmma_tile": [128, FF.WGMMA_BN, FF.WGMMA_BK],
                 "wgmma_stages": {f"w{es} phase{ph} wgs{w}": FF.wgmma_stages(
                     es, 64 * w, 3 - ph)[0] for es in (2, 1)
                     for ph in (1, 2) for w in (1, 2)},
                 "stream_smem": ffn_stream, "wgmma_smem": ffn_tc,
                 "tf32x3_tile": [FF.TF32_BM, FF.TF32_BN, FF.TF32_BK],
                 "tf32x3_min_m": FF.TF32X3_MIN_M,
                 "tf32x3_stages": FF.tf32x3_stages()[0],
                 "tf32x3_flush_tiles": FF.TF32_FLUSH,
                 "tf32x3_smem": FF.tf32x3_smem_bytes(),
                 "tf32x3_plans (ks, k_chunk)": {
                     f"M{m} D{d} F{f}": FF.tf32x3_plan(m, d, f, 132)[:2]
                     for (m, d, f) in ((2048, D_MODEL, D_FF),
                                       (320, D_MODEL, D_FF))}},
             "attn_stream": {
                 "BQ": AS.WGMMA_BQ, "BK": AS.WGMMA_BK,
                 "stages": AS.WGMMA_STAGES,
                 "smem": {hd: AS.wgmma_smem_bytes(hd)
                          for hd in AS.HEAD_DIMS},
                 "tf32x3_BQ": AS.TF32X3_BQ,
                 "tf32x3_warpgroups": AS.TF32X3_WGS,
                 "tf32x3_BK": {hd: AS.tf32x3_bk(hd)
                               for hd in AS.TF32X3_HEAD_DIMS},
                 "tf32x3_smem": {hd: AS.tf32x3_smem_bytes(hd)
                                 for hd in AS.TF32X3_HEAD_DIMS}},
             "qkv_proj": {
                 "BM": [64, 128], "BN": QK.WGMMA_BN, "BK": QK.WGMMA_BK,
                 "stages": [QK.wgmma_stages(w) for w in (1, 2)],
                 "smem": [QK.wgmma_smem_bytes(w) for w in (1, 2)],
                 "gemv_threads": QK.GEMV_THREADS,
                 "gemv_blocks_per_sm": QK.GEMV_BLOCKS_PER_SM,
                 "gemv_max_split": QK.GEMV_MAX_SPLIT,
                 "tf32x3_min_m": QK.TF32X3_MIN_M,
                 "tf32x3_smem": QK.tf32x3_smem_bytes()},
             "paged_decode_flat": {
                 "warps": PD.FLAT_WARPS, "stages": PD.FLAT_STAGES,
                 "stage_bytes": PD.FLAT_STAGE_BYTES,
                 "max_split": PD.FLAT_MAX_SPLIT,
                 "tile_keys (bf16, f32) by Dh": {
                     hd: [PD.flat_tile_keys(hd, t) for t in
                          (torch.bfloat16, torch.float32)]
                     for hd in PD.HEAD_DIMS},
                 "smem": {n: PD.flat_smem_bytes(n) for n in (1, 4, 5)},
                 "splits (B, Hkv)": {f"{b} {h}": PD.flat_split(b, h, 132)
                                     for (b, h) in ((4, 20), (8, 20))}},
             "paged_decode_tiered": {
                 "features_a_lane": PD.TIERED_FEATURES,
                 "tile_keys (bf16 G 1, bf16 G >= 2, f32) by Dh": {
                     hd: [PD.tiered_tile_keys(hd, torch.bfloat16),
                          PD.tiered_tile_keys(hd, torch.bfloat16, 2),
                          PD.tiered_tile_keys(hd, torch.float32)]
                     for hd in PD.HEAD_DIMS},
                 "smem": {k: PD.tiered_smem_bytes(
                     n, hd, g, torch.float32 if code == 0 else torch.bfloat16)
                     for k, (n, code, hd, g) in tiered_at.items()},
                 "splits (B, Hkv, sparse)": {
                     f"{b} {h} {sp}": PD.tiered_split(b, h, 132, sp)
                     for (b, h) in ((4, 2), (4, 20), (8, 20))
                     for sp in (False, True)}}}
    print(f"[kernels] tiles {json.dumps(tiles)}")
    if dev != "cuda":
        return tiles
    la, lq = build.load("attn_stream"), build.load("qkv_proj")
    lp = build.load("paged_decode")
    for fn in (la.attn_stream_smem_bytes, la.attn_stream_tf32_smem_bytes,
               lq.qkv_proj_smem_bytes, lp.paged_decode_flat_smem_bytes):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for fn in (lp.paged_decode_tiered_smem_bytes,
               lp.paged_decode_tiered_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    for n, want in tiles["paged_decode_flat"]["smem"].items():
        got = lp.paged_decode_flat_smem_bytes(n)
        require(got == want, f"paged_decode_flat smem at {n} pages: library "
                             f"{got}, mirror {want}")
    occupancy = {}
    for k, args in tiered_at.items():
        got = lp.paged_decode_tiered_smem_bytes(*args)
        want = tiles["paged_decode_tiered"]["smem"][k]
        require(got == want, f"paged_decode_tiered smem at {k}: library "
                             f"{got}, mirror {want}")
        if args[0] == 4:
            occupancy[k[3:]] = lp.paged_decode_tiered_blocks_per_sm(*args)
    # the planner's grid target (FLAT_BLOCKS_PER_SM blocks an SM) has to
    # be resident at once: registers, static and dynamic shared memory
    print(f"[kernels] paged_decode_tiered blocks an SM holds at 4 pages: "
          f"{json.dumps(occupancy)}")
    tiles["paged_decode_tiered"]["blocks_per_sm"] = occupancy
    low = {k: v for k, v in occupancy.items() if v < PD.FLAT_BLOCKS_PER_SM}
    require(not low, f"paged_decode_tiered instances below the planner's "
                     f"{PD.FLAT_BLOCKS_PER_SM} blocks an SM: {low}")
    for hd, want in tiles["attn_stream"]["smem"].items():
        got = la.attn_stream_smem_bytes(hd)
        require(got == want, f"attn_stream smem at Dh {hd}: library {got}, "
                             f"mirror {want}")
    for hd in AS.HEAD_DIMS:
        got = la.attn_stream_tf32_smem_bytes(hd)
        want = tiles["attn_stream"]["tf32x3_smem"].get(hd, 0)
        require(got == want, f"attn_stream tf32x3 smem at Dh {hd}: library "
                             f"{got}, mirror {want}")
    for wgs in (1, 2):
        got, want = lq.qkv_proj_smem_bytes(10 + wgs), QK.wgmma_smem_bytes(wgs)
        require(got == want, f"qkv_proj GEMM smem at {wgs} warpgroups: "
                             f"library {got}, mirror {want}")
    got, want = lq.qkv_proj_smem_bytes(21), QK.tf32x3_smem_bytes()
    require(got == want, f"qkv_proj tf32x3 GEMM smem: library {got}, "
                         f"mirror {want}")
    for code, dt in ((1, "float32"), (2, "bfloat16")):
        want = QK.gemv_smem_bytes(0, 0, getattr(torch, dt))
        require(lq.qkv_proj_smem_bytes(code) == want,
                f"qkv_proj GEMV {dt} static smem: library "
                f"{lq.qkv_proj_smem_bytes(code)}, mirror {want}")
    for lib_name in ("ffn_act", "ffn_act_int8"):
        lf = build.load(lib_name)
        lf.ffn_smem_bytes.argtypes = [ctypes.c_int] * 4
        lf.ffn_smem_bytes.restype = ctypes.c_int
        es = 2 if lib_name == "ffn_act" else 1
        for (m, d, ds) in stream_at:
            got = lf.ffn_smem_bytes(0, m, d, ds)
            want = ffn_stream[f"w{es} M{m} D{d} ds{ds}"]
            require(got == want, f"{lib_name} stream smem at M {m} D {d} "
                                 f"D split {ds}: library {got}, mirror "
                                 f"{want}")
        for ph in (1, 2):
            for w in (1, 2):
                got = lf.ffn_smem_bytes(ph, w, 0, 0)
                want = ffn_tc[f"w{es} phase{ph} wgs{w}"]
                require(got == want, f"{lib_name} phase-{ph} smem at wgs "
                                     f"{w}: library {got}, mirror {want}")
        if lib_name == "ffn_act":
            got, want = lf.ffn_smem_bytes(3, 0, 0, 0), FF.tf32x3_smem_bytes()
            require(got == want, f"ffn_act tf32x3 smem: library {got}, "
                                 f"mirror {want}")
            for (m, d, f) in ((TRAIN_B * TRAIN_S, D_MODEL, D_FF),
                              (77, 320, 1000)):
                got = lf.ffn_smem_bytes(5, m, d, f)
                want = FF.tf32x3_scratch(m, d, f, True)
                require(got == want, f"ffn_act tf32x3 workspace at M {m} D "
                                     f"{d} F {f}: library {got} floats, "
                                     f"mirror {want}")
    print("[kernels] tile mirrors match the built libraries")
    return tiles


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain twins
# ---------------------------------------------------------------------------
def kernel_phase(pk: dict, dev: str = "cuda", timer=time_ms,
                 dev_timer=device_ms, lib_kernels=device_kernels,
                 ev_timer=event_ms) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.core import kv_tiers as KT
    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import build
    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import qkv_proj as QK

    tiles = tile_banner(dev)
    dev = torch.device(dev)
    sms = build.sm_count(0) if dev.type == "cuda" else 132
    time_ms, dev_ms = timer, dev_timer
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results: dict[str, dict] = {"tiles": tiles, "extra_rows": []}
    cases: dict[str, list] = {k: [] for k in REPLACES}

    def timed(fn, reps=25):
        """(call ms, device ms) of ``fn``: CUDA events around the call,
        and the profiler's device time of what it launches."""
        return time_ms(fn, reps=reps), dev_ms(fn)

    def record(name, label, dtype, err, main=None, extra=None, rel=None):
        """One case: ``err`` (max-abs) is held to the dtype's limit, or,
        where ``rel`` is given (the paged decodes), ``rel`` is."""
        tol = TOL[dtype]
        ok = (err if rel is None else rel) <= tol
        cases[name].append({"case": label, "dtype": dtype,
                            "max_abs_err": err, "tol": tol, "ok": ok,
                            **({} if rel is None else {"rel_err": rel}),
                            **(extra or {})})
        more = "".join(f" {k}={v:.3e}" for k, v in (extra or {}).items())
        held = (f"(tol {tol:g})" if rel is None
                else f"rel {rel:.3e} (tol {tol:g} rel)")
        print(f"[kernels] {name:20s} {label:34s} {dtype:8s} "
              f"max|err|={err:.3e} {held}{more} {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {label} {dtype}: {err if rel is None else rel} "
                    f"> {tol}")
        if main is not None:
            results[name] = dict(main, max_abs_err=err, dtype=dtype)

    def decode_errs(got, want):
        """(max-abs error, error relative to each (slot, kv head)'s largest
        output) of a paged decode. Its outputs are softmax means of V
        rows, small (1e-2 to 1 here) and far apart from slot to slot, so
        each (slot, kv head) is held to the limit times its own largest
        output; one with no attendable key must give exactly 0."""
        e = (got.float() - want.float()).abs().flatten(2).amax(-1)
        w = want.float().abs().flatten(2).amax(-1)
        return float(e.max()), float((e / w.clamp_min(1e-30)).max())

    def norm_row(x, sc, es):
        """The bf16 rms fused_norm's times beside its twin and F.rms_norm
        (call and device time, and the kernels that call launches)."""
        M, D_ = x.shape
        ms, dms = timed(lambda: FN.fused_norm(x, sc, None, "rms"))
        lib = lib_dev = lib_k = None
        if hasattr(F, "rms_norm"):
            def call():
                return F.rms_norm(x, (D_,), sc, 1e-6)
            lib, lib_dev = timed(call)
            lib_k = lib_kernels(call)
        b_ms, b_by = bound(pk, (2 * M * D_ + D_) * es, 0, "bfloat16")
        return {"shape": f"x ({M}, {D_}) rms", "ms": ms, "device_ms": dms,
                "plain_ms": time_ms(lambda: FN.fused_norm_plain(
                    x, sc, None, "rms")),
                "library_ms": lib, "library_device_ms": lib_dev,
                "library_kernels": lib_k, "bound_ms": b_ms,
                "bound_by": b_by}

    results["ffn_rows"] = []

    def ffn_case(name, x, w, kind, dt, label, want_variant, row=None,
                 is_main=False):
        """One FFN case: ``name`` on x and its weight operands ``w``
        against its plain twin, the form that ran asserted. A stream case
        also records the bound of its 16-bit rounding of h, u * max_md
        sum_f |h_mf w_fd| (u = 2^-9 for bf16 h, 2^-11 for the fp16 h of
        int8 weights). With ``row`` = (weight bytes, chain) in bf16 also
        its times beside its bound and, as a yardstick only, the device
        time of ``chain``, the cuBLAS chain mm, mm, silu * mul, mm on the
        same (int8: pre-dequantized bf16) weights."""
        kern, twin = getattr(FF, name), getattr(FF, f"{name}_plain")

        def fn():
            return kern(x, *w, kind)

        def ref():
            return twin(x, *w, kind)
        err = max_err(fn(), ref())
        got = kern.variant
        require(got == want_variant, f"{name} {label} {dt}: ran the {got} "
                                     f"form, expected {want_variant}")
        extra = None
        if got == "stream":
            int8 = name == "ffn_act_int8"
            wu, wg, wd = ([None if w[i] is None else
                           FF.dequantize(w[i], w[i + 1]) for i in (0, 2, 4)]
                          if int8 else [None if t is None else t.float()
                                        for t in w])
            h = FF.activation(x.float() @ wu, kind)
            if wg is not None:
                h = h * (x.float() @ wg)
            extra = {"h_round_bound": 2.0 ** (-11 if int8 else -9) * float(
                (h.abs() @ wd.abs()).max())}
        elif got == "tf32x3":
            extra = {"split_bound": tf32x3_ffn_bound(x, *w, kind)}
        main = None
        if row is not None:
            (M, D_), F_ = x.shape, w[0].shape[1]
            w_bytes, chain = row
            ms, dms = timed(fn)
            c_ms, c_dms = timed(chain)
            c_k = lib_kernels(chain)
            gated = w[2 if name == "ffn_act_int8" else 1] is not None
            chain_ops = ("mm, mm, act * mul, mm" if gated
                         else "mm, act, mm")
            b_ms, b_by = bound(pk, 4 * M * D_ + w_bytes,
                               (6 if gated else 4) * M * D_ * F_,
                               "bfloat16")
            main = {"shape": f"x ({M}, {D_}), F {F_}, {label}", "ms": ms,
                    "device_ms": dms, "plain_ms": time_ms(ref),
                    "library_ms": None, "variant": got,
                    "chain_ms": c_ms, "chain_device_ms": c_dms,
                    "chain_kernels": c_k,
                    "chain": f"cuBLAS chain of {round(sum(c_k.values()))} "
                             f"kernels ({chain_ops}), not one call",
                    "bound_ms": b_ms, "bound_by": b_by}
            results["ffn_rows"].append(dict(main, name=name,
                                            max_abs_err=err, **(extra or {})))
            print(f"[kernels]   {name} {main['shape']} ({got}): "
                  f"{us(dms)} device, {ms:.4f} ms call; "
                  f"{main['chain']} {us(c_dms)} device; bound "
                  f"{1e3 * b_ms:.2f} us ({b_by})")
        record(name, f"{label} ({got})", dt, err, main if is_main else None,
               extra)

    def ffn_form(M, dt, int8=False):
        """The FFN form expected for M rows of ``dt`` x, rows aligned; f32
        x with int8 weights (``int8``) keeps the fma form."""
        if dt == "float32":
            return "tf32x3" if M >= FF.TF32X3_MIN_M and not int8 else "fma"
        return "stream" if M <= FF.STREAM_MAX_M else "wgmma"

    def qkv_form(M, bf):
        """The qkv_proj form expected for M aligned rows."""
        if M <= QK.GEMV_MAX_M:
            return "gemv"
        if bf:
            return "wgmma"
        return "tf32x3" if M >= QK.TF32X3_MIN_M else "fma"

    def attn_form(dt, Dh):
        """The attn_stream form expected for ``dt`` at head dim Dh."""
        if dt == "bfloat16":
            return "wgmma"
        return "tf32x3" if Dh in AS.TF32X3_HEAD_DIMS else "fma"

    def attn_case(label, dt, q, k, v, got=None, causal=True, main=None):
        """One attn_stream case, q (B, H, S, D) and k / v (B, Hkv, L, D):
        the kernel's output (``got``, else a call on these views) against
        the plain twin, the form that ran asserted; a tf32x3 case also
        records the bound of its 3xTF32 split and is held to it."""
        if got is None:
            got = AS.attn_stream(q, k, v, causal=causal)
        err = max_err(got, AS.attn_stream_plain(q, k, v, causal))
        form = attn_form(dt, q.shape[3])
        require(dev.type != "cuda" or AS.attn_stream.variant == form,
                f"attn_stream {label} {dt}: ran the "
                f"{AS.attn_stream.variant} form, expected {form}")
        extra = None
        if form == "tf32x3":
            extra = {"split_bound": tf32x3_attn_bound(q, k, v, causal)}
            require(err <= extra["split_bound"],
                    f"attn_stream {label}: {err} past its 3xTF32 bound "
                    f"{extra['split_bound']}")
        record("attn_stream", f"{label} ({form})", dt, err, main, extra)

    def chain_of(x, wu, wg, wd, kind="silu_gated"):
        def call():
            return (FF.activation(x @ wu, kind) * (x @ wg)) @ wd
        return call

    def int8_ffn(D, F_, gated):
        def q8(*shape):
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        su = (0.5 + torch.rand(F_, generator=gen, device=dev)) / (
            127 * D ** 0.5)
        sd = (0.5 + torch.rand(D, generator=gen, device=dev)) / (
            127 * F_ ** 0.5)
        return (q8(D, F_), su, q8(D, F_) if gated else None,
                su.flip(0).contiguous() if gated else None, q8(F_, D), sd)

    def sdpa_of(q, k, v, mask=None):
        """SDPA over grouped K/V (causal, or under a boolean ``mask``): the
        library yardstick beside attn_stream and the flat decode."""
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    def extra_row(name, shape, fn, plain, lib, nbytes, flops, dt,
                  ev=False):
        """A timed bf16 row at one of the dense archs' shapes: the
        kernel's call and device time (and CUDA-event device time where
        ``ev``), its twin's, the library call's (``lib``, or None) and
        the bound of ``nbytes`` / ``flops``."""
        ms, dms = timed(fn)
        b_ms, b_by = bound(pk, nbytes, flops, dt)
        lib_ms = lib_dev = lib_k = None
        if lib is not None:
            lib_ms, lib_dev = timed(lib)
            lib_k = lib_kernels(lib)
        row = {"name": name, "shape": shape, "ms": ms, "device_ms": dms,
               "event_ms": ev_timer(fn) if ev else None,
               "plain_ms": time_ms(plain), "library_ms": lib_ms,
               "library_device_ms": lib_dev, "library_kernels": lib_k,
               "bound_ms": b_ms, "bound_by": b_by}
        results["extra_rows"].append(row)
        print(f"[kernels]   {name} {shape}: {us(dms)} device, "
              f"{ms:.4f} ms call; plain {row['plain_ms']:.3f} ms; library "
              f"{'-' if lib is None else us(lib_dev)} "
              f"device; bound {1e3 * b_ms:.2f} us ({b_by})")
        return row

    def dense_widths(dt):
        """Every kernel of the stablelm-12b, starcoder2-7b and
        paligemma-3b paths at their serving shapes (4 slots, 256-token
        prompts; paligemma's VQA prompt 256 image + 64 text), in ``dt``
        against its plain twin, the form that ran asserted; bf16 rows
        timed beside their bound and the library call. The widened
        kernels: attn_stream at Dh 160 / 256, the paged decodes at Dh
        160 / 256 and G 4 / 8 / 9, ffn_act at d_model 5120; fused_norm
        and qkv_proj held at the new widths."""
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        bf = dt == "bfloat16"
        # ---- fused_norm: LayerNorm + bias at 5120 / 4608, rms at 2048
        for (arch, D_, kind) in (("stablelm", 5120, "layer"),
                                 ("starcoder2", 4608, "layer"),
                                 ("paligemma", 2048, "rms")):
            sc = (0.25 + 0.1 * torch.rand(D_, generator=gen,
                                          device=dev)).to(tdt)
            bi = randn(D_, dtype=tdt, std=0.3) if kind == "layer" else None
            for M in (1, 4, 256):
                x = randn(M, D_, dtype=tdt)
                record("fused_norm", f"{arch} {kind} M={M} D={D_}", dt,
                       max_err(FN.fused_norm(x, sc, bi, kind),
                               FN.fused_norm_plain(x, sc, bi, kind)))
                if bf and M in (4, 256):
                    lib = ((lambda: F.layer_norm(x, (D_,), sc, bi, 1e-5))
                           if kind == "layer" else
                           (lambda: F.rms_norm(x, (D_,), sc, 1e-6))
                           if hasattr(F, "rms_norm") else None)
                    extra_row("fused_norm", f"{arch} x ({M}, {D_}) {kind}",
                              lambda: FN.fused_norm(x, sc, bi, kind),
                              lambda: FN.fused_norm_plain(x, sc, bi, kind),
                              lib, (2 * M * D_ + 2 * D_) * es, 0, dt)
        # ---- qkv_proj: decode (the GEMV) and prefill (the GEMM) --------
        for (arch, D_, ns, bias, M_pre) in (
                ("stablelm", 5120, (5120, 1280, 1280), False, 256),
                ("starcoder2", 4608, (4608, 512, 512), True, 256),
                ("paligemma", 2048, (2048, 256, 256), False, 320)):
            ws = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5) for n in ns]
            bs = ([randn(n, dtype=tdt, std=0.1) for n in ns] if bias
                  else [None] * 3)
            wcat = torch.cat(ws, 1)
            bcat = (torch.cat(bs) if bias else
                    torch.zeros(wcat.shape[1], dtype=tdt, device=dev))
            N = sum(ns)
            for M in (1, 4, 5, M_pre):
                x = randn(M, D_, dtype=tdt)
                want_v = QK.kernel_variant(M, tdt)
                require(want_v == qkv_form(M, bf),
                        f"qkv_proj {arch} M={M}: form {want_v}")
                record("qkv_proj", f"{arch}{' bias' if bias else ''} M={M} "
                                   f"({want_v})", dt,
                       max(max_err(a, b) for a, b in zip(
                           QK.qkv_proj(x, *ws, *bs),
                           QK.qkv_proj_plain(x, *ws, *bs))))
                if bf and M in (4, M_pre):
                    extra_row(
                        "qkv_proj", f"{arch} x ({M}, {D_}), N {ns}"
                        f"{' bias' if bias else ''} ({want_v})",
                        lambda: QK.qkv_proj(x, *ws, *bs),
                        lambda: QK.qkv_proj_plain(x, *ws, *bs),
                        lambda: torch.addmm(bcat, x, wcat),
                        (M * D_ + D_ * N + M * N + (N if bias else 0)) * es,
                        2 * M * D_ * N, dt)
            del ws, wcat
        # ---- attn_stream: each arch's prefill (causal S = L), an extend
        # chunk (S 64 at q_offset 256) and a ragged one, at Dh 160 / 256
        # (widened) and starcoder2's G 9 at Dh 128
        for (arch, H_, Hk_, Dh, S_) in (("stablelm", 32, 8, 160, 256),
                                        ("starcoder2", 36, 4, 128, 256),
                                        ("paligemma", 8, 1, 256, 320)):
            for (S, L) in ((S_, S_), (64, 320), (77, 200)):
                q = randn(1, H_, S, Dh, dtype=tdt)
                k = randn(1, Hk_, L, Dh, dtype=tdt)
                v = randn(1, Hk_, L, Dh, dtype=tdt, std=0.4)
                attn_case(f"{arch} H={H_} Hkv={Hk_} Dh={Dh} S={S} L={L}",
                          dt, q, k, v)
                if bf and S == L:
                    pairs = S * (S + 1) // 2
                    extra_row(
                        "attn_stream", f"{arch} q (1, {H_}, {S}, {Dh}), kv "
                        f"heads {Hk_}, causal, split "
                        f"{AS.kv_split(1, H_, S, L, sms)}",
                        lambda: AS.attn_stream(q, k, v, causal=True),
                        lambda: AS.attn_stream_plain(q, k, v, True),
                        sdpa_of(q, k, v),
                        (2 * H_ * S + 2 * Hk_ * L) * Dh * es,
                        4 * H_ * Dh * pairs, dt)
            del q, k, v
        # ---- paged_decode_tiered: stablelm (Hkv 8, G 4, Dh 160) and
        # paligemma (Hkv 1, G 8, Dh 256) at their decode shape (timed),
        # then lengths around the window and the pages, dead pages, G 1
        # at both head dims (the CUDA-core scores), G 9 (rounded up to
        # 16 rows), the sparse read
        for (arch, hkv, g, Dt) in (("stablelm", 8, 4, 160),
                                   ("paligemma", 1, 8, 256)):
            targs = tiered_args(B, hkv, g, Dt, (318, 300, 257, 290))
            err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                                   PD.paged_decode_tiered_plain(*targs))
            record("paged_decode_tiered", f"{arch} Hkv={hkv} G={g} D={Dt} "
                                          f"ctx~300", dt, err, rel=rel)
            if bf:
                results["extra_rows"].append(dict(
                    tiered_row(targs, f"{arch} B {B}, Hkv {hkv}, G {g}, "
                                      f"Dh {Dt}, W {W}, max_len {ML}, ctx "
                                      f"[318, 300, 257, 290]"),
                    name="paged_decode_tiered"))
            del targs
        for (label, Bt, hkv, g, Dt, lens, dead, tau) in (
                ("D=160 G=4 lengths 0,1,W-1,W", 4, 8, 4, 160,
                 (0, 1, W - 1, W), (), 0.0),
                ("D=160 G=4 W+1,max_len-1, dead pages", 4, 8, 4, 160,
                 (W + 1, ML - 1, 255, 256), ((1, 0), (1, 2), (2, 0)), 0.0),
                ("D=160 G=9", 2, 2, 9, 160, (ML - 1, 130), ((0, 3),), 0.0),
                ("D=160 G=1", 4, 8, 1, 160, (318, 0, 127, 511), (), 0.0),
                ("D=160 G=4, tau=1e-3", 4, 8, 4, 160, (ML - 1, 300, 129, 20),
                 ((0, 1),), 1e-3),
                ("D=256 G=8 lengths 0,1,W-1,W", 4, 1, 8, 256,
                 (0, 1, W - 1, W), (), 0.0),
                ("D=256 G=8 W+1,max_len-1, dead pages", 4, 1, 8, 256,
                 (W + 1, ML - 1, 255, 256), ((1, 0), (1, 2), (2, 0)), 0.0),
                ("D=256 G=1", 4, 4, 1, 256, (318, 0, 127, 511), (), 0.0),
                ("D=256 G=8, tau=1e-3", 4, 1, 8, 256, (ML - 1, 300, 129, 20),
                 ((0, 1),), 1e-3),
                ("D=128 G=9", 4, 4, 9, 128, (318, 300, 257, 290), (), 0.0),
                ("B=8 Hkv=20 D=256 G=1 (B*Hkv=160)", 8, 20, 1, 256,
                 (318, 300, 257, 290, 511, 0, 128, 200), (), 0.0)):
            targs = tiered_args(Bt, hkv, g, Dt, lens, dead)
            err, rel = decode_errs(PD.paged_decode_tiered(*targs, tau=tau),
                                   PD.paged_decode_tiered_plain(*targs,
                                                                tau=tau))
            record("paged_decode_tiered", f"{label}, split "
                   f"{PD.tiered_split(Bt, hkv, sms, tau > 0)}", dt, err,
                   rel=rel)
            del targs
        # ---- paged_decode_flat: starcoder2 (Hkv 4, G 9, Dh 128) at its
        # decode shape (timed beside masked SDPA), then Dh 160 / 256 (f32:
        # two 16-byte chunks a lane) around page edges, a dead page, a
        # ragged tail page and B * Hkv >= 132
        for (label, Bf, hkv, g, Df, MLf, lens, dead) in (
                ("starcoder2 Hkv=4 G=9 D=128 ctx~300", 4, 4, 9, 128, ML,
                 (318, 300, 257, 290), ()),
                ("D=128 G=9 lengths 0,1,127,128", 4, 4, 9, 128, ML,
                 (0, 1, 127, 128), ()),
                ("D=160 G=4 ctx~300", 4, 8, 4, 160, ML, (318, 300, 257, 290),
                 ()),
                ("D=160 G=9 last live page dead", 2, 2, 9, 160, ML,
                 (300, 129), ((0, 2),)),
                ("D=256 G=8 ctx~300", 4, 1, 8, 256, ML, (318, 300, 257, 290),
                 ()),
                ("D=256 G=8 ragged max_len 500", 4, 1, 8, 256, 500,
                 (499, 300, 129, 20), ((0, 1),)),
                ("D=256 G=1 lengths 0,1,127,128", 4, 4, 1, 256, ML,
                 (0, 1, 127, 128), ()),
                ("B=8 Hkv=20 D=160 (B*Hkv=160)", 8, 20, 1, 160, ML,
                 (318, 300, 257, 290, 511, 0, 128, 200), ())):
            qr = randn(Bf, hkv, g, Df, dtype=tdt)
            kr = randn(Bf, MLf, hkv, Df, dtype=tdt)
            vr = randn(Bf, MLf, hkv, Df, dtype=tdt, std=0.3)
            lr = torch.tensor(lens, dtype=torch.int32, device=dev)
            tr = KT.cold_page_table(lr, 0, MLf, 128).clone()
            for (b_, j_) in dead:
                tr[b_, j_] = -1
            rargs = (qr, kr, vr, lr, tr)
            err, rel = decode_errs(PD.paged_decode_flat(*rargs),
                                   PD.paged_decode_flat_plain(*rargs))
            record("paged_decode_flat",
                   f"{label}, split {PD.flat_split(Bf, hkv, sms)}", dt, err,
                   rel=rel)
            if bf and label.startswith("starcoder2"):
                live = (torch.arange(MLf, device=dev)[None]
                        <= lr[:, None].long())[:, None, None]
                n_tok = int((lr.long() + 1).sum())
                extra_row(
                    "paged_decode_flat", f"starcoder2 B {Bf}, Hkv {hkv}, G "
                    f"{g}, Dh {Df}, max_len {MLf}, ctx {list(lens)}, split "
                    f"{PD.flat_split(Bf, hkv, sms)}",
                    lambda: PD.paged_decode_flat(*rargs),
                    lambda: PD.paged_decode_flat_plain(*rargs),
                    sdpa_of(qr.reshape(Bf, hkv * g, 1, Df),
                            kr.transpose(1, 2), vr.transpose(1, 2), live),
                    2 * qr.numel() * es + 2 * n_tok * hkv * Df * es
                    + lr.numel() * 4 + tr.numel() * 4,
                    4 * Df * hkv * g * n_tok, dt, ev=True)
            del qr, kr, vr, rargs
        # ---- ffn_act: stablelm's silu_gated at d_model 5120 (widened: the
        # stream form's x rows and partial, the fma form's two column
        # bands) and paligemma's gelu_gated, decode M 4 and prefill; the
        # bf16 rows timed beside the cuBLAS chain
        for (arch, D_, F_, kind, M_pre) in (
                ("stablelm", 5120, 13824, "silu_gated", 256),
                ("paligemma", 2048, 16384, "gelu_gated", 320)):
            wf = (randn(D_, F_, dtype=tdt, std=0.5 * D_ ** -0.5),
                  randn(D_, F_, dtype=tdt, std=0.5 * D_ ** -0.5),
                  randn(F_, D_, dtype=tdt, std=F_ ** -0.5))
            for M in (4, M_pre):
                x = randn(M, D_, dtype=tdt)
                row = ((3 * D_ * F_ * es, chain_of(x, *wf, kind)) if bf
                       else None)
                ffn_case("ffn_act", x, wf, kind, dt,
                         f"{arch} {kind} M={M} D={D_} F={F_}",
                         ffn_form(M, dt), row)
            del wf
        # ffn_act_int8 at d_model 5120 (F 2048): every form once
        for M in (4, 65):
            ffn_case("ffn_act_int8", randn(M, 5120, dtype=tdt),
                     int8_ffn(5120, 2048, True), "silu_gated", dt,
                     f"silu_gated M={M} D=5120 F=2048",
                     ffn_form(M, dt, int8=True))

    def ssm_widths(dt):
        """The kernels of the rwkv6-7b and zamba2-1.2b paths at their
        serving shapes (4 slots, 256-token prompts; zamba2's chunked
        parity prompts of 300 in chunks of 128), in ``dt`` against the
        plain twin, the form that ran asserted; bf16 rows timed beside
        their bound and the library call. rwkv6: fused_norm LayerNorm +
        bias at D 4096. zamba2's shared attention block (Dh 64, G 1, 32
        heads, d_model 2048): qkv_proj (N 3 x 2048), attn_stream,
        paged_decode_tiered and ffn_act gelu_gated at F 8192."""
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        bf = dt == "bfloat16"
        # ---- fused_norm: rwkv6's LayerNorm + bias at D 4096 ------------
        D_ = SSM_D
        sc = (0.25 + 0.1 * torch.rand(D_, generator=gen, device=dev)).to(tdt)
        bi = randn(D_, dtype=tdt, std=0.3)
        for M in (1, 4, 256):
            x = randn(M, D_, dtype=tdt)
            record("fused_norm", f"rwkv6 layer M={M} D={D_}", dt,
                   max_err(FN.fused_norm(x, sc, bi, "layer"),
                           FN.fused_norm_plain(x, sc, bi, "layer")))
            if bf and M in (4, 256):
                extra_row("fused_norm", f"rwkv6 x ({M}, {D_}) layer",
                          lambda: FN.fused_norm(x, sc, bi, "layer"),
                          lambda: FN.fused_norm_plain(x, sc, bi, "layer"),
                          lambda: F.layer_norm(x, (D_,), sc, bi, 1e-5),
                          (2 * M * D_ + 2 * D_) * es, 0, dt)
        # ---- qkv_proj: zamba2's shared block, N 3 x 2048 ---------------
        D_, H_, Dh = ZAMBA_D, ZAMBA_H, ZAMBA_DH
        ns = (H_ * Dh,) * 3
        ws = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5) for n in ns]
        wcat = torch.cat(ws, 1)
        zero = torch.zeros(wcat.shape[1], dtype=tdt, device=dev)
        N = sum(ns)
        for M in (1, 4, 5, 256):
            x = randn(M, D_, dtype=tdt)
            want_v = QK.kernel_variant(M, tdt)
            require(want_v == qkv_form(M, bf),
                    f"qkv_proj zamba2 M={M}: form {want_v}")
            record("qkv_proj", f"zamba2 M={M} ({want_v})", dt,
                   max(max_err(a, b) for a, b in zip(
                       QK.qkv_proj(x, *ws, None, None, None),
                       QK.qkv_proj_plain(x, *ws, None, None, None))))
            if bf and M in (4, 256):
                extra_row("qkv_proj", f"zamba2 x ({M}, {D_}), N {ns} "
                                      f"({want_v})",
                          lambda: QK.qkv_proj(x, *ws, None, None, None),
                          lambda: QK.qkv_proj_plain(x, *ws, None, None,
                                                    None),
                          lambda: torch.addmm(zero, x, wcat),
                          (M * D_ + D_ * N + M * N) * es, 2 * M * D_ * N,
                          dt)
        del ws, wcat
        # ---- attn_stream: Dh 64, G 1, H 32: the prefill (S = L = 256)
        # and the chunked parity's extend chunks (128 at q_offset 128; the
        # ragged last 44 of a 300-token prompt)
        for (S, L) in ((256, 256), (128, 256), (44, 300)):
            q = randn(1, H_, S, Dh, dtype=tdt)
            k = randn(1, H_, L, Dh, dtype=tdt)
            v = randn(1, H_, L, Dh, dtype=tdt, std=0.4)
            attn_case(f"zamba2 H={H_} Hkv={H_} Dh={Dh} S={S} L={L}", dt, q,
                      k, v)
            if bf and S == L:
                extra_row("attn_stream", f"zamba2 q (1, {H_}, {S}, {Dh}), "
                                         f"kv heads {H_}, causal, split "
                                         f"{AS.kv_split(1, H_, S, L, sms)}",
                          lambda: AS.attn_stream(q, k, v, causal=True),
                          lambda: AS.attn_stream_plain(q, k, v, True),
                          sdpa_of(q, k, v), 4 * H_ * S * Dh * es,
                          4 * H_ * Dh * S * (S + 1) // 2, dt)
        del q, k, v
        # ---- paged_decode_tiered: Hkv 32, G 1, Dh 64 at the decode shape
        # (timed), around the window and the pages, dead pages
        targs = tiered_args(B, H_, 1, Dh, (318, 300, 257, 290))
        err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                               PD.paged_decode_tiered_plain(*targs))
        record("paged_decode_tiered", f"zamba2 Hkv={H_} G=1 D={Dh} ctx~300",
               dt, err, rel=rel)
        if bf:
            results["extra_rows"].append(dict(
                tiered_row(targs, f"zamba2 B {B}, Hkv {H_}, G 1, Dh {Dh}, "
                                  f"W {W}, max_len {ML}, ctx [318, 300, "
                                  f"257, 290]"),
                name="paged_decode_tiered"))
        del targs
        for (label, lens, dead) in (
                ("lengths 0,1,W-1,W", (0, 1, W - 1, W), ()),
                ("W+1,max_len-1, dead pages", (W + 1, ML - 1, 255, 256),
                 ((1, 0), (1, 2), (2, 0)))):
            targs = tiered_args(B, H_, 1, Dh, lens, dead)
            err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                                   PD.paged_decode_tiered_plain(*targs))
            record("paged_decode_tiered", f"zamba2 D={Dh} G=1 {label}, "
                   f"split {PD.tiered_split(B, H_, sms, False)}", dt, err,
                   rel=rel)
            del targs
        # ---- ffn_act: gelu_gated at D 2048, F 8192, both forms ---------
        F_ = ZAMBA_F
        wf = (randn(D_, F_, dtype=tdt, std=0.5 * D_ ** -0.5),
              randn(D_, F_, dtype=tdt, std=0.5 * D_ ** -0.5),
              randn(F_, D_, dtype=tdt, std=F_ ** -0.5))
        for M in (4, 256):
            x = randn(M, D_, dtype=tdt)
            row = ((3 * D_ * F_ * es, chain_of(x, *wf, "gelu_gated")) if bf
                   else None)
            ffn_case("ffn_act", x, wf, "gelu_gated", dt,
                     f"zamba2 gelu_gated M={M} D={D_} F={F_}",
                     ffn_form(M, dt), row)
        del wf

    def tp_widths(dt):
        """The sharded executor's per-rank shard shapes at a 2-way and a
        4-way 'model' split (the local query heads, the kv heads those
        read, the local FFN width), in ``dt`` against the plain twins,
        the form that ran asserted; bf16 rows timed beside their bound
        and the library call. fastvlm-1.7b: heads 12 -> 6 / 3, kv 2 -> 1
        (at 4 ways its 2 kv heads are replicated: the rank projects both
        and reads one, G 3), F 8960 -> 4480 / 2240; stablelm-12b: heads
        32 -> 16 / 8, kv 8 -> 4 / 2, F 13824 -> 6912 / 3456. Each through
        qkv_proj (M 4: GEMV; 256: GEMM), ffn_act (M 4: stream; 256:
        wgmma), paged_decode_tiered (4 slots, ctx ~300) and attn_stream
        (causal S = L = 256)."""
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        bf = dt == "bfloat16"
        for (arch, D_, H_, Hk_, Dh, F_, bias) in (
                ("fastvlm", D_MODEL, 12, 2, 128, D_FF, True),
                ("stablelm", 5120, 32, 8, 160, 13824, False)):
            for m in (2, 4):
                hl, fl = H_ // m, F_ // m
                kv_split = Hk_ % m == 0
                hkl = Hk_ // m if kv_split else max(hl * Hk_ // H_, 1)
                ns = (hl * Dh,) + ((hkl if kv_split else Hk_) * Dh,) * 2
                tag = f"{arch}/{m}"
                # ---- qkv_proj at the local N ---------------------------
                ws = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5)
                      for n in ns]
                bs = ([randn(n, dtype=tdt, std=0.1) for n in ns] if bias
                      else [None] * 3)
                wcat = torch.cat(ws, 1)
                bcat = (torch.cat(bs) if bias else
                        torch.zeros(wcat.shape[1], dtype=tdt, device=dev))
                N = sum(ns)
                for M in (4, 256):
                    x = randn(M, D_, dtype=tdt)
                    want_v = QK.kernel_variant(M, tdt)
                    require(want_v == qkv_form(M, bf),
                            f"qkv_proj {tag} M={M}: form {want_v}")
                    record("qkv_proj", f"{tag} M={M} N={ns} ({want_v})", dt,
                           max(max_err(a, b) for a, b in zip(
                               QK.qkv_proj(x, *ws, *bs),
                               QK.qkv_proj_plain(x, *ws, *bs))))
                    if bf:
                        extra_row(
                            "qkv_proj", f"{tag} shard x ({M}, {D_}), N {ns}"
                            f"{' bias' if bias else ''} ({want_v})",
                            lambda: QK.qkv_proj(x, *ws, *bs),
                            lambda: QK.qkv_proj_plain(x, *ws, *bs),
                            lambda: torch.addmm(bcat, x, wcat),
                            (M * D_ + D_ * N + M * N + (N if bias else 0))
                            * es, 2 * M * D_ * N, dt)
                del ws, wcat
                # ---- ffn_act at the local F ----------------------------
                wf = (randn(D_, fl, dtype=tdt, std=0.5 * D_ ** -0.5),
                      randn(D_, fl, dtype=tdt, std=0.5 * D_ ** -0.5),
                      randn(fl, D_, dtype=tdt, std=fl ** -0.5))
                for M in (4, 256):
                    x = randn(M, D_, dtype=tdt)
                    row = ((3 * D_ * fl * es, chain_of(x, *wf)) if bf
                           else None)
                    ffn_case("ffn_act", x, wf, "silu_gated", dt,
                             f"{tag} shard M={M} D={D_} F={fl}",
                             ffn_form(M, dt), row)
                del wf
                # ---- paged_decode_tiered at the local heads ------------
                g = hl // hkl
                targs = tiered_args(B, hkl, g, Dh, (318, 300, 257, 290))
                err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                                       PD.paged_decode_tiered_plain(*targs))
                record("paged_decode_tiered", f"{tag} Hkv={hkl} G={g} "
                       f"D={Dh} ctx~300, split "
                       f"{PD.tiered_split(B, hkl, sms, False)}", dt, err,
                       rel=rel)
                if bf:
                    results["extra_rows"].append(dict(
                        tiered_row(targs, f"{tag} shard B {B}, Hkv {hkl}, "
                                          f"G {g}, Dh {Dh}, W {W}, max_len "
                                          f"{ML}, ctx [318, 300, 257, 290]"),
                        name="paged_decode_tiered"))
                del targs
                # ---- attn_stream at the local heads --------------------
                q = randn(1, hl, 256, Dh, dtype=tdt)
                k = randn(1, hkl, 256, Dh, dtype=tdt)
                v = randn(1, hkl, 256, Dh, dtype=tdt, std=0.4)
                attn_case(f"{tag} H={hl} Hkv={hkl} Dh={Dh} S=L=256", dt, q,
                          k, v)
                if bf:
                    extra_row(
                        "attn_stream", f"{tag} shard q (1, {hl}, 256, {Dh}),"
                        f" kv heads {hkl}, causal, split "
                        f"{AS.kv_split(1, hl, 256, 256, sms)}",
                        lambda: AS.attn_stream(q, k, v, causal=True),
                        lambda: AS.attn_stream_plain(q, k, v, True),
                        sdpa_of(q, k, v), (2 * hl + 2 * hkl) * 256 * Dh * es,
                        4 * hl * Dh * 256 * 257 // 2, dt)
                del q, k, v

    def slice12_widths(dt):
        """The kernels of the hubert-xlarge and llama4-maverick-400b paths
        at their shapes, in ``dt`` against the plain twin, the form that
        ran asserted; bf16 rows timed beside their bound and the library
        call. hubert (4 clips x 500 frames: M 2000, a multiple of neither
        64 nor 128): fused_norm LayerNorm + bias at D 1280, qkv_proj's
        GEMM at N 3 x 1280 and ffn_act's ungated gelu at F 5120 (wgmma in
        bf16, fma in f32). llama4 (4 slots, 256-token prompts): fused_norm
        rms at D 5120, qkv_proj at N 5120 / 1024 / 1024 (M 1, 4, 5, 256),
        attn_stream at H 40, Hkv 8, Dh 128 (G 5) and paged_decode_tiered
        at Hkv 8, G 5, Dh 128 (both run their G 8 instances)."""
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        bf = dt == "bfloat16"
        M_h = HUBERT_CLIPS * HUBERT_FRAMES
        # ---- fused_norm: hubert's LayerNorm + bias, llama4's rms --------
        for (arch, D_, kind, Ms) in (("hubert", HUBERT_D, "layer", (M_h,)),
                                     ("llama4", LLAMA_D, "rms",
                                      (1, 4, 256))):
            sc = (0.25 + 0.1 * torch.rand(D_, generator=gen,
                                          device=dev)).to(tdt)
            bi = randn(D_, dtype=tdt, std=0.3) if kind == "layer" else None
            for M in Ms:
                x = randn(M, D_, dtype=tdt)
                record("fused_norm", f"{arch} {kind} M={M} D={D_}", dt,
                       max_err(FN.fused_norm(x, sc, bi, kind),
                               FN.fused_norm_plain(x, sc, bi, kind)))
                if bf and M > 1:
                    lib = ((lambda: F.layer_norm(x, (D_,), sc, bi, 1e-5))
                           if kind == "layer" else
                           (lambda: F.rms_norm(x, (D_,), sc, 1e-6))
                           if hasattr(F, "rms_norm") else None)
                    extra_row("fused_norm", f"{arch} x ({M}, {D_}) {kind}",
                              lambda: FN.fused_norm(x, sc, bi, kind),
                              lambda: FN.fused_norm_plain(x, sc, bi, kind),
                              lib, (2 * M * D_ + 2 * D_) * es, 0, dt)
        # ---- qkv_proj: hubert's GEMM, llama4's GEMV and GEMM ------------
        for (arch, D_, ns, Ms) in (
                ("hubert", HUBERT_D, (HUBERT_D,) * 3, (M_h,)),
                ("llama4", LLAMA_D, (LLAMA_H * 128, LLAMA_HKV * 128,
                                     LLAMA_HKV * 128), (1, 4, 5, 256))):
            ws = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5) for n in ns]
            wcat = torch.cat(ws, 1)
            zero = torch.zeros(wcat.shape[1], dtype=tdt, device=dev)
            N = sum(ns)
            for M in Ms:
                x = randn(M, D_, dtype=tdt)
                want_v = QK.kernel_variant(M, tdt)
                require(want_v == qkv_form(M, bf),
                        f"qkv_proj {arch} M={M}: form {want_v}")
                record("qkv_proj", f"{arch} M={M} N={ns} ({want_v})", dt,
                       max(max_err(a, b) for a, b in zip(
                           QK.qkv_proj(x, *ws, None, None, None),
                           QK.qkv_proj_plain(x, *ws, None, None, None))))
                if bf and M != 1 and M != 5:
                    extra_row("qkv_proj", f"{arch} x ({M}, {D_}), N {ns} "
                                          f"({want_v})",
                              lambda: QK.qkv_proj(x, *ws, None, None, None),
                              lambda: QK.qkv_proj_plain(x, *ws, None, None,
                                                        None),
                              lambda: torch.addmm(zero, x, wcat),
                              (M * D_ + D_ * N + M * N) * es,
                              2 * M * D_ * N, dt)
            del ws, wcat
        # ---- attn_stream: llama4's prefill (S = L = 256), an extend chunk
        # (S 64 at q_offset 256) and a ragged one: H 40, Hkv 8, Dh 128
        H_, Hk_, Dh = LLAMA_H, LLAMA_HKV, 128
        for (S, L) in ((256, 256), (64, 320), (77, 200)):
            q = randn(1, H_, S, Dh, dtype=tdt)
            k = randn(1, Hk_, L, Dh, dtype=tdt)
            v = randn(1, Hk_, L, Dh, dtype=tdt, std=0.4)
            attn_case(f"llama4 H={H_} Hkv={Hk_} Dh={Dh} S={S} L={L}", dt, q,
                      k, v)
            if bf and S == L:
                extra_row("attn_stream", f"llama4 q (1, {H_}, {S}, {Dh}), "
                                         f"kv heads {Hk_} (G 5), causal, "
                                         f"split "
                                         f"{AS.kv_split(1, H_, S, L, sms)}",
                          lambda: AS.attn_stream(q, k, v, causal=True),
                          lambda: AS.attn_stream_plain(q, k, v, True),
                          sdpa_of(q, k, v),
                          (2 * H_ * S + 2 * Hk_ * L) * Dh * es,
                          4 * H_ * Dh * S * (S + 1) // 2, dt)
        del q, k, v
        # ---- paged_decode_tiered: Hkv 8, G 5, Dh 128 at the decode shape
        # (timed), around the window and the pages, dead pages
        targs = tiered_args(B, Hk_, 5, Dh, (318, 300, 257, 290))
        err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                               PD.paged_decode_tiered_plain(*targs))
        record("paged_decode_tiered", f"llama4 Hkv={Hk_} G=5 D={Dh} "
                                      f"ctx~300", dt, err, rel=rel)
        if bf:
            results["extra_rows"].append(dict(
                tiered_row(targs, f"llama4 B {B}, Hkv {Hk_}, G 5, Dh {Dh}, "
                                  f"W {W}, max_len {ML}, ctx [318, 300, "
                                  f"257, 290]"),
                name="paged_decode_tiered"))
        del targs
        for (label, lens, dead) in (
                ("lengths 0,1,W-1,W", (0, 1, W - 1, W), ()),
                ("W+1,max_len-1, dead pages", (W + 1, ML - 1, 255, 256),
                 ((1, 0), (1, 2), (2, 0)))):
            targs = tiered_args(B, Hk_, 5, Dh, lens, dead)
            err, rel = decode_errs(PD.paged_decode_tiered(*targs),
                                   PD.paged_decode_tiered_plain(*targs))
            record("paged_decode_tiered", f"llama4 D={Dh} G=5 {label}, "
                   f"split {PD.tiered_split(B, Hk_, sms, False)}", dt, err,
                   rel=rel)
            del targs
        # ---- ffn_act: hubert's ungated gelu, D 1280, F 5120, M 2000 -----
        D_, F_ = HUBERT_D, HUBERT_F
        wu = randn(D_, F_, dtype=tdt, std=0.5 * D_ ** -0.5)
        wd = randn(F_, D_, dtype=tdt, std=F_ ** -0.5)
        x = randn(M_h, D_, dtype=tdt)

        def chain():
            return FF.activation(x @ wu, "gelu") @ wd
        ffn_case("ffn_act", x, (wu, None, wd), "gelu", dt,
                 f"hubert gelu M={M_h} D={D_} F={F_}", ffn_form(M_h, dt),
                 (2 * D_ * F_ * es, chain) if bf else None)
        del wu, wd, x

    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        # ---- fused_norm: rms at decode M = 1, 4 and prefill M = 320, at
        # fastvlm-1.7b's D 1536, mobilevlm-3b's 2560 and ragged D 1000
        # (whole 16-byte vectors, a ragged warp) and 1001 (the scalar
        # kernel). In bf16 at M = 4 the kernel, its twin and F.rms_norm
        # are timed at both models' widths
        for D_ in (D_MODEL, D3, 1000, 1001):
            sc = (0.25 + 0.1 * torch.rand(D_, generator=gen,
                                          device=dev)).to(tdt)
            for M in (1, 4, HIT_TAIL, 320):
                x = randn(M, D_, dtype=tdt)
                out = FN.fused_norm(x, sc, None, "rms")
                err = max_err(out, FN.fused_norm_plain(x, sc, None, "rms"))
                main = None
                if M == 4 and dt == "bfloat16" and D_ in (D_MODEL, D3):
                    main = norm_row(x, sc, es)
                    print(f"[kernels]   fused_norm x ({M}, {D_}): "
                          f"{us(main['device_ms'])} device, "
                          f"{main['ms']:.4f} ms call; F.rms_norm (ms) "
                          f"{main['library_device_ms']} device, "
                          f"{main['library_ms']} call, kernels "
                          f"{main['library_kernels']}")
                    if D_ == D3:
                        results["fused_norm_mobilevlm"], main = main, None
                record("fused_norm", f"rms M={M}" if D_ == D_MODEL
                       else f"rms M={M} D={D_}", dt, err, main)
        # LayerNorm with bias; scale in the other type; strided rows: pitch
        # 1544 (whole vectors: the vector kernel), pitch 1542 and a base
        # one element in (the scalar kernel)
        for (M, D_) in ((4, D_MODEL), (320, 1000), (3, 1001)):
            x = randn(M, D_, dtype=tdt)
            sl, bl = randn(D_, dtype=tdt, std=0.3), randn(D_, dtype=tdt,
                                                          std=0.3)
            record("fused_norm", f"layer + bias M={M} D={D_}", dt,
                   max_err(FN.fused_norm(x, sl, bl, "layer"),
                           FN.fused_norm_plain(x, sl, bl, "layer")))
        other = "float32" if dt == "bfloat16" else "bfloat16"
        x = randn(4, D3, dtype=tdt)
        so = (0.25 + 0.1 * torch.rand(D3, generator=gen, device=dev)).to(
            getattr(torch, other))
        record("fused_norm", f"rms M=4 D={D3} {other} scale", dt,
               max_err(FN.fused_norm(x, so, None, "rms"),
                       FN.fused_norm_plain(x, so, None, "rms")))
        sc = (0.25 + 0.1 * torch.rand(D_MODEL, generator=gen,
                                      device=dev)).to(tdt)
        for (pitch, off, want) in ((1544, 0, "vector"), (1542, 0, "scalar"),
                                   (1544, 1, "scalar")):
            x = randn(320, pitch, dtype=tdt)[:, off:off + D_MODEL]
            got = FN.variant(D_MODEL, x.stride(0), es,
                             x.data_ptr() | sc.data_ptr())
            require(got == want, f"fused_norm on pitch {pitch} offset {off}: "
                                 f"{got} kernel, expected {want}")
            record("fused_norm", f"rms M=320 pitch {pitch} offset {off} "
                                 f"({got})", dt,
                   max_err(FN.fused_norm(x, sc, None, "rms"),
                           FN.fused_norm_plain(x, sc, None, "rms")))
        # ---- ffn_act: decode M=4 (stream), a prefix hit's padded
        # 64-row tail and prefill M=320 (wgmma in bf16, the FMA tiles in
        # f32), silu_gated; bf16 rows timed
        w_up = randn(D_MODEL, D_FF, dtype=tdt, std=0.5 * D_MODEL ** -0.5)
        w_gate = randn(D_MODEL, D_FF, dtype=tdt, std=0.5 * D_MODEL ** -0.5)
        w_down = randn(D_FF, D_MODEL, dtype=tdt, std=D_FF ** -0.5)
        for M in (4, HIT_TAIL, 320):
            x = randn(M, D_MODEL, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D_MODEL * D_FF * es,
                       chain_of(x, w_up, w_gate, w_down))
            ffn_case("ffn_act", x, (w_up, w_gate, w_down), "silu_gated", dt,
                     f"silu_gated M={M}", ffn_form(M, dt), row, M == 4)
        del w_up, w_gate, w_down
        # ---- attn_stream: prefill S = L = 320 causal --------------------
        S = L = 320
        q = randn(1, HEADS, S, HEAD_DIM, dtype=tdt)
        k = randn(1, KV_HEADS, L, HEAD_DIM, dtype=tdt)
        v = randn(1, KV_HEADS, L, HEAD_DIM, dtype=tdt, std=0.4)
        out = AS.attn_stream(q, k, v, causal=True)
        main = None
        if dt == "bfloat16":
            ms = time_ms(lambda: AS.attn_stream(q, k, v, causal=True))
            plain = time_ms(lambda: AS.attn_stream_plain(q, k, v, True))
            lib, lib_dev = timed(sdpa_of(q, k, v))
            pairs = S * (S + 1) // 2
            nbytes = (2 * HEADS * S + 2 * KV_HEADS * L) * HEAD_DIM * es
            b_ms, b_by = bound(pk, nbytes, 4 * HEADS * HEAD_DIM * pairs, dt)
            main = {"shape": f"q (1, {HEADS}, {S}, {HEAD_DIM}), kv heads "
                             f"{KV_HEADS}, causal", "ms": ms,
                    "device_ms": dev_ms(lambda: AS.attn_stream(
                        q, k, v, causal=True)),
                    "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": b_ms,
                    "bound_by": b_by}
        attn_case("causal S=L=320", dt, q, k, v, got=out, main=main)
        # an extend chunk: 64 queries at pos 256 over the first 320 rows of
        # the (1, 512, Hkv, Dh) workspace, sliced as core/fusion.py passes
        # it (strided K/V views, model-layout q and output)
        k_ws = randn(1, 512, KV_HEADS, HEAD_DIM, dtype=tdt)
        v_ws = randn(1, 512, KV_HEADS, HEAD_DIM, dtype=tdt, std=0.4)
        qx = randn(1, 64, HEADS, HEAD_DIM, dtype=tdt)
        kx, vx = k_ws[:, :320], v_ws[:, :320]
        attn_case("extend S=64 L=320 workspace slice", dt,
                  qx.transpose(1, 2), kx.transpose(1, 2), vx.transpose(1, 2),
                  got=ops.attn_stream(qx, kx, vx, causal=True).transpose(
                      1, 2))
        del k_ws, v_ws
        # ragged S = L = 200 (not a multiple of the 64-row tiles)
        q = randn(1, HEADS, 200, HEAD_DIM, dtype=tdt)
        k = randn(1, KV_HEADS, 200, HEAD_DIM, dtype=tdt)
        v = randn(1, KV_HEADS, 200, HEAD_DIM, dtype=tdt, std=0.4)
        attn_case("ragged causal S=L=200", dt, q, k, v)
        # fastvlm-0.6b's heads: H 14, Hkv 2, Dh 64
        q = randn(1, 14, 320, 64, dtype=tdt)
        k = randn(1, 2, 320, 64, dtype=tdt)
        v = randn(1, 2, 320, 64, dtype=tdt, std=0.4)
        attn_case("H=14 Hkv=2 Dh=64 causal S=L=320", dt, q, k, v)
        if dt == "float32":
            # the training shape (8 x 256 rows, fastvlm-1.7b's heads: the
            # tf32x3 form, timed in the train phase), and short calls at
            # Dh 128 and 64: extends of 1 and 16 rows over 300 keys and a
            # 16-row prefill
            q = randn(TRAIN_B, HEADS, TRAIN_S, HEAD_DIM, dtype=tdt)
            k = randn(TRAIN_B, KV_HEADS, TRAIN_S, HEAD_DIM, dtype=tdt)
            v = randn(TRAIN_B, KV_HEADS, TRAIN_S, HEAD_DIM, dtype=tdt)
            attn_case(f"training q ({TRAIN_B}, {HEADS}, {TRAIN_S}, "
                      f"{HEAD_DIM}) G {HEADS // KV_HEADS}", dt, q, k, v)
            for Dh in (HEAD_DIM, 64):
                for S, L in ((1, 300), (16, 300), (16, 16)):
                    q = randn(1, HEADS, S, Dh, dtype=tdt)
                    k = randn(1, KV_HEADS, L, Dh, dtype=tdt)
                    v = randn(1, KV_HEADS, L, Dh, dtype=tdt, std=0.4)
                    attn_case(f"short S={S} L={L} Dh={Dh}", dt, q, k, v)
            # a NaN in one feature of one q row, then of one k row: the
            # kernel's output is NaN exactly where the twin's is (that q
            # row of that head; every row of the group's heads that sees
            # that key), and the finite rest within the f32 gate
            for which, at in (("q", (0, 3, 10, 7)), ("k", (0, 1, 20, 5))):
                q = randn(1, HEADS, 64, HEAD_DIM, dtype=tdt)
                k = randn(1, KV_HEADS, 64, HEAD_DIM, dtype=tdt)
                v = randn(1, KV_HEADS, 64, HEAD_DIM, dtype=tdt, std=0.4)
                (q if which == "q" else k)[at] = float("nan")
                got = AS.attn_stream(q, k, v, causal=True)
                want = AS.attn_stream_plain(q, k, v, True)
                require(AS.attn_stream.variant == "tf32x3",
                        f"attn_stream NaN in {which}: ran "
                        f"{AS.attn_stream.variant}")
                nan = want.isnan()
                require(bool(nan.any()) and torch.equal(got.isnan(), nan),
                        f"attn_stream NaN in {which}: {int(nan.sum())} NaN "
                        f"outputs in the twin, {int(got.isnan().sum())} in "
                        f"the kernel, {int((got.isnan() != nan).sum())} "
                        f"placed differently")
                record("attn_stream", f"NaN in {which}{list(at)} (tf32x3: "
                       f"{int(nan.sum())} NaN as the twin)", dt,
                       max_err(got[~nan], want[~nan]))
        del q, k, v
        # ---- paged_decode_tiered: hot window 128, max_len 512, 128-token
        # pages; cold int8 with scales in 0.002-0.008
        B, W, ML, G = 4, 128, 512, HEADS // KV_HEADS

        def tiered_args(Bt, hkv, g, Dt, lens, dead=(), skew=False):
            """Operands of one tiered call. ``skew`` (for tau = 1e-3, whose
            skip threshold is m + ln(1e-3) = m - 6.91): one query row over
            the group; hot slot 0 along sign(q) with score 12, the running
            max; every cold key along sign(q) too, so a page's score equals
            its bound, 127 * k-scale * scale * ||q||_1: 12 - 7.2 on pages 0
            and 2+ (0.3 under the threshold: skipped, yet 7.5e-4 of slot
            0's weight a key) and 12 - 6 on page 1 (read). Skipping nothing,
            or page 1 too, moves some (slot, kv head)'s output by over a
            tenth of its largest value."""
            qd = randn(Bt, hkv, g, Dt, dtype=tdt)
            if skew:
                qd = qd[:, :, :1].expand(Bt, hkv, g, Dt).contiguous()
            hk = randn(Bt, W, hkv, Dt, dtype=tdt)
            hv = randn(Bt, W, hkv, Dt, dtype=tdt, std=0.3)
            ck, cv = (torch.randint(-127, 128, (Bt, ML, hkv, Dt),
                                    generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (0.002 + 0.006 * torch.rand(Bt, ML, hkv, 1,
                                                 generator=gen, device=dev)
                      for _ in range(2))
            if skew:
                sgn = torch.sign(qd[:, :, 0].float())          # (Bt, hkv, Dt)
                unit = Dt ** -0.5 * qd[:, :, 0].float().abs().sum(-1)
                hk[:, 0] = (12.0 / unit[..., None] * sgn).to(tdt)
                ck[:] = (127 * sgn).to(torch.int8)[:, None]
                score = torch.full((ML,), 12.0 - 7.2, device=dev)
                score[128:256] = 12.0 - 6.0
                ks = (score[None, :, None] / (127 * unit[:, None])
                      )[..., None].contiguous()
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            tab = KT.cold_page_table(lt, W, ML, 128).clone()
            for (b_, j_) in dead:
                tab[b_, j_] = -1
            return (qd, hk, hv, ck, ks, cv, vs, lt, tab)

        def tiered_row(targs, label):
            """Times of one bf16 tiered call beside its bound (the live hot
            slots and cold rows + scales, each read once; q read, out
            written) and its twin's."""
            qd, hk, lt = targs[0], targs[1], targs[7]
            _, hkv, g, Dt = qd.shape
            n_hot = sum(min(int(p) + 1, W) for p in lt)
            n_cold = sum(max(int(p) - W + 1, 0) for p in lt)
            nbytes = (2 * qd.numel() * es + 2 * n_hot * hkv * Dt * es
                      + 2 * n_cold * hkv * (Dt + 4)
                      + lt.numel() * 4 + targs[8].numel() * 4)
            b_ms, b_by = bound(pk, nbytes, 4 * g * Dt * hkv
                               * (n_hot + n_cold), dt)
            split = PD.tiered_split(qd.shape[0], hkv, sms, False)
            ms, dms = timed(lambda: PD.paged_decode_tiered(*targs))
            row = {"shape": f"{label}, split {split}", "ms": ms,
                   "device_ms": dms,
                   "event_ms": ev_timer(lambda: PD.paged_decode_tiered(
                       *targs)),
                   "plain_ms": time_ms(lambda: PD.paged_decode_tiered_plain(
                       *targs)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            print(f"[kernels]   paged_decode_tiered {row['shape']}: "
                  f"{us(dms)} device (profiler), "
                  f"{1e3 * row['event_ms']:.2f} us (CUDA events), "
                  f"{ms:.4f} ms call; bound {1e3 * b_ms:.2f} us ({b_by}); "
                  f"plain {row['plain_ms']:.3f} ms")
            return row

        args = tiered_args(B, KV_HEADS, G, HEAD_DIM, (ML - 1,) * B)
        err, rel = decode_errs(PD.paged_decode_tiered(*args),
                               PD.paged_decode_tiered_plain(*args))
        main = None
        if dt == "bfloat16":
            main = tiered_row(args, f"B {B}, Hkv {KV_HEADS}, G {G}, W {W}, "
                                    f"max_len {ML}, {ML - W} cold tokens/slot")
        record("paged_decode_tiered", "B=4 W=128 384 cold/slot", dt, err,
               main, rel=rel)
        # mobilevlm-3b (path B): Hkv 20, G 1, ctx 257-318, timed in bf16
        args3 = tiered_args(B, H3, 1, HEAD_DIM, (318, 300, 257, 290))
        err, rel = decode_errs(PD.paged_decode_tiered(*args3),
                               PD.paged_decode_tiered_plain(*args3))
        record("paged_decode_tiered", "Hkv=20 G=1 ctx~300", dt, err, rel=rel)
        if dt == "bfloat16":
            results["extra_rows"].append(dict(
                tiered_row(args3, f"B {B}, Hkv {H3}, G 1, W {W}, max_len "
                                  f"{ML}, ctx [318, 300, 257, 290]"),
                name="paged_decode_tiered"))
        del args3
        # around the hot window and the pages: lengths 0, 1, W - 1, W,
        # W + 1 and max_len - 1; dead pages (a slot's last live one, and a
        # slot left with no live page); every G form (1, 2, 4, 8, 16) and
        # every head dim (bf16 G >= 2: the tensor-core scores); the sparse
        # read, with pages really skipped, held against the twin at the
        # same tau; B * Hkv >= 132 (no split)
        for (label, Bt, hkv, g, Dt, lens, dead, tau, skew) in (
                ("lengths 0,1,W-1,W", 4, KV_HEADS, 6, HEAD_DIM,
                 (0, 1, W - 1, W), (), 0.0, False),
                ("lengths W+1,max_len-1,255,256, dead pages", 4, KV_HEADS,
                 6, HEAD_DIM, (W + 1, ML - 1, 255, 256),
                 ((1, 0), (1, 2), (2, 0)), 0.0, False),
                ("ragged + dead page", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 300, 129, 20), ((0, 1),), 0.0, False),
                ("ragged + dead page, tau=1e-3", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 300, 129, 20), ((0, 1),), 1e-3, False),
                ("pages skipped, tau=1e-3", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 400, 300, 200), (), 1e-3, True),
                ("Hkv=20 G=1 D=128, tau=1e-3", 4, H3, 1, HEAD_DIM,
                 (318, 0, 127, 511), ((3, 1),), 1e-3, False),
                ("Hkv=20 G=1 D=64", 4, H3, 1, 64, (318, 0, 127, 511), (),
                 0.0, False),
                ("Hkv=4 G=2 D=64", 4, 4, 2, 64, (300, 129, 64, 511),
                 ((0, 1),), 0.0, False),
                ("Hkv=2 G=8 D=64", 2, 2, 8, 64, (400, 200), (), 0.0, False),
                ("Hkv=2 G=4 D=32", 2, 2, 4, 32, (300, 64), ((0, 0),), 0.0,
                 False),
                ("Hkv=1 G=3 D=16", 2, 1, 3, 16, (511, 129), (), 0.0, False),
                ("Hkv=1 G=16 D=128", 2, 1, 16, HEAD_DIM, (ML - 1, 130),
                 ((0, 3),), 0.0, False),
                ("Hkv=1 G=16 D=64, tau=1e-3", 2, 1, 16, 64, (ML - 1, 130),
                 (), 1e-3, False),
                ("B=8 Hkv=20 (B*Hkv=160)", 8, H3, 1, HEAD_DIM,
                 (318, 300, 257, 290, 511, 0, 128, 200), (), 0.0, False)):
            targs = tiered_args(Bt, hkv, g, Dt, lens, dead, skew)
            want = PD.paged_decode_tiered_plain(*targs, tau=tau)
            extra = None
            if tau:     # does the twin's skip rule fire on these inputs?
                moved, moved_rel = decode_errs(
                    want, PD.paged_decode_tiered_plain(*targs))
                extra = {"skip_changed_output": moved,
                         "skip_changed_rel": moved_rel}
                # twice the limit: a kernel within it of the skipping
                # twin is out of it of the twin that skips nothing
                if skew:
                    require(moved_rel > 2 * TOL[dt],
                            f"paged_decode_tiered {label}: skipping moves "
                            f"the output by {moved_rel:.3e} of its largest "
                            f"value, not over twice the limit {TOL[dt]}")
            split = PD.tiered_split(Bt, hkv, sms, tau > 0)
            err, rel = decode_errs(PD.paged_decode_tiered(*targs, tau=tau),
                                   want)
            record("paged_decode_tiered", f"{label}, split {split}", dt, err,
                   extra=extra, rel=rel)
            del targs
        # ---- paged_decode_flat: mobilevlm-3b B=4, Hkv 20, G 1, ctx ~300 -
        q3 = randn(B, H3, 1, HEAD_DIM, dtype=tdt)
        lengths3 = torch.tensor([318, 300, 257, 290], dtype=torch.int32,
                                device=dev)
        kf = randn(B, ML, H3, HEAD_DIM, dtype=tdt)
        vf = randn(B, ML, H3, HEAD_DIM, dtype=tdt, std=0.3)
        tab3 = KT.cold_page_table(lengths3, 0, ML, 128)
        fargs = (q3, kf, vf, lengths3, tab3)
        out = PD.paged_decode_flat(*fargs)
        err, rel = decode_errs(out, PD.paged_decode_flat_plain(*fargs))
        main = None
        if dt == "bfloat16":
            plain = time_ms(lambda: PD.paged_decode_flat_plain(*fargs))
            q4 = q3.reshape(B, H3, 1, HEAD_DIM)
            kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
            live = (torch.arange(ML, device=dev)[None]
                    <= lengths3[:, None].long())[:, None, None]

            def sdpa():
                return F.scaled_dot_product_attention(q4, kt, vt,
                                                      attn_mask=live)
            lib, lib_dev = timed(sdpa)
            n_tok = int((lengths3.long() + 1).sum())
            nbytes = (2 * q3.numel() * es + 2 * n_tok * H3 * HEAD_DIM * es
                      + lengths3.numel() * 4 + tab3.numel() * 4)
            b_ms, b_by = bound(pk, nbytes, 4 * HEAD_DIM * H3 * n_tok, dt)
            ms, dms = timed(lambda: PD.paged_decode_flat(*fargs))
            main = {"shape": f"B {B}, Hkv {H3}, G 1, max_len {ML}, ctx "
                             f"{lengths3.tolist()}, split "
                             f"{PD.flat_split(B, H3, sms)}",
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev,
                    "library_kernels": lib_kernels(sdpa),
                    "device_ms": dms, "bound_ms": b_ms, "bound_by": b_by}
            print(f"[kernels]   paged_decode_flat {main['shape']}: "
                  f"{us(dms)} device, {ms:.4f} ms call; masked "
                  f"SDPA {us(lib_dev)} device, {lib:.4f} ms call, "
                  f"kernels {main['library_kernels']}; bound "
                  f"{1e3 * b_ms:.2f} us")
        record("paged_decode_flat", "B=4 Hkv=20 G=1 ctx~300", dt, err, main,
               rel=rel)
        # ragged lengths, a dead page and a ragged tail page (max_len 500)
        for (hkv, g) in ((H3, 1), (KV_HEADS, HEADS // KV_HEADS)):
            ML5 = 500
            qr = randn(B, hkv, g, HEAD_DIM, dtype=tdt)
            kr = randn(B, ML5, hkv, HEAD_DIM, dtype=tdt)
            vr = randn(B, ML5, hkv, HEAD_DIM, dtype=tdt, std=0.3)
            lr = torch.tensor([ML5 - 1, 300, 129, 20], dtype=torch.int32,
                              device=dev)
            tr = KT.cold_page_table(lr, 0, ML5, 128).clone()
            tr[0, 1] = -1
            rargs = (qr, kr, vr, lr, tr)
            err, rel = decode_errs(PD.paged_decode_flat(*rargs),
                                   PD.paged_decode_flat_plain(*rargs))
            record("paged_decode_flat",
                   f"Hkv={hkv} G={g} ragged, dead page, max_len {ML5}", dt,
                   err, rel=rel)
        # positions 0 and 1 and both sides of a page edge; a slot whose
        # last live page is dead (and one with no live page: zeros); every
        # head dim; G up to 16; B * Hkv >= 132 (no split)
        for (label, Bf, hkv, g, Df, MLf, lens, dead) in (
                ("lengths 0,1,127,128", 4, H3, 1, HEAD_DIM, ML,
                 (0, 1, 127, 128), ()),
                ("last live page dead", 4, H3, 1, HEAD_DIM, ML,
                 (300, 200, 260, 129), ((0, 2), (3, 1))),
                ("Hkv=2 G=6 D=64", 4, KV_HEADS, 6, 64, ML,
                 (318, 300, 257, 290), ()),
                ("Hkv=20 G=1 D=64", 4, H3, 1, 64, ML, (318, 0, 127, 511),
                 ()),
                ("Hkv=2 G=7 D=32 max_len 200", 2, 2, 7, 32, 200, (199, 64),
                 ()),
                ("Hkv=1 G=16 D=16, no live page", 2, 1, 16, 16, 100,
                 (99, 31), ((1, 0),)),
                ("B=8 Hkv=20 (B*Hkv=160)", 8, H3, 1, HEAD_DIM, ML,
                 (318, 300, 257, 290, 511, 0, 128, 200), ())):
            qr = randn(Bf, hkv, g, Df, dtype=tdt)
            kr = randn(Bf, MLf, hkv, Df, dtype=tdt)
            vr = randn(Bf, MLf, hkv, Df, dtype=tdt, std=0.3)
            lr = torch.tensor(lens, dtype=torch.int32, device=dev)
            tr = KT.cold_page_table(lr, 0, MLf, 128).clone()
            for (b_, j_) in dead:
                tr[b_, j_] = -1
            rargs = (qr, kr, vr, lr, tr)
            err, rel = decode_errs(PD.paged_decode_flat(*rargs),
                                   PD.paged_decode_flat_plain(*rargs))
            record("paged_decode_flat",
                   f"{label}, split {PD.flat_split(Bf, hkv, sms)}", dt, err,
                   rel=rel)
        del kf, vf, fargs
        # ---- qkv_proj: mobilevlm-3b (MHA, no bias) and fastvlm-1.7b (GQA
        # with bias): decode M = 1, 3, 4 (the GEMV), M = 5 (the first
        # GEMM row count), a prefix hit's padded 64-row tail and prefill
        # M = 256 / 320. In bf16 the kernel,
        # its twin and torch.addmm over the concatenated weight are timed
        # at decode M = 4 and at prefill
        for (tag, D_, ns, bias, M_pre) in (
                ("mobilevlm", D3, (H3 * HEAD_DIM,) * 3, False, 256),
                ("fastvlm", D_MODEL, (HEADS * HEAD_DIM, KV_HEADS * HEAD_DIM,
                                      KV_HEADS * HEAD_DIM), True, 320)):
            wq3 = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5) for n in ns]
            bq3 = ([randn(n, dtype=tdt, std=0.1) for n in ns] if bias
                   else [None] * 3)
            wcat = torch.cat(wq3, 1)
            bcat = (torch.cat(bq3) if bias else
                    torch.zeros(wcat.shape[1], dtype=tdt, device=dev))
            N = sum(ns)
            for M in (1, 3, 4, 5, HIT_TAIL, M_pre):
                x = randn(M, D_, dtype=tdt)
                err = max(max_err(a, b) for a, b in zip(
                    QK.qkv_proj(x, *wq3, *bq3),
                    QK.qkv_proj_plain(x, *wq3, *bq3)))
                form = qkv_form(M, dt == "bfloat16")
                require(dev.type != "cuda" or QK.qkv_proj.variant == form,
                        f"qkv_proj {tag} M={M} {dt}: ran the "
                        f"{QK.qkv_proj.variant} form, expected {form}")
                extra = ({"split_bound": tf32x3_qkv_bound(x, wq3)}
                         if form == "tf32x3" else None)
                main = None
                if dt == "bfloat16" and M in (4, M_pre):
                    ms, dms = timed(lambda: QK.qkv_proj(x, *wq3, *bq3))
                    lib, lib_dev = timed(lambda: torch.addmm(bcat, x, wcat))
                    b_ms, b_by = bound(
                        pk, (M * D_ + D_ * N + M * N + (N if bias else 0))
                        * es, 2 * M * D_ * N, dt)
                    where = "decode" if M == 4 else "prefill"
                    plain = time_ms(lambda: QK.qkv_proj_plain(x, *wq3, *bq3))
                    results[f"qkv_proj_{tag}_{where}"] = {
                        "M": M, "ms": ms, "device_ms": dms,
                        "plain_ms": plain, "library_ms": lib,
                        "library_device_ms": lib_dev, "bound_ms": b_ms,
                        "bound_by": b_by}
                    if tag == "mobilevlm" and M == 4:
                        main = {"shape": f"x ({M}, {D_}), N 3 x {ns[0]}, "
                                         f"no bias", "ms": ms,
                                "plain_ms": plain, "library_ms": lib,
                                "library_device_ms": lib_dev,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "device_ms": dms}
                    print(f"[kernels]   qkv_proj {tag} {where} M={M}: "
                          f"{us(dms, 1)} device, {ms:.3f} ms call, "
                          f"plain {plain:.3f} ms; "
                          f"torch.addmm {us(lib_dev, 1)} device, "
                          f"{lib:.3f} ms call; bound {1e3 * b_ms:.1f} us")
                record("qkv_proj", f"{tag}{' bias' if bias else ''} M={M} "
                                   f"({form})", dt, err, main, extra)
            del wq3, wcat
        # ---- ffn_act_int8: mobilevlm-3b silu_gated M=4 and M=256 --------
        def int8w(k, n):
            return torch.randint(-127, 128, (k, n), generator=gen,
                                 device=dev, dtype=torch.int8)
        s_up = torch.full((F3,), D3 ** -0.5 / 127, device=dev)
        s_dn = torch.full((D3,), F3 ** -0.5 / 127, device=dev)
        wq8 = (int8w(D3, F3), s_up, int8w(D3, F3), s_up.clone(),
               int8w(F3, D3), s_dn)
        deq = [FF.dequantize(wq8[i], wq8[i + 1]).bfloat16()
               for i in (0, 2, 4)]
        for M in (4, 256):
            x = randn(M, D3, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D3 * F3 + 4 * (2 * F3 + D3), chain_of(x, *deq))
            ffn_case("ffn_act_int8", x, wq8, "silu_gated", dt,
                     f"silu_gated M={M}", ffn_form(M, dt, int8=True), row,
                     M == 4)
        del wq8, deq
        # ---- ffn_act and fused_norm at mobilevlm-3b (path A's shapes) ---
        w3 = (randn(D3, F3, dtype=tdt, std=0.5 * D3 ** -0.5),
              randn(D3, F3, dtype=tdt, std=0.5 * D3 ** -0.5),
              randn(F3, D3, dtype=tdt, std=F3 ** -0.5))
        sc3 = (0.25 + 0.1 * torch.rand(D3, generator=gen, device=dev)).to(tdt)
        for M in (4, 256):
            x = randn(M, D3, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D3 * F3 * es, chain_of(x, *w3))
            ffn_case("ffn_act", x, w3, "silu_gated", dt,
                     f"mobilevlm silu_gated M={M}", ffn_form(M, dt), row)
            record("fused_norm", f"mobilevlm rms M={M}", dt,
                   max_err(FN.fused_norm(x, sc3, None, "rms"),
                           FN.fused_norm_plain(x, sc3, None, "rms")))
        del w3
        # ---- ffn_act and fused_norm at deepseek-v2-lite: layer 0's dense
        # FFN (D 2048, F 10944) at decode M = 4 (the stream form) and
        # prefill M = 256; its 55 norms a model call at D 2048. In bf16
        # both FFN shapes and both norm shapes are timed
        wds = (randn(DS_D, DS_F, dtype=tdt, std=0.5 * DS_D ** -0.5),
               randn(DS_D, DS_F, dtype=tdt, std=0.5 * DS_D ** -0.5),
               randn(DS_F, DS_D, dtype=tdt, std=DS_F ** -0.5))
        scd = (0.25 + 0.1 * torch.rand(DS_D, generator=gen,
                                       device=dev)).to(tdt)
        for M in (4, 256):
            x = randn(M, DS_D, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * DS_D * DS_F * es, chain_of(x, *wds))
            ffn_case("ffn_act", x, wds, "silu_gated", dt,
                     f"deepseek silu_gated M={M}", ffn_form(M, dt), row)
            record("fused_norm", f"deepseek rms M={M} D={DS_D}", dt,
                   max_err(FN.fused_norm(x, scd, None, "rms"),
                           FN.fused_norm_plain(x, scd, None, "rms")))
            if dt == "bfloat16":
                nr = norm_row(x, scd, es)
                results["extra_rows"].append(dict(
                    nr, name="fused_norm", event_ms=None,
                    shape=f"deepseek {nr['shape']}"))
                print(f"[kernels]   fused_norm deepseek x ({M}, {DS_D}): "
                      f"{us(nr['device_ms'])} device, "
                      f"{nr['ms']:.4f} ms call; bound "
                      f"{1e3 * nr['bound_ms']:.2f} us ({nr['bound_by']}); "
                      f"F.rms_norm {nr['library_device_ms']} ms device")
        del wds
        # ---- attn_stream at mobilevlm-3b: G = 1, S = L = 256 ------------
        q = randn(1, H3, 256, HEAD_DIM, dtype=tdt)
        k = randn(1, H3, 256, HEAD_DIM, dtype=tdt)
        v = randn(1, H3, 256, HEAD_DIM, dtype=tdt, std=0.4)
        attn_case("Hkv=20 G=1 causal S=L=256", dt, q, k, v)
        del q, k, v
        dense_widths(dt)
        ssm_widths(dt)
        slice12_widths(dt)
        tp_widths(dt)

    # ragged / odd shapes, f32
    tdt = torch.float32
    x = randn(7, 200, dtype=tdt)
    sc, bi = randn(200, dtype=tdt, std=0.3), randn(200, dtype=tdt, std=0.3)
    record("fused_norm", "layer M=7 D=200", "float32",
           max_err(FN.fused_norm(x, sc, bi, "layer"),
                   FN.fused_norm_plain(x, sc, bi, "layer")))
    # attention at every head dim (bf16: the 32- and 64-byte swizzles at
    # Dh 16 and 32), ragged and GQA, causal S < L and not causal
    for dt in ("float32", "bfloat16"):
        for (S, L, causal, Dh) in ((100, 333, True, 128),
                                   (77, 77, False, 64), (5, 40, True, 16),
                                   (40, 72, True, 32)):
            q = randn(2, 6, S, Dh, dtype=getattr(torch, dt))
            k = randn(2, 3, L, Dh, dtype=getattr(torch, dt))
            v = randn(2, 3, L, Dh, dtype=getattr(torch, dt), std=0.4)
            attn_case(f"S={S} L={L} causal={causal} D={Dh}", dt, q, k, v,
                      causal=causal)
    # the FFN forms on ragged shapes, f32 and bf16: M 1, 3, 5 (the stream
    # form), 63, 65, 257 (wgmma in bf16, the FMA tiles in f32); D 320 (a
    # ragged last 64-deep tile); F 1000 with weights in the model's type
    # (every activation) and F 1024 with int8 weights (gated and not).
    # Rows that are not whole 16-byte vectors take the FMA tiles at any M:
    # int8 at F 1000 or D 200, bf16 at F 1004
    for dt in ("float32", "bfloat16"):
        tq = getattr(torch, dt)
        for i, M in enumerate((1, 3, 5, 63, 65, 257)):
            x = randn(M, 320, dtype=tq)
            for kind in ("silu_gated", "gelu", "gelu_gated", "relu2"):
                wu = randn(320, 1000, dtype=tq, std=0.5 * 320 ** -0.5)
                wg = (randn(320, 1000, dtype=tq, std=0.5 * 320 ** -0.5)
                      if kind.endswith("gated") else None)
                wd = randn(1000, 320, dtype=tq, std=1000 ** -0.5)
                ffn_case("ffn_act", x, (wu, wg, wd), kind, dt,
                         f"{kind} M={M} D=320 F=1000", ffn_form(M, dt))
            for gated in (True, False):
                kind = "silu_gated" if gated else ("gelu", "relu2")[i % 2]
                ffn_case("ffn_act_int8", x, int8_ffn(320, 1024, gated), kind,
                         dt, f"{kind} M={M} D=320 F=1024",
                         ffn_form(M, dt, int8=True))
        for (M, D, F_, kind) in ((5, 320, 1000, "gelu"),
                                 (65, 320, 1000, "relu2"),
                                 (3, 200, 1000, "silu_gated")):
            ffn_case("ffn_act_int8", randn(M, D, dtype=tq),
                     int8_ffn(D, F_, kind == "silu_gated"), kind, dt,
                     f"{kind} M={M} D={D} F={F_} unaligned rows", "fma")
        if dt == "bfloat16":
            for M in (3, 65):
                wu, wg = (randn(320, 1004, dtype=tq, std=0.5 * 320 ** -0.5)
                          for _ in range(2))
                wd = randn(1004, 320, dtype=tq, std=1004 ** -0.5)
                ffn_case("ffn_act", randn(M, 320, dtype=tq), (wu, wg, wd),
                         "silu_gated", dt,
                         f"silu_gated M={M} F=1004 unaligned rows", "fma")
    # ragged rows and column tiles (N = 96 is 3/4 of a 128-wide GEMM tile)
    for dt in ("float32", "bfloat16"):
        tq = getattr(torch, dt)
        for M in (3, 77):
            x = randn(M, 320, dtype=tq)
            ws = [randn(320, n, dtype=tq, std=0.5 * 320 ** -0.5)
                  for n in (96, 32, 32)]
            bs = [randn(n, dtype=tq, std=0.1) for n in (96, 32, 32)]
            record("qkv_proj", f"ragged M={M} N=96/32/32 bias", dt,
                   max(max_err(a, b) for a, b in zip(
                       QK.qkv_proj(x, *ws, *bs),
                       QK.qkv_proj_plain(x, *ws, *bs))))
    results["cases"] = cases
    return results


# ---------------------------------------------------------------------------
# phases 2 and 3: the model through the serving engine
# ---------------------------------------------------------------------------
def _model(arch: str, dtype: str, dev: str = "cuda", **knobs):
    """(cfg, Model, random params from seed 0) at the config's published
    widths; ``knobs`` set config fields (kv_policy, kv_hot_window,
    ffn_weight_store, ...)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype,
                                   **knobs)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, model, model.init(gen, device=dev)


# the three serving configurations: (label, arch, config knobs, backend
# knobs, text tokens of a VQA request, kernels the run must launch)
RUNS = (
    ("fastvlm-1.7b tiered", "fastvlm-1.7b",
     dict(kv_policy="tiered", kv_hot_window=128), {}, 192,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
      "paged_decode_tiered")),
    ("A: mobilevlm-3b flat, fused decode", "mobilevlm-3b",
     dict(kv_policy="flat"), dict(fused_decode=True), 112,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
      "paged_decode_flat")),
    ("B: mobilevlm-3b tiered, int8 FFN", "mobilevlm-3b",
     dict(kv_policy="tiered", kv_hot_window=128, ffn_weight_store="int8"),
     {}, 112,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act_int8",
      "paged_decode_tiered")),
)


def _requests(cfg, n_vqa: int, n_text: int, text_with_image: int,
              text_len: int, gen_len: int, seed: int):
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    f = cfg.frontend              # None on a text-only model: n_vqa = 0
    reqs = []
    for i in range(n_vqa + n_text):
        vqa = i % 2 == 0 and i // 2 < n_vqa
        patches = (rng.standard_normal((f.num_tokens, f.frontend_dim))
                   .astype(np.float32) if vqa else None)
        toks = rng.integers(0, cfg.vocab_size,
                            text_with_image if vqa else text_len)
        reqs.append(Request(rid=i, tokens=toks.astype(np.int32),
                            max_new_tokens=gen_len, patches=patches))
    return reqs


def parity_phase(dev: str = "cuda") -> dict:
    """f32 Engine == generate, tie-aware: fastvlm-1.7b over the tiered
    store (hot window 64), mobilevlm-3b on path A (flat store, fused
    decode through the backend knob; `generate` runs the unfused model)
    and on path B (tiered store, hot window 64, int8 FFN weights: the
    tiered decode at G = 1 and `ffn_act_int8` in f32); then B
    preempted, fastvlm-paged and deepseek-parity."""
    out = {}
    for label, arch, knobs, bknobs in (
            ("fastvlm-1.7b tiered", "fastvlm-1.7b",
             dict(kv_policy="tiered", kv_hot_window=64), {}),
            ("A: mobilevlm-3b flat, fused decode", "mobilevlm-3b",
             dict(kv_policy="flat"), dict(fused_decode=True)),
            ("B: mobilevlm-3b tiered, int8 FFN", "mobilevlm-3b",
             dict(kv_policy="tiered", kv_hot_window=64,
                  ffn_weight_store="int8"), {})):
        out[label] = _parity(label, arch, knobs, bknobs, dev)
    out["B preempted"] = _parity_preempt(dev)
    out["fastvlm-paged"] = _parity_paged(dev)
    out["deepseek-parity"] = _parity_deepseek(dev)
    return out


def prefill_drift(arch: str, knobs: dict, dev: str = "cuda") -> dict:
    """f32, on `_parity`'s 4 text prompts: the residual stream after
    every layer of `Model.prefill` (`generate`'s whole-prompt path)
    against `Model.extend` (the Engine's path: one chunk over the
    workspace, committed): a layer, the largest over the rows of a row's
    largest difference relative to its largest value; printed at a few
    depths with the first layer past 1e-4."""
    import torch

    gc.collect()              # an earlier run's weights, freed first
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg, model, params = _model(arch, "float32", dev, **knobs)
    reqs = _requests(cfg, n_vqa=0, n_text=4, text_with_image=64,
                     text_len=128, gen_len=16, seed=1)
    run, xs = model._run_block, []

    def keep(*a, **kw):
        out = run(*a, **kw)
        xs.append(out[0])
        return out
    model._run_block = keep
    out = {}
    try:
        for r in reqs:
            batch = {"tokens": r.tokens[None]}
            xs.clear()
            model.prefill(params, batch, 224)
            whole = list(xs)
            xs.clear()
            model.extend(params, batch, model.init_extend_cache(1, 224, dev),
                         0, length=r.prompt_len, commit=True)
            # each row's largest difference over its own largest value
            drift = [float(((a - b).abs().amax(-1)
                            / a.abs().amax(-1)).max())
                     for a, b in zip(whole, xs)]
            out[r.rid] = drift
            past = next((i for i, d in enumerate(drift) if d > 1e-4), None)
            picks = sorted({0, 1, 2, 4, 8, 14, 20, len(drift) - 1})
            print(f"[drift] {arch} f32, request {r.rid}: prefill vs extend, "
                  f"largest row max |diff| / max |x| after layer "
                  + ", ".join(f"{i}: {drift[i]:.2e}" for i in picks
                              if i < len(drift))
                  + f"; first past 1e-4: layer {past}")
    finally:
        del model._run_block
    del params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _parity_deepseek(dev, n: int = DS_PARITY_LAYERS) -> dict:
    """deepseek-parity: f32 deepseek-v2-lite at full width, depth cut to
    ``n`` layers (default DS_PARITY_LAYERS: 1 dense + 5 MoE, to keep the
    script's time), tiered latent store (hot window 64), 2 slots, 4 text
    requests (128-token prompts, 16 new tokens): the Engine's tokens
    against `generate`'s, tie rule as above. Full depth (27 layers, 62.8
    GB of f32 weights) is the phase deepseek-full, not run by default:
    there the router's top-k-th and next probabilities come within ~1e-7,
    so the Engine's prefill must round as `generate`'s does; it first
    prints each prompt's prefill-vs-extend drift (`prefill_drift`)."""
    from repro_torch.configs.base import Segment, get_config

    knobs = dict(kv_policy="tiered", kv_hot_window=64, num_layers=n,
                 segments=(Segment(("mla",), n),))
    full = get_config("deepseek-v2-lite")
    cut = full.replace(param_dtype="float32", **knobs)
    print(f"[parity] deepseek-parity: f32, full width (d_model "
          f"{cut.d_model}, {cut.moe.num_experts} experts top-"
          f"{cut.moe.top_k}, kv_lora_rank {cut.mla.kv_lora_rank}), depth "
          f"cut from {full.num_layers} to {n} layers (1 dense + {n - 1} "
          f"MoE): {cut.param_count():,} parameters, "
          f"{4 * cut.param_count() / 1e9:.1f} GB in f32 (full depth "
          f"{4 * full.param_count() / 1e9:.1f} GB: phase deepseek-full)")
    if n > DS_PARITY_LAYERS:
        prefill_drift("deepseek-v2-lite", knobs, dev)
    res = _parity(f"deepseek-parity ({n} layers)", "deepseek-v2-lite",
                  knobs, {}, dev, n_vqa=0, slots=2)
    res["layers"] = n
    return res


@contextlib.contextmanager
def routing_log(who: dict):
    """While open, every `apply_moe` call records, for each row of its
    input that ``who`` names (``who["rids"][b]``: a request id or None;
    ``who["pos"][b]``: its first row's position; ``who["len"]``: the
    valid rows), the sorted top-k experts and the gap between the k-th
    and the next router probability, one entry a MoE layer in layer
    order: ``log[rid][position]``. Yields ``log``."""
    import torch

    from repro_torch.models import layers as L

    moe, log = L.apply_moe, {}

    def probe(p, cfg, x, dropless=True, tp=None):
        k = cfg.moe.top_k
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        top = probs.topk(k + 1, dim=-1)
        ex = top.indices[:, :k].sort(-1).values.tolist()
        gap = (top.values[:, k - 1] - top.values[:, k]).tolist()
        S = x.shape[1]
        for b, rid in enumerate(who["rids"]):
            for s_ in range(min(S, who["len"]) if rid is not None else 0):
                log.setdefault(rid, {}).setdefault(
                    int(who["pos"][b]) + s_, []).append(
                    (tuple(ex[b * S + s_]), gap[b * S + s_]))
        return moe(p, cfg, x, dropless, tp=tp)
    L.apply_moe = probe
    try:
        yield log
    finally:
        L.apply_moe = moe


def first_routing_split(a: dict, b: dict):
    """(position, MoE layer, gap in a, gap in b) of the first row whose
    routed experts differ between two runs' logs of one request, or
    None."""
    for pos in sorted(set(a) & set(b)):
        for li, ((ea, ga), (eb, gb)) in enumerate(zip(a[pos], b[pos])):
            if ea != eb:
                return pos, li, ga, gb
    return None


# The f32 parity runs' tie rule. Two runs of one request part at a step
# only where their top-2 logits swap, which needs the reference's top-2
# margin below twice the largest |logit| difference between the runs
# there; the threshold is TIE_FACTOR x the difference measured at the
# steps before the split (twice that again for its growth at the split
# itself), never below the fixed rule of earlier runs, TIE_FLOOR. The
# batched decode's GEMMs (M = slots) round apart from `generate`'s (M 1)
# by a drift that grows with depth and weights: at other random weights
# rwkv6-7b's streams parted at a margin of 3.131e-3, above the floor.
TIE_FLOOR = 1e-3
TIE_FACTOR = 4.0


def tie_threshold(drift: float) -> float:
    return max(TIE_FLOOR, TIE_FACTOR * drift)


def margin_of(row) -> float:
    """The top-2 margin of one logits row."""
    top2 = row.float().topk(2).values
    return float(top2[0] - top2[1])


def split_of(got: list, want: list) -> int | None:
    """The first step where two token streams differ (None: equal)."""
    return next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def logit_drift(runs: list) -> float:
    """The largest |logit| difference over ``runs``, each (rows of one
    run, rows of the other, its split or None), at the steps before its
    split."""
    worst = 0.0
    for a, b, split in runs:
        n = min(len(a), len(b)) if split is None else split
        for t in range(n):
            worst = max(worst, float((a[t].float().cpu()
                                      - b[t].float().cpu()).abs().max()))
    return worst


def _require_tie(label, rid, step: int, got: int, want: int,
                 margin: float, drift: float, note: str = "") -> None:
    """A differing token passes only where the reference run's top-2
    logit margin at that step is below the run's `tie_threshold`."""
    thr = tie_threshold(drift)
    print(f"[tie] {label} request {rid} step {step}: token {got} != "
          f"{want}; top-2 margin {margin:.3e}, logit drift {drift:.3e}, "
          f"threshold {thr:.3e} ({TIE_FACTOR:g} x drift, floor "
          f"{TIE_FLOOR:g})")
    require(margin < thr, f"{label} request {rid} step {step}: token "
            f"{got} != {want} with top-2 margin {margin:.3e} above the "
            f"threshold {thr:.3e} (not a tie){note}")


@contextlib.contextmanager
def engine_logits(engine):
    """While open, each request's logits rows in token order as the
    Engine's `LocalBackend` computes them: the committing extend's last
    row (the first token), then its slot's row of each batched decode
    step that the step's ``active`` mask marks. Yields {rid: [rows]}
    (f32, on the host)."""
    import numpy as np

    backend = engine.backend
    model = backend.model
    log, rows = {}, []
    ext, dec, bdec = model.extend, model.decode_step, backend.decode_step

    def decode_step(toks, state, pos, active):
        rows[:] = [r.rid if a and r is not None else None
                   for r, a in zip(engine._slot_req, np.asarray(active))]
        return bdec(toks, state, pos, active)

    def extend(params, batch, cache, pos, length=None, commit=False,
               specs=None):
        out = ext(params, batch, cache, pos, length, commit, specs)
        if commit:
            log.setdefault(engine._inflight.req.rid, []).append(
                out[0][0, -1].float().cpu())
        return out

    def model_decode(params, tokens, cache, pos, specs=None):
        out = dec(params, tokens, cache, pos, specs)
        for b, rid in enumerate(rows):
            if rid is not None:
                log.setdefault(rid, []).append(out[0][b, -1].float().cpu())
        return out
    swaps = ((model, "extend", extend), (model, "decode_step", model_decode),
             (backend, "decode_step", decode_step))
    kept = [(o, n, n in vars(o), getattr(o, n)) for o, n, _ in swaps]
    for o, n, f in swaps:
        setattr(o, n, f)
    try:
        yield log
    finally:
        for o, n, had, prev in kept:
            if had:
                setattr(o, n, prev)
            else:          # no cycle through the wrappers keeps the weights
                delattr(o, n)


def _parity_paged(dev) -> dict:
    """fastvlm-paged: f32 fastvlm-1.7b at full width and depth, tiered
    store (hot window 64), 2 slots, max_len 512, paged + prefix cache: 4
    VQA requests on one image (64 patches) and one 192-token system
    prompt (a 256-token head: 2 blocks of 128), questions of 40, 48, 36
    and 44 tokens (each tail padded to the 64-row bucket), 16 new tokens;
    the first commits before the rest are submitted. The tokens against
    the same requests, submitted the same way, on a slot-pool Engine
    (paged=False) over the same backend (tie rule as above); 3 hits of
    256 tokens each."""
    import torch

    from repro_torch.serving import Engine, LocalBackend

    label, head = "fastvlm-paged", 256
    cfg, model, params = _model("fastvlm-1.7b", "float32", dev,
                                kv_policy="tiered", kv_hot_window=64)
    backend = LocalBackend(model, params, 2, 512, device=dev)
    runs, logs = {}, {}
    for paged in (True, False):
        reqs = _shared_head_requests(cfg, [40, 48, 36, 44], gen_len=16,
                                     seed=6)
        engine = Engine(backend, paged=paged)
        with engine_logits(engine) as logs[paged]:
            engine.submit(reqs[0])
            _until_committed(engine, reqs[0])
            engine.run(reqs[1:])
        runs[paged] = engine, reqs
    engine, reqs = runs[True]
    st = engine.stats
    require(st["prefix_hits"] == 3 and st["prefix_hit_tokens"] == 3 * head,
            f"{label}: {st['prefix_hits']} hits of "
            f"{st['prefix_hit_tokens']} tokens, expected 3 of {head}")
    engine.block_pool.check_invariants()
    require(engine.block_pool.total_refcount == 0,
            f"{label}: refcounts leaked past the drain")
    want = {r.rid: r.generated for r in runs[False][1]}
    ties = 0
    splits = {r.rid: split_of(r.generated, want[r.rid]) for r in reqs}
    drift = logit_drift([(logs[True][rid], logs[False][rid], sp)
                         for rid, sp in splits.items()])
    print(f"[parity] {label}: logit drift paged vs slot pool before any "
          f"split {drift:.3e} (tie threshold {tie_threshold(drift):.3e})")
    for r in reqs:
        got, ref = r.generated, want[r.rid]
        require(len(got) == len(ref) == r.max_new_tokens,
                f"{label} request {r.rid}: token counts {len(got)}, "
                f"{len(ref)}")
        t = splits[r.rid]
        if t is not None:
            _require_tie(label, r.rid, t, got[t], ref[t],
                         margin_of(logs[False][r.rid][t]), drift)
            ties += 1
        print(f"[parity] {label}: request {r.rid} (prompt {r.prompt_len}, "
              f"prefix hit {r.prefix_hit}): paged == slot pool "
              f"{'(tie-broken)' if got != ref else ''}: {got[:8]}...")
    del runs, engine, backend, params, logs
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "tie_breaks": ties, "logit_drift": drift,
            "prefix_hits": st["prefix_hits"],
            "prefix_hit_tokens": st["prefix_hit_tokens"]}


def _parity_preempt(dev) -> dict:
    """f32, path B (hot window 64, int8 FFN), 2 slots and 2 verbatim
    spill lanes: 2 priority-0 VQA requests, then after 3 steps a
    priority-1 text request that preempts one of them. The preempted
    Engine's tokens against the same requests served by an unpressured
    Engine (same backend, equal priorities: nobody is evicted); the
    decode batch is the 2 slots in both, so a verbatim restore should
    give the same tokens bit for bit. A differing token passes only at a
    tie of the unpressured run's logits (`_require_tie`, the drift
    between the two runs' logits before their split)."""
    import copy

    import torch

    from repro_torch.serving import Engine, LocalBackend

    label = "B preempted"
    cfg, model, params = _model("mobilevlm-3b", "float32", dev,
                                kv_policy="tiered", kv_hot_window=64,
                                ffn_weight_store="int8")
    reqs = _requests(cfg, n_vqa=2, n_text=1, text_with_image=64,
                     text_len=128, gen_len=16, seed=1)
    calm_reqs = copy.deepcopy(reqs)
    (text,) = [r for r in reqs if r.patches is None]
    text.priority = 1
    backend = LocalBackend(model, params, 2, 224, device=dev, n_spill=2,
                           spill_compress=False)
    engine = Engine(backend)
    with engine_logits(engine) as pressed:
        for r in reqs:
            if r is not text:
                engine.submit(r)
        for _ in range(3):
            engine.step()
        engine.run([text])
    st = engine.stats
    require(st["evictions"] > 0 and st["restores"] == st["evictions"],
            f"{label}: the priority-1 request preempted nothing: {st}")
    calm = Engine(backend)
    with engine_logits(calm) as calm_log:
        calm.run(calm_reqs)
    require(calm.stats["evictions"] == 0, f"{label}: unpressured run "
            f"evicted: {calm.stats}")
    want = {r.rid: r.generated for r in calm.finished}
    ties = 0
    splits = {r.rid: split_of(r.generated, want[r.rid])
              for r in engine.finished}
    drift = logit_drift([(pressed[rid], calm_log[rid], sp)
                         for rid, sp in splits.items()])
    print(f"[parity] {label}: logit drift preempted vs unpressured before "
          f"any split {drift:.3e} (tie threshold "
          f"{tie_threshold(drift):.3e})")
    for r in sorted(engine.finished, key=lambda r: r.rid):
        got, ref = r.generated, want[r.rid]
        require(len(got) == len(ref) == r.max_new_tokens,
                f"{label} request {r.rid}: token counts {len(got)}, "
                f"{len(ref)}")
        t = splits[r.rid]
        if t is not None:
            _require_tie(label, r.rid, t, got[t], ref[t],
                         margin_of(calm_log[r.rid][t]), drift)
            ties += 1
        print(f"[parity] {label}: request {r.rid} (priority {r.priority}, "
              f"{r.n_evictions} evictions, prompt {r.prompt_len}): "
              f"preempted == unpressured "
              f"{'(tie-broken)' if got != ref else ''}: {got[:8]}...")
    del engine, calm, backend, params, pressed, calm_log
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "tie_breaks": ties, "logit_drift": drift,
            "evictions": st["evictions"]}


def _parity(label, arch, knobs, bknobs, dev, n_vqa: int = 2,
            slots: int = 4, max_len: int = 224, make_reqs=None,
            engine_kw=None) -> dict:
    """f32 Engine == generate (tie rule), 4 requests of 16 new tokens:
    ``n_vqa`` VQA (64 text tokens) and text of 128, or ``make_reqs(cfg)``'s;
    ``engine_kw`` goes to the Engine (e.g. chunk_tokens). On a MoE model
    both runs' routing is logged (`routing_log`), so a failure says
    where it first parted and at what router gaps. The run's peak device
    memory is printed and returned."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.serving import Engine, LocalBackend

    if dev == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _model(arch, "float32", dev, **knobs)
    reqs = (make_reqs(cfg) if make_reqs is not None else
            _requests(cfg, n_vqa=n_vqa, n_text=4 - n_vqa,
                      text_with_image=64, text_len=128, gen_len=16, seed=1))
    backend = LocalBackend(model, params, slots, max_len, device=dev,
                           **bknobs)
    for k, v in bknobs.items():
        require(getattr(backend, k) == v, f"{label}: backend {k} != {v}")
    engine = Engine(backend, **(engine_kw or {}))
    moe = cfg.moe is not None
    who = {"rids": [], "pos": [], "len": 0}
    ext_fn, dec_fn = backend.extend_step, backend.decode_step

    def extend_step(batch, state, ext, slot, pos, length, commit):
        who.update(rids=[engine._inflight.req.rid], pos=[int(pos)],
                   len=int(length))
        return ext_fn(batch, state, ext, slot, pos, length, commit)

    def decode_step(toks, state, pos, active):
        who.update(rids=[r.rid if act and r is not None else None
                         for r, act in zip(engine._slot_req, active)],
                   pos=np.asarray(pos).tolist(), len=1)
        return dec_fn(toks, state, pos, active)
    if moe:
        backend.extend_step, backend.decode_step = extend_step, decode_step
    with (routing_log(who) if moe else contextlib.nullcontext({})) as e_log:
        with engine_logits(engine) as e_rows:
            done = {r.rid: r.generated for r in engine.run(reqs)}
    if moe:             # no cycle through the wrappers keeps the weights
        del backend.extend_step, backend.decode_step
    stats = dict(engine.stats)
    ties = 0
    pre, dec = model.prefill, model.decode_step

    def prefill(params, batch, max_len, length=None):
        who.update(pos=[0], len=1 << 30)
        return pre(params, batch, max_len, length)

    def decode(params, tokens, cache, pos):
        who.update(pos=[int(pos)], len=1)
        return dec(params, tokens, cache, pos)
    model.prefill, model.decode_step = prefill, decode
    gens = {}
    for r in reqs:
        batch = {"tokens": r.tokens[None]}
        if r.patches is not None:
            batch["patches"] = r.patches[None]
        # the unfused model: on path A its flat decode is store_read +
        # softmax, so the parity also holds paged_decode_flat against a
        # path that does not run it
        who["rids"] = [r.rid]
        with (routing_log(who) if moe else
              contextlib.nullcontext({})) as g_log:
            toks, _, logits = generate(model, params, batch,
                                       r.prompt_len, r.max_new_tokens,
                                       device=dev, return_logits=True)
        ref = toks[0].tolist()
        got = done[r.rid]
        require(len(got) == len(ref) == r.max_new_tokens,
                f"{label} request {r.rid}: token counts {len(got)}, "
                f"{len(ref)}")
        gens[r.rid] = (ref, list(logits[0].float().cpu()), g_log)
    del model.prefill, model.decode_step
    splits = {rid: split_of(done[rid], g[0]) for rid, g in gens.items()}
    drift = logit_drift([(e_rows[rid], gens[rid][1], sp)
                         for rid, sp in splits.items()])
    print(f"[parity] {label}: logit drift Engine vs generate before any "
          f"split {drift:.3e} (tie threshold {tie_threshold(drift):.3e})")
    for r in reqs:
        got = done[r.rid]
        ref, rows, g_log = gens[r.rid]
        t, note = splits[r.rid], ""
        if t is not None:   # the streams legitimately diverge after a tie
            split = first_routing_split(e_log.get(r.rid, {}),
                                        g_log.get(r.rid, {}))
            _require_tie(label, r.rid, t, got[t], ref[t],
                         margin_of(rows[t]), drift,
                         "" if not moe else
                         "; routing first parts nowhere" if split is None
                         else f"; routing first parts at position "
                              f"{split[0]}, MoE layer {split[1]}, router "
                              f"gaps {split[2]:.3e} (Engine) / "
                              f"{split[3]:.3e}")
            ties += 1
            note = f"(tie-broken at step {t})"
        print(f"[parity] {label}: request {r.rid} "
              f"({'VQA' if r.patches is not None else 'text'}, prompt "
              f"{r.prompt_len}): engine == generate {note}: {got[:8]}...")
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"[parity] {label}: {ties} ties broken; peak device memory "
          f"{peak / 1e9:.2f} GB ({cfg.param_count():,} parameters, "
          f"{4 * cfg.param_count() / 1e9:.1f} GB in f32)")
    del engine, backend, params, e_rows, gens
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "tie_breaks": ties, "logit_drift": drift,
            "prefill_chunks": stats["prefill_chunks"],
            "peak_memory_allocated": peak}


# the dense attention archs (stablelm-12b, starcoder2-7b, paligemma-3b):
# (phase, arch, config knobs, backend knobs, VQA requests, text tokens of
# a VQA request, kernels the bf16 run must launch). starcoder2's FFN has
# biases, so it takes the plain path, as in the reference: no FFN kernel
DENSE_RUNS = (
    ("stablelm", "stablelm-12b", dict(kv_policy="tiered", kv_hot_window=128),
     {}, 0, 0, ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
                "paged_decode_tiered")),
    ("starcoder2", "starcoder2-7b", dict(kv_policy="flat"),
     dict(fused_decode=True), 0, 0,
     ("fused_norm", "qkv_proj", "attn_stream", "paged_decode_flat")),
    ("paligemma", "paligemma-3b", dict(kv_policy="tiered", kv_hot_window=128),
     {}, 4, 64, ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
                 "paged_decode_tiered")),
)
# the f32 parity runs' depth (full width): every arch at full depth --
# stablelm-12b is 48.6 GB in f32 at its 40 layers, starcoder2-7b 29.6 GB
# at 32, paligemma-3b 10.0 GB at 18; each run prints its peak memory
DENSE_PARITY_LAYERS = {"stablelm": 40, "starcoder2": 32, "paligemma": 18}


# the recurrent archs, as DENSE_RUNS: rwkv6-7b (attention-free, no KV
# store: CHIME tiering does not apply, its config says so; the channel mix
# is plain, as in the reference, so only fused_norm runs) and zamba2-1.2b
# (Mamba2 + one shared attention block, 6 applications over the tiered
# store: CHIME's mapping, with KV only in those 6)
# the bf16 serving runs of the recurrent archs keep their first layers
# only (the f32 parity runs stay at full depth): their prefill profiles
# trace ~45,000 / ~21,000 launches at full depth, and the whole script
# must fit its time limit on a slow host (1,119.9 s of 1,200 at full
# depth on an H100 whose build took 158 s). rwkv6-7b keeps 8 of 32
# layers, zamba2-1.2b two repeats of its 6-layer pattern (10 Mamba2
# layers + 2 shared-block applications of 38)
SERVE_LAYERS = {"rwkv6": 8, "zamba2": 12}


def first_layers(cfg, n: int) -> dict:
    """Config knobs cutting ``cfg`` to its first ``n`` layers, whole
    repeats of each segment's pattern."""
    from repro_torch.configs.base import Segment
    segs, left = [], n
    for seg in cfg.segments:
        r = min(seg.repeats, left // len(seg.pattern))
        if r:
            segs.append(Segment(seg.pattern, r))
            left -= r * len(seg.pattern)
    require(left == 0, f"{cfg.name}: {n} layers are not whole repeats")
    return dict(num_layers=n, segments=tuple(segs))


SSM_RUNS = (
    ("rwkv6", "rwkv6-7b", {}, {}, 0, 0, ("fused_norm",)),
    ("zamba2", "zamba2-1.2b", dict(kv_policy="tiered", kv_hot_window=128),
     {}, 0, 0, ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
                "paged_decode_tiered")),
)


# llama4-maverick-400b, as DENSE_RUNS, at a 2-layer cut: its 48 layers
# hold 32.2 GB of bf16 experts each, so one card holds 2 (bf16) or 1
# (f32); every layer is MoE (128 routed experts top-1 + 1 shared, plain
# batched matmuls as in the reference), so no FFN kernel runs
LLAMA_LAYERS = {"bfloat16": 2, "float32": 1}
MOE_RUNS = (
    ("llama4", "llama4-maverick-400b",
     dict(kv_policy="tiered", kv_hot_window=128,
          num_layers=LLAMA_LAYERS["bfloat16"], segments=()),
     {}, 0, 0, ("fused_norm", "qkv_proj", "attn_stream",
                "paged_decode_tiered")),
)


def ssm_parity(key: str, dev: str = "cuda") -> dict:
    """<key>-parity: f32 at full width and depth, 4 slots, 16 new tokens:
    the Engine's tokens against `generate`'s (tie rule as above). rwkv6:
    4 text requests of 128 (one chunk of its grid each), max_len 224.
    zamba2: tiered (hot window 64), max_len 384, 2 requests of 128 and 2
    of 300, the Engine prefilling in chunks of 128 (its chunk unit: 128 +
    128 + 44 for a 300-token prompt) while `generate` prefills each prompt
    whole, so the chunked requests are held to the whole-prompt path."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.serving import Request

    _, arch, knobs, bknobs, _, _, _ = next(r for r in SSM_RUNS
                                           if r[0] == key)
    full = get_config(arch)
    mixers = "+".join(sorted({m for sg in full.segments
                              for m in sg.pattern}))
    print(f"[parity] {key}-parity: f32, full width and depth ({arch}: "
          f"{full.num_layers} layers of {mixers}, d_model {full.d_model}, "
          f"heads {full.num_heads} x {full.head_dim}, {full.mlp_type} d_ff "
          f"{full.d_ff}, vocab {full.vocab_size}, ssm chunk "
          f"{full.ssm.chunk_size})")
    if key == "rwkv6":
        res = _parity(f"{key}-parity", arch, knobs, bknobs, dev, n_vqa=0)
        res["layers"] = full.num_layers
        return res

    def make_reqs(cfg):
        rng = np.random.default_rng(1)
        return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=16)
                for i, n in enumerate((300, 128, 300, 128))]
    chunk = full.ssm.chunk_size
    res = _parity(f"{key}-parity", arch, dict(knobs, kv_hot_window=64),
                  bknobs, dev, max_len=384, make_reqs=make_reqs,
                  engine_kw=dict(chunk_tokens=chunk))
    # at least 3 chunks for a prompt of 300 and 1 for one of 128 (the
    # scheduler's budget may cut a chunk shorter, on the grid)
    least = sum(-(-r.prompt_len // chunk) for r in make_reqs(full))
    require(res["prefill_chunks"] >= least, f"{key}-parity: "
            f"{res['prefill_chunks']} prefill chunks, fewer than {least}")
    print(f"[parity] {key}-parity: 2 prompts of 300 prefilled in chunks of "
          f"at most {chunk} (+ 2 of 128): {res['prefill_chunks']} chunks, "
          f"tokens == the whole-prompt path ({res['tie_breaks']} ties "
          f"broken)")
    res["layers"] = full.num_layers
    return res


def dense_parity(key: str, dev: str = "cuda") -> dict:
    """<key>-parity: f32 at full width (depth DENSE_PARITY_LAYERS), 4
    slots, max_len 384, 2 VQA (256 image + 64 text tokens) + 2 text
    requests of 128 on paligemma, 4 text elsewhere, 16 new tokens: the
    Engine's tokens against `generate`'s (tie rule as above). The tiered
    runs use hot window 64, starcoder2 the flat store with fused decode
    (paged_decode_flat at G 9)."""
    from repro_torch.configs.base import get_config

    _, arch, knobs, bknobs, n_vqa, _, _ = next(r for r in DENSE_RUNS
                                               if r[0] == key)
    full = get_config(arch)
    n = DENSE_PARITY_LAYERS[key]
    knobs = dict(knobs, **({"kv_hot_window": 64}
                           if knobs["kv_policy"] == "tiered" else {}))
    if n < full.num_layers:
        knobs.update(num_layers=n, segments=())
    print(f"[parity] {key}-parity: f32, full width (d_model "
          f"{full.d_model}, heads {full.num_heads} / {full.num_kv_heads} x "
          f"{full.head_dim}, d_ff {full.d_ff}), depth {n} of "
          f"{full.num_layers} layers{' (cut)' if n < full.num_layers else ''}"
          f", {knobs['kv_policy']} store")
    res = _parity(f"{key}-parity", arch, knobs, bknobs, dev,
                  n_vqa=min(n_vqa, 2), max_len=384)
    res["layers"] = n
    return res


def dense_run(key: str, pk: dict, dev: str = "cuda", after=None) -> dict:
    """<key>: bf16 at full width and depth, weights built on the card,
    4 slots, max_len 512, 8 requests (paligemma: 4 VQA with 256 image +
    64 text tokens and 4 text of 256; else 8 text of 256), 64 new each,
    a Telemetry hub riding along: exact launches a model call (two norms
    a layer and the final one, one projection a layer, the FFN kernel a
    layer unless the FFN has biases; attn_stream a layer at prefill and
    extend, the run's paged decode a layer at decode), write-once, the
    ledger == simulated_efficiency, chime_sim on CHIME and M3D-DRAM-only,
    the profiles, and the peak device memory after init and after the
    run. ``after(model, params, res)`` runs last, on the run's weights."""
    import torch

    from repro_torch.serving import Telemetry
    from repro_torch.tree import tree_leaves

    from repro_torch.configs.base import get_config

    _, arch, knobs, bknobs, n_vqa, twi, needs = next(
        r for r in DENSE_RUNS + SSM_RUNS + MOE_RUNS if r[0] == key)
    if key in SERVE_LAYERS:
        knobs = dict(knobs, **first_layers(get_config(arch),
                                           SERVE_LAYERS[key]))
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    gc.collect()              # an earlier run's backend, freed first
    mem_before = 0
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    built = _model(arch, "bfloat16", dev, **knobs)
    sync()
    init_s = time.perf_counter() - t0
    cfg, model, params = built
    mem_init = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n_params = sum(t.numel() for t in tree_leaves(params))
    mixers = "+".join(sorted({u.block.mixer for u in model.plan}))
    print(f"[serving] {key}: {arch}, {cfg.num_layers} layers ({mixers}), "
          f"d_model {cfg.d_model}, heads {cfg.num_heads} / "
          f"{cfg.num_kv_heads} x {cfg.head_dim}, {cfg.mlp_type} d_ff "
          f"{cfg.d_ff}: {n_params:,} parameters ({2 * n_params / 1e9:.2f} "
          f"GB bf16) built on the card in {init_s:.1f} s; peak device "
          f"memory after init {mem_init / 1e9:.2f} GB "
          f"({mem_before / 1e9:.2f} GB allocated before it)")
    res = serve_run(key, arch, knobs, bknobs, twi, needs, dev=dev,
                    built=built, n_vqa=n_vqa, telemetry=Telemetry())
    ext, dec = res["extend_calls"], res["decode_steps_engine"]
    n_norm, n_gqa, n_ffn = plan_counts(model)
    per_call = {k: v / (ext + dec) for k, v in res["launches"].items()}
    want = {"fused_norm": n_norm, "qkv_proj": n_gqa,
            "ffn_act": n_ffn if "ffn_act" in needs else 0,
            "ffn_act_int8": 0,
            "attn_stream": n_gqa * ext / (ext + dec),
            "paged_decode_tiered": (n_gqa * dec / (ext + dec)
                                    if cfg.kv_policy == "tiered" else 0),
            "paged_decode_flat": (n_gqa * dec / (ext + dec)
                                  if cfg.kv_policy == "flat" else 0)}
    require(per_call == want, f"{key}: launches a model call {per_call}, "
                              f"planned {want}")
    print(f"[serving] {key}: launches a model call over {ext} extends and "
          f"{dec} decode steps: fused_norm {per_call['fused_norm']:.0f}, "
          f"qkv_proj {per_call['qkv_proj']:.0f}, ffn_act "
          f"{per_call['ffn_act']:.0f}; attn_stream {n_gqa} an extend, "
          f"the paged decode {n_gqa} a decode step ({res['launches']})")
    mem_run = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"[serving] {key}: peak device memory after the run "
          f"{mem_run / 1e9:.2f} GB")
    floor = weight_floor(model, params, pk)
    busy = res.get("profile", {}).get("device_ms_per_step")
    print(f"[serving] {key}: decode busy {us(busy, unit='ms')} a step "
          f"against the weight floor {floor['ms']:.2f} ms "
          f"({floor['bytes'] / 1e9:.2f} GB read once a step at "
          f"{pk['bw'] / 1e12:.2f} TB/s: {floor['what']})")
    res.update({"params": n_params, "init_s": init_s,
                "memory_allocated_before_init": mem_before,
                "max_memory_allocated_init": mem_init,
                "max_memory_allocated_run": mem_run,
                "weight_floor": floor})
    res.pop("finished")
    if after is not None:
        after(model, params, res)
    del built, cfg, model, params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def weight_floor(model, params, pk: dict) -> dict:
    """The bytes one decode step must read: every weight once (the
    embedding table only where it is also the tied head; its 4 gathered
    rows are left out) and the shared attention block once for each
    application; their time at the card's memory rate."""
    from repro_torch.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    total = nbytes(params)
    what = "every weight once"
    if not model.cfg.tie_embeddings:
        total -= nbytes(params["embed"])
        what += ", the embedding table left out"
    if "shared_attn" in params:
        apps = sum(u.repeats for u in model.plan
                   if u.block.mixer == "attn_shared")
        total += (apps - 1) * nbytes(params["shared_attn"])
        what += f", the shared attention block {apps} times"
    return {"bytes": total, "ms": 1e3 * total / pk["bw"], "what": what}


def serving_phase(pk: dict, dev: str = "cuda") -> dict:
    """The three bf16 serving runs of RUNS, each with its launch check
    and its chime_sim price, then path B with its weights streamed
    (B-stream) and under preemption (PREEMPT_RUNS), then fastvlm-1.7b
    over the prefix cache (fastvlm-prefix), then deepseek-v2-lite
    (deepseek: MLA and the dropless MoE)."""
    import torch
    out = {}
    for run in RUNS:
        out[run[0]] = serve_run(*run, dev=dev)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    finished = {k: r.pop("finished") for k, r in out.items()}
    a, b = (out[RUNS[i][0]] for i in (1, 2))
    b_chime = b["sim"]["sim_tokens_per_j"]
    print(f"[sim] chime_sim analytic, on the traces this card served: B "
          f"(CHIME mapping) on CHIME {b_chime:.2f} tok/J vs A (flat "
          f"store) on the M3D-DRAM-only platform "
          f"{a['sim_dram_only']['sim_tokens_per_j']:.2f} tok/J (= "
          f"{b_chime / a['sim_dram_only']['sim_tokens_per_j']:.3f}x) and "
          f"on CHIME {a['sim']['sim_tokens_per_j']:.2f} tok/J")
    _, arch, knobs, _, _, _ = RUNS[2]
    built = _model(arch, "bfloat16", dev, **knobs)    # B's weights again
    out["B-stream"] = stream_run(built, b, finished[RUNS[2][0]], dev=dev)
    for label, bknobs, eknobs in PREEMPT_RUNS:
        out[label] = preempt_run(label, bknobs, eknobs, pk, built, dev=dev)
        if dev == "cuda":
            torch.cuda.empty_cache()
    del built
    out["fastvlm-prefix"] = prefix_run(dev=dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["deepseek"] = deepseek_run(pk, dev=dev)
    return out


def deepseek_run(pk: dict, dev: str = "cuda") -> dict:
    """deepseek: bf16 deepseek-v2-lite at full width and depth (27 MLA
    layers, the dense first one and 26 of 64 routed experts top-6 plus 2
    shared; 31.4 GB of weights, built on the card) over the tiered
    latent store (hot window 128), max_len 512, 4 slots, 8 text requests
    of 256 tokens with 64 new each, a Telemetry hub riding along: exact
    launches (fused_norm 55 and ffn_act 1 a model call, nothing else),
    write-once on the cold latent tier, the ledger == simulated_efficiency,
    chime_sim on CHIME and M3D-DRAM-only, the profiles with their top
    ops, the peak device memory after init and after the run, and
    `apply_moe` and `apply_mla_decode` run once more on one decode
    step's inputs under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch

    from repro_torch.serving import Telemetry
    from repro_torch.tree import tree_leaves

    label = "deepseek"
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    # an earlier run's backend lives on in a reference cycle (its timed
    # decode_step closes over the bound method) until the collector runs
    gc.collect()
    mem_before = 0
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    built = _model("deepseek-v2-lite", "bfloat16", dev, kv_policy="tiered",
                   kv_hot_window=128)
    sync()
    init_s = time.perf_counter() - t0
    cfg, model, params = built
    mem_init = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[serving] {label}: {n_params:,} parameters ({cfg.param_count():,}"
          f" counted by the config, norm scales aside; "
          f"{2 * n_params / 1e9:.2f} GB bf16) built on the card in "
          f"{init_s:.1f} s; peak device memory after init "
          f"{mem_init / 1e9:.2f} GB ({mem_before / 1e9:.2f} GB allocated "
          f"before it)")
    res = serve_run(label, "deepseek-v2-lite", None, {}, 0,
                    ("fused_norm", "ffn_act"), dev=dev, built=built,
                    n_vqa=0, telemetry=Telemetry())
    ext = res["extend_calls"]
    dec = res["decode_steps_engine"]
    per_call = {k: n / (ext + dec) for k, n in res["launches"].items()}
    # 2 norms a layer and the final one (55 at full depth); the FFN kernel
    # in the dense first layer only
    require(per_call["fused_norm"] == 2 * cfg.num_layers + 1
            and per_call["ffn_act"] == cfg.moe.first_dense_layers,
            f"{label}: launches a model call {per_call}")
    print(f"[serving] {label}: launches a model call over {ext} extends "
          f"and {dec} decode steps: {per_call}")
    mem_run = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"[serving] {label}: peak device memory after the run "
          f"{mem_run / 1e9:.2f} GB")
    res.update({"params": n_params, "init_s": init_s,
                "memory_allocated_before_init": mem_before,
                "max_memory_allocated_init": mem_init,
                "max_memory_allocated_run": mem_run,
                "sync_free": sync_free_check(label, model, params, dev)})
    res.pop("finished")
    return res


def sync_free_check(label, model, params, dev: str = "cuda") -> dict:
    """Capture `layers.apply_moe`'s and, on an MLA model,
    `fusion.apply_mla_decode`'s first call of one batched decode step (4
    slots), then run each again on those inputs with the device's sync
    debug mode at "error": a host synchronisation inside either raises."""
    import torch

    from repro_torch.core import fusion
    from repro_torch.models import layers as L
    from repro_torch.serving import Engine, LocalBackend

    reqs = _requests(model.cfg, n_vqa=0, n_text=4, text_with_image=0,
                     text_len=64, gen_len=8, seed=5)
    engine = Engine(LocalBackend(model, params, 4, 512, device=dev))
    for r in reqs:
        engine.submit(r)
    while engine._inflight is not None or engine.scheduler.pending \
            or int(engine._active.sum()) < len(reqs):
        engine.step()
    fns = {"apply_moe": (L, L.apply_moe)}
    if any(u.block.mixer == "mla" for u in model.plan):
        fns["apply_mla_decode"] = (fusion, fusion.apply_mla_decode)
    seen = {}

    def capture(name, fn):
        def wrapped(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped
    for name, (mod, fn) in fns.items():
        setattr(mod, name, capture(name, fn))
    try:
        engine.step()                       # one decode step of 4 slots
    finally:
        for name, (mod, fn) in fns.items():
            setattr(mod, name, fn)
    require(set(seen) == set(fns), f"{label}: the decode step called "
            f"{sorted(seen)}")
    out = {}
    with torch.no_grad():
        for name, (_, fn) in fns.items():
            a, kw = seen[name]
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*a, **kw)
            except RuntimeError as e:
                require(False, f"{label}: {name} synchronizes with the "
                               f"host: {e}")
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
                    torch.cuda.synchronize()
            out[name] = {"input": tuple(a[2].shape)}
            print(f"[serving] {label}: {name} on a decode step's input "
                  f"{tuple(a[2].shape)} ran under sync debug mode \"error\""
                  f": no host synchronisation")
    return out


def moe_determinism(label, p, cfg, dtype, Ts=(4, 256),
                    dev: str = "cuda") -> dict:
    """`apply_moe` twice on the same input, one MoE layer's weights ``p``:
    the two outputs must be bit-identical (`torch.equal`) at each T."""
    import torch

    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    with torch.no_grad():
        for T in Ts:
            x = torch.randn((1, T, cfg.d_model), generator=gen,
                            device=dev).to(dtype)
            a, b = L.apply_moe(p, cfg, x), L.apply_moe(p, cfg, x)
            same = torch.equal(a, b)
            require(same, f"{label} {dtype} T={T}: two apply_moe calls on "
                          f"one input differ by "
                          f"{float((a.float() - b.float()).abs().max()):.3e}")
            out[f"T={T}"] = same
            print(f"[moe] {label} {str(dtype)[6:]} T={T}: apply_moe twice "
                  f"on one input: torch.equal {same}")
    return out


def deepseek_moe_determinism(dev: str = "cuda") -> dict:
    """One MoE layer of deepseek-v2-lite at full width (64 experts top-6
    of F 1408, 2 shared), bf16 and f32, T 4 and 256."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        cfg = get_config("deepseek-v2-lite").replace(
            param_dtype=str(dt)[6:], compute_dtype=str(dt)[6:])
        b = L.ParamInit(torch.Generator(device=dev).manual_seed(0), dt, dev)
        out[str(dt)[6:]] = moe_determinism("deepseek-v2-lite", L.init_moe(
            b, cfg), cfg, dt, dev=dev)
    return out


def hubert_phase(pk: dict, dev: str = "cuda") -> dict:
    """hubert: hubert-xlarge encoder inference through `Model.forward` at
    full width and depth (48 layers, d_model 1280, 16 heads x 80,
    LayerNorm, gelu F 5120, learned positions, the linear audio
    connector, non-causal attention), on 4 clips of 500 frames (10 s of
    16 kHz audio at 20 ms frames; random frame embeddings of width 512,
    the reference's frontend stub). bf16: exact launches a call
    (fused_norm 97, qkv_proj 48, ffn_act 48, nothing else: non-causal
    attention is plain, as in the reference), finite logits of the
    expected shape, the wall and device ms of one forward, the busy
    share, frames/s, the top ops and the peak memory. f32 at full width
    and depth (TF32 off): clip 0 on the card against the same forward on
    the host CPU (the kernels' plain twins), max |diff| <= 1e-3 of the
    largest |logit|, with the per-frame argmax agreement; and clip 0
    alone against its row of the batch of 4, <= 1e-5 of the largest
    |logit|."""
    import torch

    from repro_torch import kernels
    from repro_torch.tree import tree_leaves, tree_map

    label = "hubert"
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = _model("hubert-xlarge", "bfloat16", dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S = HUBERT_CLIPS, HUBERT_FRAMES
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randn((B, S, cfg.frontend.frontend_dim), generator=gen,
                         device=dev)
    batch = {"frames": frames}
    print(f"[hubert] hubert-xlarge: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, "
          f"{cfg.mlp_type} F {cfg.d_ff}, {cfg.norm_type}, {cfg.pos_emb} "
          f"positions, non-causal: {n_params:,} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16) built on the card in "
          f"{init_s:.1f} s; input {B} clips x {S} frames x "
          f"{cfg.frontend.frontend_dim}")
    model.forward(params, batch)                      # warm-up
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits = model.forward(params, batch)
    sync()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    n_norm, n_gqa, n_ffn = plan_counts(model)
    want = dict.fromkeys(counts, 0)
    want.update(fused_norm=n_norm, qkv_proj=n_gqa, ffn_act=n_ffn)
    n_l = cfg.num_layers
    require(counts == want and (n_norm, n_gqa, n_ffn) == (2 * n_l + 1, n_l,
                                                          n_l),
            f"{label}: launches a forward {counts}, planned {want}")
    require(tuple(logits.shape) == (B, S, model.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"{label}: logits {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    print(f"[hubert] launches a forward: {counts} (fused_norm 2 x "
          f"{cfg.num_layers} + 1, qkv_proj and ffn_act one a layer, "
          f"attn_stream 0: non-causal attention is plain); logits "
          f"{tuple(logits.shape)}, finite")
    res = {"layers": cfg.num_layers, "clips": B, "frames": S,
           "params": n_params, "init_s": init_s, "launches": counts,
           "wall_ms": wall_ms, "frames_per_s": B * S / (wall_ms / 1e3)}
    # the work of one forward and its floor at the card's bf16 rate
    D, F_, V = cfg.d_model, cfg.d_ff, model.padded_vocab
    M = B * S
    flops = (2 * M * cfg.frontend.frontend_dim * D + 2 * M * D * V
             + cfg.num_layers * (2 * M * 4 * D * D + 2 * M * 2 * D * F_
                                 + 4 * B * S * S * D))
    res["flops"] = flops
    res["floor_ms"] = 1e3 * flops / pk["bfloat16"]
    if dev == "cuda":
        kernels.reset_launch_counts()
        with device_profile() as prof:
            lead_in()
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            prof_wall = 1e3 * (time.perf_counter() - t0)
        ka = prof.key_averages()
        rows = device_rows(ka)
        dev_ms = sum(r[2] for r in rows) if rows else None
        res.update({
            "profile_wall_ms": prof_wall, "device_ms": dev_ms,
            "busy_share": dev_ms / prof_wall if dev_ms else None,
            "device_launches": sum(r[1] for r in rows),
            "launch_check": profile_launch_check(
                label, "forward", rows, kernels.launch_counts()),
            "top": [{"kernel": k[:90], "launches": c, "ms": t}
                    for k, c, t in rows[:12]],
            "top_ops": top_ops(ka, 1)})
        (OUT / "forward_profile_hubert.txt").write_text(
            ka.table(sort_by="self_device_time_total", row_limit=80))
        res["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
        print(f"[hubert] bf16 forward of {B} x {S} frames: wall "
              f"{wall_ms:.2f} ms ({res['frames_per_s']:.0f} frames/s, "
              f"{B * S * 0.02 / (wall_ms / 1e3):.0f}x real time); profiled "
              f"wall {prof_wall:.2f} ms, device {us(dev_ms, unit='ms')} in "
              f"{res['device_launches']} launches, busy share "
              f"{res['busy_share']}; {flops / 1e12:.2f} TFLOP, floor "
              f"{res['floor_ms']:.2f} ms at {pk['bfloat16'] / 1e12:.0f} "
              f"TF/s; peak device memory "
              f"{res['peak_memory_allocated'] / 1e9:.2f} GB")
        for r in res["top"]:
            print(f"[profile]   {r['ms']:8.3f} ms {r['launches']:5d} "
                  f"launches  {r['kernel']}")
        print(f"[profile] {label}: the forward's top torch ops by the "
              f"device time of what they launch (inclusive):")
        for r in res["top_ops"]:
            print(f"[profile]   {r['ms_per_step']:8.3f} ms "
                  f"{r['calls_per_step']:6.0f} calls  {r['op']}")
    del params, logits
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    # f32 at full width and depth: the card against the host, and clip 0
    # alone against its row of the batch
    cfg32, model32, p32 = _model("hubert-xlarge", "float32", dev)
    f32 = frames.float()
    with torch.no_grad():
        l4 = model32.forward(p32, {"frames": f32})
        l1 = model32.forward(p32, {"frames": f32[:1]})
        host = tree_map(lambda t: t.cpu(), p32)
        t0 = time.perf_counter()
        lc = model32.forward(host, {"frames": f32[:1].cpu()})
        host_s = time.perf_counter() - t0
    scale = float(lc.abs().max())
    err_host = float((l1.cpu() - lc).abs().max())
    err_batch = float((l1 - l4[:1]).abs().max())
    agree = float((l1.cpu().argmax(-1) == lc.argmax(-1)).float().mean())
    res["f32"] = {"layers": cfg32.num_layers, "max_abs_logit": scale,
                  "max_abs_err_host": err_host,
                  "rel_err_host": err_host / scale,
                  "argmax_agreement": agree, "host_s": host_s,
                  "max_abs_err_batch": err_batch,
                  "rel_err_batch": err_batch / float(l4.abs().max())}
    print(f"[hubert] f32 ({cfg32.num_layers} layers, full width): clip 0 "
          f"on the card vs the host CPU ({host_s:.1f} s there): max |diff| "
          f"{err_host:.3e} of max |logit| {scale:.3f} (rel "
          f"{err_host / scale:.3e}, limit 1e-3); per-frame argmax agreement "
          f"{agree:.4f}; clip 0 alone vs its row of the batch of {B}: max "
          f"|diff| {err_batch:.3e} (rel {res['f32']['rel_err_batch']:.3e}, "
          f"limit 1e-5)")
    require(err_host <= 1e-3 * scale, f"{label} f32: card vs host "
            f"{err_host:.3e} > 1e-3 x {scale:.3f}")
    require(res["f32"]["rel_err_batch"] <= 1e-5, f"{label} f32: clip 0 "
            f"alone vs batched {err_batch:.3e}")
    del p32, host, model32
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def llama4_phase(pk: dict, dev: str = "cuda") -> dict:
    """llama4: the MoE determinism check (one deepseek-v2-lite MoE layer
    at full width, bf16 and f32, T 4 and 256: apply_moe twice,
    torch.equal), then llama4-maverick-400b at full width: the bf16 run
    at a 2-layer cut (the dense archs' run: 4 slots, tiered W 128,
    max_len 512, 8 text requests of 256 with 64 new; exact launches a
    model call, fused_norm 5, qkv_proj 2, attn_stream 2 an extend,
    paged_decode_tiered 2 a step; write-once, ledger == sim, the
    profiles, peak memory), its decode busy beside the all-weights floor
    and the floor of the experts 4 slots can touch, apply_moe under sync
    debug mode "error" and its layer 0 MoE twice on one input (T 4, 256);
    then the f32 parity run at a 1-layer cut (4 text requests of 128, 16
    new: Engine == generate, tie rule), with the free memory before the
    build and the peak."""
    import torch

    from repro_torch.configs.base import get_config

    out = {"moe_determinism": {"deepseek-v2-lite":
                               deepseek_moe_determinism(dev)}}

    def after(model, params, res):
        cfg = model.cfg
        m = cfg.moe
        floor = res["weight_floor"]
        bank = params["units"]["u0"]["mlp"]        # (layers, E, ., .)
        ex_bytes = sum(bank[k].numel() * bank[k].element_size()
                       for k in ("w_up", "w_gate", "w_down"))
        touched = min(4 * m.top_k, m.num_experts)
        b_touch = floor["bytes"] - ex_bytes * (
            m.num_experts - touched) / m.num_experts
        busy = res.get("profile", {}).get("device_ms_per_step")
        res["touched_floor"] = {"bytes": b_touch,
                                "ms": 1e3 * b_touch / pk["bw"],
                                "experts_a_layer": touched}
        print(f"[serving] llama4: decode busy {us(busy, unit='ms')} a step "
              f"against the all-weights floor {floor['ms']:.2f} ms "
              f"({floor['bytes'] / 1e9:.2f} GB) and the floor of the "
              f"<= {touched} experts a layer 4 slots can touch "
              f"{res['touched_floor']['ms']:.2f} ms ({b_touch / 1e9:.2f} "
              f"GB): the dropless (E, T, D) experts read all "
              f"{m.num_experts}")
        res["sync_free"] = sync_free_check("llama4", model, params, dev)
        p0 = {k: (v[0] if k != "shared" else
                  {n: t[0] for n, t in v.items()})
              for k, v in params["units"]["u0"]["mlp"].items()}
        out["moe_determinism"]["llama4-maverick-400b"] = {
            "bfloat16": moe_determinism("llama4-maverick-400b", p0, cfg,
                                        torch.bfloat16, dev=dev)}
    out["llama4"] = dense_run("llama4", pk, dev, after=after)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    n = LLAMA_LAYERS["float32"]
    full = get_config("llama4-maverick-400b")
    cut = full.replace(param_dtype="float32", num_layers=n, segments=())
    free = torch.cuda.mem_get_info()[0] if dev == "cuda" else 0
    print(f"[parity] llama4-parity: f32, full width (d_model "
          f"{cut.d_model}, {cut.num_heads} / {cut.num_kv_heads} heads x "
          f"{cut.head_dim}, {cut.moe.num_experts} experts top-"
          f"{cut.moe.top_k} of F {cut.moe.d_ff_expert} + "
          f"{cut.moe.num_shared_experts} shared), depth cut from "
          f"{full.num_layers} to {n} layer: {cut.param_count():,} "
          f"parameters, {4 * cut.param_count() / 1e9:.1f} GB in f32; "
          f"{free / 1e9:.2f} GB free on the card before the build")
    res = _parity("llama4-parity", "llama4-maverick-400b",
                  dict(kv_policy="tiered", kv_hot_window=64, num_layers=n,
                       segments=()), {}, dev, n_vqa=0)
    res.update(layers=n, free_before_build=free)
    out["llama4-parity"] = res
    return out


# fastvlm-1.7b training (the train phase): 8 VQA rows of 256 positions (64
# visual + 192 text) a step, f32 (TF32 off), as the train CLI trains; the
# card-vs-host gradient check and the resume check at a 2-layer cut
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CUT = 8, 256, 6, 2
# device µs a call of the f32 fma forms at these shapes, measured before
# the tf32x3 forms (PERF.md §6 rows 2, 3 and 5; NVIDIA H100 80GB HBM3,
# 700.00 W): the times the tf32x3 forms are printed beside
FMA_US_BEFORE = {"ffn_act": 19_646.0, "qkv_proj": 631.1,
                 "attn_stream": 252.1}
# the port's kernels by device name, by wrapper: a profiled step's forward
# kernels (the split of ffn_act's and qkv_proj's tf32x3 forms is one
# kernel, tf32_split_kernel, for both)
OWN_BY_WRAPPER = {
    "fused_norm": ("fused_norm_kernel",),
    "qkv_proj": ("qkv_fma_kernel", "qkv_gemv_kernel", "qkv_wgmma_kernel",
                 "qkv_tf32_kernel"),
    "attn_stream": ("attn_fma_kernel", "attn_wgmma_kernel",
                    "attn_tf32_kernel", "attn_pair_split_kernel"),
    "ffn_act": ("ffn_up_kernel", "ffn_act_kernel", "ffn_down_kernel",
                "ffn_reduce_kernel", "ffn_stream_mma_kernel",
                "ffn_up_tf32_kernel", "ffn_down_tf32_kernel"),
    "tf32 split (ffn_act, qkv_proj)": ("tf32_split_kernel",)}
OWN_KERNELS = tuple(n for ns in OWN_BY_WRAPPER.values() for n in ns)


def _train_model(dev: str, layers: int | None = None):
    """fastvlm-1.7b at full width in f32 with no remat, as the train CLI
    builds it; ``layers`` cuts the depth."""
    knobs = dict(remat="none")
    if layers is not None:
        knobs.update(num_layers=layers, segments=())
    return _model("fastvlm-1.7b", "float32", dev, **knobs)


def _loss_grads(model, params, batch):
    """(loss, {leaf path: gradient or None}) of `Model.loss` by autograd."""
    import torch

    from repro_torch.tree import tree_leaves_with_path
    paths, leaves = zip(*tree_leaves_with_path(params))
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), dict(zip(paths, grads))


def _rel(got, want) -> float:
    """max |got - want| over the largest |want| (0 where both are 0)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def train_kernel_grads(pk: dict, dev: str = "cuda") -> dict:
    """Each kernel Function of the training path at fastvlm-1.7b's
    training shapes (M = 8 x 256 = 2048 rows): its output (the kernel)
    and every input gradient (the twin's VJP) against autograd through
    the plain twin on the same inputs, f32, within 1e-4 of the largest
    element; each forward must launch its kernel once and record a
    `KernelGrad` node. On the card each kernel's forward is timed
    beside its plain twin, one library call computing the same function
    and its bound at the f32 peak, with the Function's forward and
    backward together; `qkv_proj`, `attn_stream` and `ffn_act` (the
    tf32x3 forms) also with their profiler device time, the 3xTF32 bound
    (three TF32 products at the TF32 peak), the library call's device
    time and their fma form's earlier time."""
    import functools

    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import ops
    from repro_torch.kernels import qkv_proj as QK

    gen = torch.Generator(device=dev).manual_seed(7)

    def t(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    B, S, D, H, Hkv, Dh, F_ = (TRAIN_B, TRAIN_S, D_MODEL, HEADS, KV_HEADS,
                               HEAD_DIM, D_FF)
    x = t(B, S, D)

    def rows(plain, x, *rest, **kw):
        return plain(x.reshape(-1, x.shape[-1]), *rest, **kw).reshape(
            *x.shape[:-1], -1)
    cases = {
        "fused_norm": (
            lambda x, s: ops.fused_norm(x, s, None, "rms"),
            lambda x, s: rows(FN.fused_norm_plain, x, s, None, "rms"),
            (x, 1.0 + 0.1 * t(D))),
        "qkv_proj": (
            ops.qkv_proj,
            functools.partial(ops._qkv_call, QK.qkv_proj_plain),
            (x, t(D, H, Dh, std=D ** -0.5), t(D, Hkv, Dh, std=D ** -0.5),
             t(D, Hkv, Dh, std=D ** -0.5), t(H, Dh, std=0.1),
             t(Hkv, Dh, std=0.1), t(Hkv, Dh, std=0.1))),
        "attn_stream": (
            ops.attn_stream, functools.partial(ops._attn_plain, causal=True),
            (t(B, S, H, Dh), t(B, S, Hkv, Dh), t(B, S, Hkv, Dh))),
        "ffn_act": (
            lambda *a: ops.ffn_act(*a, "silu_gated"),
            lambda x, *w: rows(FF.ffn_act_plain, x, *w, kind="silu_gated"),
            (x, t(D, F_, std=D ** -0.5), t(D, F_, std=D ** -0.5),
             t(F_, D, std=F_ ** -0.5))),
    }
    M, N = B * S, (H + 2 * Hkv) * Dh
    # (library call on the same inputs, bytes read and written, f32 ops)
    library = {
        "fused_norm": (lambda x, s: F.rms_norm(x, (D,), s, 1e-6),
                       (2 * M * D + D) * 4, 0),
        "qkv_proj": (lambda x, *w: [torch.addmm(b.reshape(-1),
                                                x.reshape(M, D),
                                                wt.reshape(D, -1))
                                    for wt, b in zip(w[:3], w[3:])],
                     (M * D + D * N + N + M * N) * 4, 2 * M * D * N),
        "attn_stream": (lambda q, k, v: F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=True,
                            enable_gqa=True),
                        2 * B * (H + Hkv) * S * Dh * 4,
                        4 * B * H * Dh * S * (S + 1) // 2),
        "ffn_act": (lambda x, wu, wg, wd: (F.silu(x @ wu) * (x @ wg)) @ wd,
                    (2 * M * D + 3 * D * F_) * 4, 6 * M * D * F_),
    }
    res = {}
    for name, (fn, plain, inputs) in cases.items():
        xs = [a.detach().requires_grad_(True) for a in inputs]
        n0 = kernels.launch_counts()[name]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        require(kernels.launch_counts()[name] == n0 + (dev == "cuda")
                and all(type(o.grad_fn).__name__ == "KernelGradBackward"
                        for o in outs),
                f"train: {name}'s Function did not launch its kernel once")
        cot = [t(*o.shape) for o in outs]
        got = torch.autograd.grad(outs, xs, cot)
        ys = [a.detach().requires_grad_(True) for a in inputs]
        ref = plain(*ys)
        refs = ref if isinstance(ref, tuple) else (ref,)
        want = torch.autograd.grad(refs, ys, cot)
        errs = {"out": max(_rel(o.detach(), r.detach())
                           for o, r in zip(outs, refs))}
        errs.update({f"grad{i}": _rel(g, w)
                     for i, (g, w) in enumerate(zip(got, want))})
        res[name] = {"shapes": [list(a.shape) for a in inputs], **errs}
        print(f"[train] {name} Function at {[tuple(a.shape) for a in inputs]}"
              f": output and input gradients vs the twin's autograd, max "
              f"|diff| / max |ref|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + " (limit 1e-4)")
        require(max(errs.values()) <= 1e-4,
                f"train: {name}'s Function vs the twin {errs}")
        del ys, out, outs, ref, refs, got, want
        if dev == "cuda":
            lib, nbytes, flops = library[name]
            b_ms, b_by = bound(pk, nbytes, flops, "float32")
            with torch.no_grad():
                times = {k: time_ms(functools.partial(f, *inputs), reps=10)
                         for k, f in (("ms", fn), ("plain_ms", plain),
                                      ("library_ms", lib))}

            def fwd_bwd():
                o = fn(*xs)
                o = o if isinstance(o, tuple) else (o,)
                torch.autograd.grad(o, xs, cot)
            times["fwd_bwd_ms"] = time_ms(fwd_bwd, reps=10)
            res[name].update(times, bound_ms=b_ms, bound_by=b_by)
            print(f"[train] {name} f32 at M {M}: kernel {times['ms']:.3f} ms"
                  f", plain {times['plain_ms']:.3f}, library "
                  f"{times['library_ms']:.3f}, bound {b_ms:.3f} ({b_by}); "
                  f"the Function's forward + backward "
                  f"{times['fwd_bwd_ms']:.3f} ms")
            wrapper = {"ffn_act": FF.ffn_act, "qkv_proj": QK.qkv_proj,
                       "attn_stream": AS.attn_stream}.get(name)
            if wrapper is not None:
                with torch.no_grad():
                    call = functools.partial(fn, *inputs)
                    libc = functools.partial(lib, *inputs)
                    dms, lib_dms = (device_ms(call, reps=10),
                                    device_ms(libc, reps=10))
                    ev, lib_ev = (event_ms(call, n=5, reps=3),
                                  event_ms(libc, n=5, reps=3))
                # a profiler window that lost events reads far below the
                # CUDA events' time of the same calls: not a measurement
                dms, lib_dms = (None if d is not None and d < 0.5 * e else d
                                for d, e in ((dms, ev), (lib_dms, lib_ev)))
                b3_ms, b3_by = bound(pk, nbytes, flops, "tf32x3")
                res[name].update(form=wrapper.variant, device_ms=dms,
                                 event_ms=ev, library_device_ms=lib_dms,
                                 library_event_ms=lib_ev,
                                 tf32x3_bound_ms=b3_ms,
                                 tf32x3_bound_by=b3_by,
                                 fma_device_us_before=FMA_US_BEFORE[name])
                print(f"[train] {name} f32 at M {M} ({wrapper.variant} "
                      f"form): {us(dms)} device (profiler), "
                      f"{1e3 * ev:.1f} us (CUDA events), was "
                      f"{FMA_US_BEFORE[name]:,} us in the fma form; "
                      f"library {us(lib_dms)} device, {1e3 * lib_ev:.1f} "
                      f"us (events); bounds {1e3 * b_ms:.1f} us at the "
                      f"f32 CUDA-core peak, {1e3 * b3_ms:.1f} us "
                      f"({b3_by}) at three TF32 products")
        del xs, cot
    return res


def train_grad_parity(dev: str = "cuda") -> dict:
    """`Model.loss` and every gradient leaf at a 2-layer cut of
    fastvlm-1.7b at full width (f32, B 2 x S 128: 64 visual + 64 text
    positions of the pipeline's VQA layout) on the card against the
    same on the host CPU (the kernels' plain twins), with remat "none"
    and "full": each within 1e-4 of the host's largest element; no leaf
    None, non-finite or all zero (what a kernel unseen by autograd
    leaves)."""
    import torch

    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import Model
    from repro_torch.tree import tree_map

    cfg, model, params = _train_model(dev, TRAIN_CUT)
    batch = SyntheticPipeline(cfg, DataConfig(2, 128, seed=1)).host_slice(0)
    host = tree_map(lambda a: a.cpu(), params)
    t0 = time.perf_counter()
    want_loss, want = _loss_grads(model, host, batch)
    host_s = time.perf_counter() - t0
    res = {"layers": TRAIN_CUT, "host_s": host_s,
           "loss_host": float(want_loss)}
    for remat in ("none", "full"):
        m = Model(cfg.replace(remat=remat))
        loss, got = _loss_grads(m, params, batch)
        bad = [".".join(p) for p, g in got.items() if g is None
               or not bool(torch.isfinite(g).all()) or not bool(g.any())]
        errs = {".".join(p): _rel(g, want[p]) for p, g in got.items()
                if g is not None}
        worst = max(errs, key=errs.get)
        loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        res[remat] = {"loss": float(loss), "loss_rel_err": loss_err,
                      "max_rel_err": errs[worst], "worst_leaf": worst,
                      "bad_leaves": bad, "leaves": len(got)}
        print(f"[train] grads, 2-layer cut, remat {remat}: loss card "
              f"{float(loss):.6f} host {float(want_loss):.6f} (rel "
              f"{loss_err:.2e}); {len(got)} leaves, worst {worst} "
              f"{errs[worst]:.2e} of its largest element (limit 1e-4); "
              f"None / non-finite / all-zero leaves: {bad or 'none'} "
              f"(host {host_s:.1f} s)")
        require(not bad and errs[worst] <= 1e-4 and loss_err <= 1e-4,
                f"train: card vs host gradients, remat {remat}: bad {bad}, "
                f"worst {worst} {errs[worst]:.2e}, loss {loss_err:.2e}")
        del got
    del params, host
    return res


def train_run(pk: dict, dev: str = "cuda") -> dict:
    """Six `make_train_step` steps of fastvlm-1.7b at full width and depth
    (28 layers, f32, TF32 off) with the train CLI's AdamW at --steps 6,
    on the pipeline's VQA batches (8 x 256). Step 1's gradients, as the
    step hands them to AdamW: none None, all finite. Every step: a finite
    loss and exactly 2 x 28 + 1 `fused_norm` and 28 `qkv_proj`,
    `attn_stream` and `ffn_act` launches, nothing else (the backward runs
    the twins' VJPs and, at remat "none", recomputes nothing). Prints the
    step time (median of steps 2-5), tokens/s, the peak memory, 6 N T
    FLOP and its floor at the f32 CUDA-core peak, and a profile of step
    6 (busy ms, idle share, the forward kernels against the rest)."""
    import torch

    from repro_torch import kernels
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves

    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, params = _train_model(dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in tree_leaves(params))
    opt = AdamWConfig(lr=3e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
                      total_steps=TRAIN_STEPS)
    state = adamw_init(params, opt)
    pipe = SyntheticPipeline(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=0))
    step = ST.make_train_step(model, opt)
    DRYRUN_INPUTS["train"] = _walk_inputs(cfg, opt, pipe.host_slice(0),
                                          state)
    n_norm, n_gqa, n_ffn = plan_counts(model)
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if cuda:
        want.update(fused_norm=n_norm, qkv_proj=n_gqa, attn_stream=n_gqa,
                    ffn_act=n_ffn)
    require((n_norm, n_gqa, n_ffn) == (2 * cfg.num_layers + 1,
                                       cfg.num_layers, cfg.num_layers),
            f"train: plan counts {(n_norm, n_gqa, n_ffn)}")
    print(f"[train] fastvlm-1.7b f32: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads x "
          f"{cfg.head_dim}, QKV bias {cfg.use_attn_bias}, {cfg.mlp_type} F "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}: "
          f"{n_params:,} parameters ({4 * n_params / 1e9:.2f} GB f32; "
          f"params + grads + mu + nu {16 * n_params / 1e9:.2f} GB) built in "
          f"{init_s:.1f} s; {TRAIN_B} x {TRAIN_S} VQA rows a step "
          f"({cfg.frontend.num_tokens} visual + "
          f"{TRAIN_S - cfg.frontend.num_tokens} text)")
    checked = {}
    update = ST.adamw_update

    def check_grads(st, grads, ocfg):
        if not checked:
            gs = tree_leaves(grads)
            checked.update(leaves=len(gs), none=sum(g is None for g in gs),
                           finite=all(bool(torch.isfinite(g).all())
                                      for g in gs if g is not None))
        return update(st, grads, ocfg)
    losses, wall, counts, prof_res = [], [], [], {}
    ST.adamw_update = check_grads
    try:
        for t in range(TRAIN_STEPS):
            batch = pipe.host_slice(t)
            kernels.reset_launch_counts()
            prof = (device_profile() if cuda and t == TRAIN_STEPS - 1
                    else contextlib.nullcontext())
            with prof:
                if cuda and t == TRAIN_STEPS - 1:
                    lead_in()
                sync()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                sync()
                wall.append(time.perf_counter() - t0)
            counts.append(kernels.launch_counts())
            losses.append(float(m["loss"]))
            print(f"[train] step {t + 1}: loss {losses[-1]:.4f} gnorm "
                  f"{float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
                  f"{1e3 * wall[-1]:.1f} ms; launches {counts[-1]}")
    finally:
        ST.adamw_update = update
    require(checked.get("none") == 0 and checked.get("finite"),
            f"train: step 1's gradients {checked}")
    require(all(c == want for c in counts),
            f"train: launches a step {counts}, planned {want}")
    require(all(math.isfinite(v) for v in losses), f"train: losses {losses}")
    timed = sorted(wall[1:TRAIN_STEPS - 1])
    step_s = statistics.median(timed)
    tokens = TRAIN_B * TRAIN_S
    flops = 6 * n_params * tokens
    res = {"params": n_params, "init_s": init_s, "losses": losses,
           "step_ms": [1e3 * w for w in wall], "step_ms_median": 1e3 * step_s,
           "tokens_per_s": tokens / step_s, "flops": flops,
           "floor_ms": 1e3 * flops / pk["float32"], "grads_step1": checked,
           "launches": {k: sum(c[k] for c in counts) for k in want},
           "launches_per_step": counts[0]}
    if cuda:
        ka = prof.key_averages()
        rows = device_rows(ka)
        busy = sum(r[2] for r in rows)
        own = sum(r[2] for r in rows if any(n in r[0] for n in OWN_KERNELS))
        by_wrapper = {w: sum(r[2] for r in rows if any(n in r[0]
                                                       for n in names))
                      for w, names in OWN_BY_WRAPPER.items()}
        prof_res = {
            "wall_ms": 1e3 * wall[-1], "busy_ms": busy,
            "idle_share": 1 - busy / (1e3 * wall[-1]),
            "forward_kernels_ms": own, "other_ms": busy - own,
            "forward_kernels_ms_by_wrapper": by_wrapper,
            "device_launches": sum(r[1] for r in rows),
            "launch_check": profile_launch_check(
                "train", "step", rows, counts[-1]),
            "top": [{"kernel": k[:90], "launches": c, "ms": ms}
                    for k, c, ms in rows[:14]],
            "top_ops": top_ops(ka, 1, 16)}
        (OUT / "train_profile.txt").write_text(
            ka.table(sort_by="self_device_time_total", row_limit=80))
        res["profile"] = prof_res
        res["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"[train] {TRAIN_STEPS} steps: losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; step {1e3 * step_s:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS - 1}; step 1 {1e3 * wall[0]:.1f} ms), "
          f"{tokens / step_s:,.0f} tokens/s; {flops / 1e12:.2f} TFLOP a step "
          f"(6 N T), floor {res['floor_ms']:.1f} ms at "
          f"{pk['float32'] / 1e12:.0f} TF/s f32"
          + (f"; peak device memory "
             f"{res['peak_memory_allocated'] / 1e9:.2f} GB" if cuda else ""))
    if prof_res:
        print(f"[train] step {TRAIN_STEPS} profiled: wall "
              f"{prof_res['wall_ms']:.1f} ms, device busy "
              f"{prof_res['busy_ms']:.1f} ms in "
              f"{prof_res['device_launches']} launches (idle share "
              f"{prof_res['idle_share']:.3f}); the forward kernels "
              f"{prof_res['forward_kernels_ms']:.1f} ms ("
              + ", ".join(f"{w} {v:.3f}" for w, v in
                          prof_res["forward_kernels_ms_by_wrapper"].items())
              + f"), everything else {prof_res['other_ms']:.1f} ms")
        for r in prof_res["top"]:
            print(f"[profile]   {r['ms']:8.3f} ms {r['launches']:5d} "
                  f"launches  {r['kernel']}")
        print("[profile] train: the step's top torch ops by the device time "
              "of what they launch (inclusive):")
        for r in prof_res["top_ops"]:
            print(f"[profile]   {r['ms_per_step']:8.3f} ms "
                  f"{r['calls_per_step']:6.0f} calls  {r['op']}")
    del state, params, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def train_resume(dev: str = "cuda") -> dict:
    """Checkpoint and resume at the 2-layer cut (f32, B 2 x S 128, the
    CLI's AdamW at --steps 4), under `torch.use_deterministic_algorithms`:
    4 uninterrupted steps against (a) `FaultTolerantLoop` checkpointing
    every 2 steps with step 4 failing twice, past its one retry (the
    loop restores the checkpoint taken after step 2 and redoes steps
    3-4), and (b) a fresh state resumed from that checkpoint for steps
    3-4 in a new loop. Params,
    mu, nu and step must equal the uninterrupted run's; the seconds a
    save and a restore take are printed."""
    import shutil
    import warnings

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.fault import FaultPolicy, FaultTolerantLoop
    from repro_torch.tree import sorted_leaves, tree_map

    cfg, model, weights = _train_model(dev, TRAIN_CUT)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    batches = SyntheticPipeline(cfg, DataConfig(2, 128, seed=2)).host_slice
    step_fn = make_train_step(model, opt)

    def fresh():
        return adamw_init(tree_map(torch.clone, weights), opt)

    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = CheckpointManager(ckdir, keep=3)
    times = {"save": [], "restore": []}
    for name in times:
        real = getattr(ck, name)

        def timed_call(*a, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            times[_name].append(time.perf_counter() - t0)
            return out
        setattr(ck, name, timed_call)
    seen = []

    def flaky(state, batch):
        seen.append(int(state.step))
        if seen[-1] == 3 and seen.count(3) <= 2:
            raise RuntimeError("injected failure of step 4")
        return step_fn(state, batch)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("default")
            want = fresh()
            for t in range(4):
                want, _ = step_fn(want, batches(t))
            loop = FaultTolerantLoop(flaky, ck, FaultPolicy(
                checkpoint_every=2, max_retries_per_step=1))
            got, end = loop.run(fresh(), batches, 0, 4)
            resumed, s = ck.restore(fresh(), 1)
            got2, _ = FaultTolerantLoop(step_fn, ck, FaultPolicy(
                checkpoint_every=100)).run(resumed, batches, s + 1, 2)
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(ckdir, ignore_errors=True)
    nbytes = sum(a.numel() * a.element_size() for a in sorted_leaves(want))
    res = {"steps_run": [(r.step, r.retries) for r in loop.reports],
           "save_s": times["save"], "restore_s": times["restore"],
           "bytes": nbytes, "warnings": sorted({str(w.message)[:160]
                                                for w in warned})}
    for label, st in (("fault loop", got), ("resume", got2)):
        pairs = list(zip(sorted_leaves(st), sorted_leaves(want)))
        exact = all(torch.equal(a, b) for a, b in pairs)
        worst = max(_rel(a, b) for a, b in pairs)
        res[label] = {"exact": exact, "max_rel_diff": worst}
        print(f"[train] {label} vs uninterrupted, 4 steps at the 2-layer "
              f"cut: torch.equal {exact} over {len(pairs)} leaves (params, "
              f"mu, nu, step); largest diff {worst:.2e} of a leaf's largest "
              f"element")
    print(f"[train] checkpoint {nbytes / 1e9:.2f} GB: save "
          + ", ".join(f"{s:.2f}" for s in times["save"]) + " s; restore "
          + ", ".join(f"{s:.2f}" for s in times["restore"]) + " s; steps run "
          f"{res['steps_run']}; determinism warnings: "
          f"{res['warnings'] or 'none'}")
    require(end == 4 and res["steps_run"] == [(0, 0), (1, 0), (2, 0),
                                               (2, 0), (3, 0)]
            and len(times["restore"]) == 2,
            f"train: the fault loop ran {res['steps_run']}")
    require(res["fault loop"]["exact"] and res["resume"]["exact"],
            f"train: resumed states differ from the uninterrupted run's "
            f"{res['fault loop']} {res['resume']}")
    del weights, want, got, got2, resumed
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def train_phase(pk: dict, dev: str = "cuda") -> dict:
    """train: the kernel Functions' backward at the training shapes, the
    card's gradients against the host's at a 2-layer cut, six full-depth
    steps of fastvlm-1.7b, and checkpoint + resume at the cut."""
    import torch
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    res = {"kernel_grads": train_kernel_grads(pk, dev)}
    gc.collect()
    res["grad_parity"] = train_grad_parity(dev)
    gc.collect()
    res["run"] = train_run(pk, dev)
    res["launches"] = res["run"]["launches"]
    res["resume"] = train_resume(dev)
    return res


def _shared_head_requests(cfg, tails, gen_len: int, seed: int,
                          sys_len: int = 192):
    """VQA requests about ONE image: the same patches and the same
    ``sys_len``-token system prompt open every prompt (the shared head),
    then a question of its own, ``tails[i]`` tokens long; the questions'
    first tokens differ, so a hit is exactly the head's whole blocks."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    f = cfg.frontend
    image = rng.standard_normal((f.num_tokens, f.frontend_dim)).astype(
        np.float32)
    system = rng.integers(0, cfg.vocab_size, sys_len)
    firsts = rng.choice(cfg.vocab_size, len(tails), replace=False)
    reqs = []
    for i, n in enumerate(tails):
        q = rng.integers(0, cfg.vocab_size, n)
        q[0] = firsts[i]
        reqs.append(Request(rid=i, patches=image, max_new_tokens=gen_len,
                            tokens=np.concatenate([system, q]).astype(
                                np.int32)))
    return reqs


def _until_committed(engine, req) -> None:
    """Step ``engine`` until ``req`` has its first token: its prompt's
    chain is then registered, so requests submitted after it can hit."""
    while req.n_generated == 0:
        engine.step()


def prefix_run(dev: str = "cuda") -> dict:
    """fastvlm-prefix: "many questions about one camera frame". bf16
    fastvlm-1.7b at full width and depth, tiered store (hot window 128),
    4 slots, max_len 512, paged + prefix cache, a Telemetry hub: 8 VQA
    requests on one image (64 patches) and one 192-token system prompt
    (a 256-token head: 2 blocks of 128), each with a 48-token question
    of its own and 64 new tokens; the first commits before the other 7
    are submitted. Every hit adopts the head and prefills only its tail
    (attn_stream at q_offset 256)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving import LocalBackend, Telemetry

    label, needs, head = "fastvlm-prefix", RUNS[0][5], 256
    cfg, model, params = _model("fastvlm-1.7b", "bfloat16", dev,
                                kv_policy="tiered", kv_hot_window=128)
    max_len = 512
    reqs = _shared_head_requests(cfg, [48] * 8, gen_len=64, seed=5)
    backend = LocalBackend(model, params, 4, max_len, device=dev)
    require(backend.block_tokens == 128 and backend.prefix_blocks == 16,
            f"{label}: block geometry {backend.block_tokens} x "
            f"{backend.prefix_blocks}")
    tel = Telemetry()
    engine, step_s, sync = timed_engine(backend, dev, telemetry=tel,
                                        prefix_cache=True)
    bp, block_b = engine.block_pool, backend.prefix_block_bytes()
    # every extend call the engine makes, the uncommitted rerun of a
    # registering commit included
    calls, extend = [0], backend.extend_step

    def counted(*a):
        calls[0] += 1
        return extend(*a)
    backend.extend_step = counted
    # the blocks live admissions pin, read as a hit is released (a whole
    # prompt admits and commits within one step)
    pinned, release = 0, bp.release

    def releasing(hit):
        nonlocal pinned
        pinned = max(pinned, bp.pinned_blocks)
        return release(hit)
    bp.release = releasing
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine.submit(reqs[0])
    _until_committed(engine, reqs[0])
    for r in reqs[1:]:
        engine.submit(r)
    while not engine.idle:
        engine.step()
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    backend.extend_step, bp.release = extend, release
    done = engine.finished
    st = dict(engine.stats)
    reruns = len(done)             # one commit a request, each registering
    require(calls[0] == st["extend_calls"] + reruns,
            f"{label}: {calls[0]} extend calls, expected "
            f"{st['extend_calls']} + {reruns} reruns")
    res = check_run(label, cfg, model, engine, done, len(reqs), counts,
                    needs, reruns=reruns)
    hits = [r for r in done if r.prefix_hit]
    require(st["prefix_hits"] == 7 and st["prefix_hit_tokens"] == 7 * head
            and sorted(r.prefix_hit for r in hits) == [head] * 7,
            f"{label}: {st['prefix_hits']} hits of "
            f"{st['prefix_hit_tokens']} tokens, expected 7 of {head}")
    bp.check_invariants()
    writes = bp.block_writes.tolist()
    require(bp.total_refcount == 0 and max(writes) <= 1 and pinned > 0,
            f"{label}: refcount {bp.total_refcount} after the drain, "
            f"block writes {writes}, peak pinned blocks {pinned}")
    timing(label, done, wall, step_s, max_len, res)
    sim = sim_ledger(label, backend, done)
    led = tel.ledger.totals()
    for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
        require(led[k] == sim[k], f"{label}: ledger {k} {led[k]!r} != "
                f"simulated_efficiency {sim[k]!r}")
    # TTFT (queueing included) and admission to first token, hit and cold
    cold = [r for r in done if not r.prefix_hit]

    def p50(rs, t0_of):
        return 1e3 * float(np.percentile(
            [r.first_token_s - t0_of(r) for r in rs], 50))
    ttft = {k: p50(rs, lambda r: r.arrival_s) for k, rs in
            (("hit", hits), ("cold", cold))}
    admit = {k: p50(rs, lambda r: r.admit_s) for k, rs in
             (("hit", hits), ("cold", cold))}
    pinned *= block_b
    print(f"[prefix] {label}: {st['prefix_hits']} hits of "
          f"{st['prefix_hit_tokens'] // st['prefix_hits']} tokens, "
          f"{bp.stats['blocks_registered']} blocks registered, writes per "
          f"block {writes} (<= 1), refcount 0 after the drain; ledger == "
          f"simulated_efficiency: EXACT (prefix adopt "
          f"{led['prefix_adopt_bytes']:.4g} B); peak pinned prefix "
          f"bytes {pinned} ({pinned // block_b} blocks of "
          f"{block_b} B); store {backend.prefix_blocks * block_b} B for "
          f"{backend.prefix_blocks} blocks, {bp.used_blocks} live after the "
          f"drain ({bp.used_blocks * block_b} B)")
    print(f"[prefix] {label}: TTFT p50 hit {ttft['hit']:.1f} ms vs cold "
          f"{ttft['cold']:.1f} ms (queueing included); admission to first "
          f"token p50 hit {admit['hit']:.1f} ms vs cold "
          f"{admit['cold']:.1f} ms")
    res.update({"stats": st, "sim": sim, "ttft_p50_ms_hit": ttft["hit"],
                "ttft_p50_ms_cold": ttft["cold"],
                "admit_to_first_p50_ms_hit": admit["hit"],
                "admit_to_first_p50_ms_cold": admit["cold"],
                "pinned_prefix_bytes_peak": pinned,
                "prefix_block_bytes": block_b,
                "block_writes": writes,
                "blocks_registered": bp.stats["blocks_registered"]})
    if dev == "cuda":
        res.update(_hit_tail_ms(label, engine, hits[-1], head))
    del engine, backend, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def _prompt_rows(req, a: int, b: int, max_len: int) -> tuple[dict, int]:
    """The batch for prompt positions [a, b) of ``req`` (patches when the
    span is the image's, else tokens), right-padded to the admission
    bucket as the engine pads a whole-prompt chunk."""
    import numpy as np

    from repro_torch.serving.engine import bucket_len

    vis, valid = int(req.patches.shape[0]), b - a
    rows = max(min(bucket_len(valid), max_len - a), valid)
    if b <= vis:
        part = np.asarray(req.patches[a:b], np.float32)
        pad = np.zeros((rows - valid,) + part.shape[1:], np.float32)
        return {"patches": np.concatenate([part, pad])[None]}, valid
    part = np.asarray(req.tokens[a - vis:b - vis], np.int32)
    pad = np.zeros((rows - valid,), np.int32)
    return {"tokens": np.concatenate([part, pad])[None]}, valid


def _hit_tail_ms(label, engine, req, head: int) -> dict:
    """One hit's tail extend (the question's rows at q_offset ``head``
    over a workspace seeded from the prefix store) against the whole
    prompt's prefill (the image chunk, then the text chunk, committed):
    device ms from the profiler (the mean of 5 calls; an extend
    call reads its token back to the host, so CUDA events around it
    would time the host too). Runs after the launch counts were read."""
    from repro_torch.serving.block_pool import request_prefix_keys

    be, state = engine.backend, engine.pool.state
    # the shared head's whole blocks (``req`` registered its own tail
    # too, which a lookup up to prompt_len - 1 would also match)
    hit = engine.block_pool.lookup(request_prefix_keys(req), max_hit=head)
    require(hit.length == head, f"{label}: lookup found {hit.length}")
    seeded = be.fresh_extend()
    for node in hit.nodes:
        seeded = be.prefix_load_ws(state, seeded, node.bid, node.start)
    vis, n = int(req.patches.shape[0]), req.prompt_len
    tail, t_valid = _prompt_rows(req, head, n, be.max_len)
    img, i_valid = _prompt_rows(req, 0, vis, be.max_len)
    text, x_valid = _prompt_rows(req, vis, n, be.max_len)

    def tail_call():
        return be.extend_step(tail, state, seeded, 0, head, t_valid, True)
    tok = tail_call()[0]
    require(tok == req.generated[0], f"{label}: the seeded tail's first "
            f"token {tok} != the served {req.generated[0]}")

    def whole_call():
        _, ext, _ = be.extend_step(img, state, be.fresh_extend(), 0, 0,
                                   i_valid, False)
        return be.extend_step(text, state, ext, 0, vis, x_valid, True)
    out = {"hit_tail_tokens": t_valid,
           "hit_tail_rows": int(tail["tokens"].shape[1]),
           "hit_tail_device_ms": device_ms(tail_call, reps=5),
           "whole_prefill_device_ms": device_ms(whole_call, reps=5)}
    print(f"[prefix] {label}: one hit-tail extend ({t_valid} tokens padded "
          f"to {out['hit_tail_rows']} rows at q_offset {head}) "
          f"{us(out['hit_tail_device_ms'], 3, 'ms')} on the device (profiler) vs "
          f"the whole {n}-token prefill (2 extend calls) "
          f"{us(out['whole_prefill_device_ms'], 3, 'ms')}")
    return out


def stream_run(built, b_res: dict, b_done, dev: str = "cuda") -> dict:
    """B-stream: path B (mobilevlm-3b, tiered, int8 FFN weights) with
    RRAM weight streaming at W = 2, on B's weights. Streaming is
    accounting only (the model runs the same loop over the same
    device-resident weights, so B's tokens are the streamed run's), so
    nothing is served again. On the host: resident B charged for its
    weights under the default CHIME budget is refused at construction;
    the streamed backend's DRAM working set, which the engine charges by
    itself, still admits all 4 slots; chime_sim prices B's served trace
    with the streamed layers' RRAM weight fetches."""
    from repro_torch.serving import Engine, LocalBackend

    label = "B-stream"
    _, model, params = built
    max_len = 512
    resident = LocalBackend(model, params, 4, max_len, device=dev)
    try:
        Engine(resident, charge_weights=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "weight working set" in refused,
            f"{label}: resident B charged for its weights was admitted")
    res_w = resident.weight_bytes()[0]
    del resident
    backend = LocalBackend(model, params, 4, max_len, device=dev,
                           weight_stream=2)
    require(backend.weight_stream == 2 and backend.model.streamed_units(),
            f"{label}: weight streaming not resolved")
    engine = Engine(backend)
    require(engine.charge_weights and engine.scheduler.max_concurrent >= 4,
            f"{label}: the streamed working set does not admit 4 slots")
    sim = sim_ledger(label, backend, b_done)
    dram_w, rram_w = backend.weight_bytes()
    ws_j = sim["sim_energy_split_j"].get("weight_stream", 0.0)
    require(sim["sim_weight_stream"] and ws_j > 0,
            f"{label}: chime_sim priced no weight streaming")
    b_sim = b_res["sim"]
    require(sim["sim_energy_j"] > b_sim["sim_energy_j"],
            f"{label}: streaming priced at or below resident B")
    print(f"[stream] {label}: W=2, weights {dram_w / 2**20:.1f} MiB DRAM "
          f"working set / {rram_w / 2**20:.1f} MiB streamed from RRAM "
          f"(resident: {res_w / 2**20:.1f} MiB, refused under the CHIME "
          f"budget); the streamed engine's budget admits "
          f"{engine.scheduler.max_concurrent} slots (>= 4); chime_sim (CHIME, "
          f"analytic) on B's served trace {sim['sim_tokens_per_j']:.2f} "
          f"tok/J, {sim['sim_energy_j']:.4f} J of which weight_stream "
          f"{ws_j:.4g} J, vs B resident {b_sim['sim_tokens_per_j']:.2f} "
          f"tok/J, {b_sim['sim_energy_j']:.4f} J")
    res = {"sim": sim, "weight_dram_bytes": dram_w,
           "weight_rram_bytes": rram_w,
           "admitted_slots": engine.scheduler.max_concurrent,
           "resident_weight_bytes": res_w, "resident_refused": refused}
    del engine, backend
    return res


# path B under priority traffic: (label, backend knobs, engine knobs)
PREEMPT_RUNS = (
    ("B-preempt", dict(spill_compress=False), {}),
    ("B-offload", dict(spill_compress=True), dict(idle_offload_steps=16)),
)


def preempt_run(label, bknobs, eknobs, pk: dict, built,
                dev: str = "cuda") -> dict:
    """Path B at full width and depth, 4 slots and 4 RRAM spill lanes:
    8 priority-0 requests (4 VQA, 4 text; 64 new tokens each), 3 engine
    steps, then 4 priority-1 text requests (64-token prompts, 16 new
    tokens) that preempt runners (the serve CLI's --priority-every
    order). A Telemetry hub records the run; its ledger must reconcile
    exactly with simulated_efficiency, its trace and exposition must
    parse, and the spill lanes' RRAM counters must equal their oracle.
    ``built``: path B's (cfg, Model, params) from `_model`."""
    import json as _json

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import kv_tiers as KT
    from repro_torch.serving import (LocalBackend, Request, Telemetry,
                                     parse_prometheus, slot_kv_bytes,
                                     spill_lane_bytes,
                                     validate_chrome_trace)

    text_with_image, needs = RUNS[2][4:]
    cfg, model, params = built
    max_len = 512
    low = _requests(cfg, n_vqa=4, n_text=4, text_with_image=text_with_image,
                    text_len=256, gen_len=64, seed=2)
    rng = np.random.default_rng(3)
    high = [Request(rid=100 + i, priority=1, max_new_tokens=16,
                    tokens=rng.integers(0, cfg.vocab_size, 64)
                    .astype(np.int32)) for i in range(4)]
    backend = LocalBackend(model, params, 4, max_len, device=dev, n_spill=4,
                           **bknobs)
    require(backend.spill_compress == bknobs["spill_compress"]
            and backend.n_spill == 4, f"{label}: spill knobs not resolved")
    tel = Telemetry()
    engine, step_s, sync = timed_engine(backend, dev, telemetry=tel,
                                        **eknobs)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in low:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    engine.run(high)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    done = engine.finished
    res = check_run(label, cfg, model, engine, done, len(low) + len(high),
                    counts, needs)
    st = dict(engine.stats)
    require(st["evictions"] > 0, f"{label}: nothing was preempted: {st}")
    if eknobs.get("idle_offload_steps"):
        require(st["idle_offloads"] > 0,
                f"{label}: no idle offload happened: {st}")
    require(st["restores"] == st["evictions"] + st["idle_offloads"]
            and not engine._spilled
            and all(len(r.evict_times) == len(r.restore_times)
                    for r in done),
            f"{label}: a parked request was not restored: {st}")
    # the lanes' cumulative RRAM counters against their oracle
    sw = engine.pool.state.spill_writes.cpu()
    ctxs = [c for r in done for c in r.evict_ctx]
    require(len(ctxs) == st["evictions"] + st["idle_offloads"]
            and sw.sum(dim=0).tolist() == KT.expected_spill_block_writes(
                sw.shape[1], ctxs).tolist(),
            f"{label}: spill counters {sw.tolist()} != oracle over {ctxs}")
    rep = engine.endurance_report()
    require(rep["total_spill_writes"] == int(sw.sum()),
            f"{label}: endurance report misses spill writes: {rep}")
    timing(label, done, wall, step_s, max_len, res)
    # the ledger, priced live, against the end-of-run price: the same
    # floats (fsum over the same term multiset)
    sim = sim_ledger(label, backend, done)
    led = tel.ledger.totals()
    for k in ("sim_energy_j", "sim_total_s", "sim_spill_energy_j",
              "sim_spill_s", "sim_energy_split_j"):
        require(led[k] == sim[k], f"{label}: ledger {k} {led[k]!r} != "
                f"simulated_efficiency {sim[k]!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    trace = tel.chrome_trace()
    info = validate_chrome_trace(trace)
    require({"evict", "restore", "decode"} <= set(info["phases"]),
            f"{label}: trace phases {info['phases']}")
    (OUT / f"trace_{label}.json").write_text(_json.dumps(trace))
    prom = tel.prometheus()
    samples = parse_prometheus(prom)
    require(samples, f"{label}: empty Prometheus exposition")
    (OUT / f"metrics_{label}.prom").write_text(prom)
    print(f"[spill] {label}: {st['evictions']} preemptions, "
          f"{st['idle_offloads']} idle offloads, {st['restores']} restores "
          f"of {len(done)} requests; spill writes {int(sw.sum())} == "
          f"oracle; write-once OK; ledger reconciles with "
          f"simulated_efficiency: EXACT (dram "
          f"{led['sim_energy_split_j'].get('dram', 0.0):.4g} J, rram "
          f"{led['sim_energy_split_j'].get('rram', 0.0):.4g} J, spill "
          f"{led['sim_spill_energy_j']:.4g} J); trace {info['spans']} "
          f"spans / {info['counters']} counters valid, exposition "
          f"{len(samples)} samples valid")
    # one evict and one restore on the card, beside the least time their
    # bytes need: the slot image read once and the lane written once
    # (evict), the lane read once and the slot written once (restore)
    verbatim = spill_lane_bytes(model, max_len, False)
    compressed = spill_lane_bytes(model, max_len, True)
    require(compressed < verbatim, f"{label}: compressed lane not smaller")
    slot_b = sum(slot_kv_bytes(model, max_len))
    lane_b = backend.spill_lane_bytes()
    state = engine.pool.state
    bound_ms = (slot_b + lane_b) / pk["bw"] * 1e3
    if dev == "cuda":
        ev_ms = event_ms(lambda: backend.evict_slot(state, 0, 0, max_len - 1),
                         n=1, reps=5)
        rs_ms = event_ms(lambda: backend.restore_slot(state, 0, 0),
                         n=1, reps=5)
    else:
        ev_ms = rs_ms = float("nan")
    print(f"[spill] {label}: lane bytes verbatim {verbatim} / compressed "
          f"{compressed} (this run's lanes: {lane_b}); evict_slot "
          f"{ev_ms:.4f} ms, restore_slot {rs_ms:.4f} ms device time "
          f"(CUDA events, median of 5) beside a bound of {bound_ms:.4f} ms "
          f"({slot_b} + {lane_b} bytes at {pk['bw'] / 1e12:.2f} TB/s)")
    res.update({"stats": st, "sim": sim, "spill_writes": int(sw.sum()),
                "lane_bytes_verbatim": verbatim,
                "lane_bytes_compressed": compressed,
                "evict_ms": ev_ms, "restore_ms": rs_ms,
                "spill_bound_ms": bound_ms,
                "trace": {k: info[k] for k in ("spans", "counters")},
                "prometheus_samples": len(samples)})
    return res


def timed_engine(backend, dev: str, **engine_kw):
    """(Engine over ``backend``, list of host-timed decode steps in s,
    sync): each batched decode step timed from a synchronized start to
    its host tokens."""
    import torch

    from repro_torch.serving import Engine

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    step_s = []
    decode = backend.decode_step

    def timed_decode(*a):
        sync()
        t0 = time.perf_counter()
        res = decode(*a)          # returns host tokens: synchronizes
        step_s.append(time.perf_counter() - t0)
        return res

    backend.decode_step = timed_decode
    return Engine(backend, **engine_kw), step_s, sync


def plan_counts(model) -> tuple[int, int, int]:
    """Launches a model call of (fused_norm, the GQA kernels, the FFN
    kernel), from the plan: a norm before each half-block and the final
    one (a hybrid's Mamba2 blocks have no MLP half); the projection and
    attention kernels in every GQA layer (a shared-attention application
    is one); the FFN kernel in every layer with a dense FFN (not the
    routed experts, not RWKV's channel mix, plain in the reference too)."""
    plan = model.plan
    n_norm = 1 + sum(u.repeats * (1 + (u.block.mlp is not None))
                     for u in plan)
    n_gqa = sum(u.repeats for u in plan
                if u.block.mixer in ("attn", "attn_shared"))
    n_ffn = sum(u.repeats for u in plan
                if u.block.mlp not in (None, "moe", "rwkv_cm"))
    return n_norm, n_gqa, n_ffn


def check_run(label, cfg, model, engine, done, n_reqs, counts,
              needs, reruns: int = 0) -> dict:
    """Every request finished with all its tokens, in the vocabulary;
    every layer of every model call launched each of the run's kernels
    once (norms: two a layer and the final one) and nothing else
    launched; on the tiered store a cold page was live and every cold
    slot was written at most once. ``reruns``: extend calls the engine
    made besides ``stats["extend_calls"]`` (with the prefix cache on, a
    registering commit reruns its final chunk uncommitted first)."""
    require(len(done) == n_reqs, f"{label}: not every request finished")
    for r in done:
        require(r.n_generated == r.max_new_tokens,
                f"{label}: request {r.rid} made {r.n_generated} tokens")
        require(all(0 <= t < model.padded_vocab for t in r.generated),
                f"{label}: request {r.rid}: token id out of range")
    n_norm, n_gqa, n_ffn = plan_counts(model)
    ext = engine.stats["extend_calls"] + reruns
    dec = engine.stats["decode_steps"]
    want = {"fused_norm": n_norm * (ext + dec),
            "qkv_proj": n_gqa * (ext + dec),
            "attn_stream": n_gqa * ext,
            "ffn_act": n_ffn * (ext + dec),
            "ffn_act_int8": n_ffn * (ext + dec),
            "paged_decode_tiered": n_gqa * dec,
            "paged_decode_flat": n_gqa * dec}
    for k, n in counts.items():
        expect = want[k] if k in needs else 0
        require(n == expect and (k not in needs or n > 0),
                f"{label}: {k} launched {n} times on the main path, "
                f"expected {expect}")
    ctx = max(r.prompt_len + r.n_generated - 1 for r in done)
    res = {"requests": len(done), "max_context": ctx, "launches": counts,
           "extend_calls": ext, "reruns": reruns,
           "decode_steps_engine": dec}
    if cfg.kv_policy == "tiered" and any(
            u.block.mixer in ("attn", "attn_shared", "mla")
            for u in model.plan):
        rep = engine.endurance_report()
        require(ctx > cfg.kv_hot_window and rep["total_cold_writes"] > 0,
                f"{label}: no cold page was live")
        require(rep["write_once_ok"], f"{label}: endurance violated: {rep}")
        res["cold_writes"] = rep["total_cold_writes"]
    return res


def timing(label, done, wall, step_s, max_len, res) -> None:
    """Step p50/p95 and TTFT of a drained run, into ``res`` and printed."""
    import numpy as np

    from repro_torch.serving import aggregate_metrics

    m = aggregate_metrics(done, wall)
    dec_ms = 1e3 * np.asarray(step_s)
    res.update({"tokens": m["total_tokens"], "wall_s": wall,
                "tok_per_s": m["tok_per_s"],
                "ttft_p50_ms": 1e3 * m["ttft_p50_s"],
                "ttft_p95_ms": 1e3 * m["ttft_p95_s"],
                "decode_step_p50_ms": float(np.percentile(dec_ms, 50)),
                "decode_step_p95_ms": float(np.percentile(dec_ms, 95)),
                "decode_steps": int(dec_ms.size)})
    print(f"[serving] {label} bf16 max_len={max_len}: {res['requests']} "
          f"requests, {res['tokens']} tokens in {wall:.2f} s = "
          f"{res['tok_per_s']:.1f} tok/s; TTFT p50 "
          f"{res['ttft_p50_ms']:.1f} ms p95 {res['ttft_p95_ms']:.1f} ms; "
          f"decode step p50 {res['decode_step_p50_ms']:.2f} ms p95 "
          f"{res['decode_step_p95_ms']:.2f} ms over {res['decode_steps']} "
          f"steps; context {res['max_context']}; launches "
          f"{res['launches']}")


def sim_ledger(label, backend, done, platform=None) -> dict:
    """chime_sim's analytic price of the served trace on ``platform``
    (default CHIME; host arithmetic after the run, nothing measured)."""
    from repro_torch.serving import simulated_efficiency
    from repro_torch.simulator import CHIME

    cfg, comp = backend.sim_context()
    sim = simulated_efficiency(cfg, done, platform or CHIME,
                               spill_compressed=comp,
                               fused_decode=backend.fused_decode,
                               sparse_read_tau=backend.sparse_read_tau,
                               weight_stream=bool(backend.weight_stream))
    split = sim["sim_energy_split_j"]
    print(f"[sim] {label}: chime_sim analytic figure for the "
          f"{sim['platform']} platform (not measured on this card), "
          f"priced on the served trace: {sim['sim_tokens_per_j']:.2f} "
          f"tok/J, {sim['sim_energy_j']:.4f} J, "
          f"{sim['sim_total_s']:.4f} s; split "
          + ", ".join(f"{d} {v:.4g} J" for d, v in split.items())
          + (f"; {sim['sim_spills']} spills, "
             f"{sim['sim_spill_energy_j']:.4g} J" if sim["sim_spills"]
             else ""))
    return sim


def serve_run(label, arch, knobs, bknobs, text_with_image, needs,
              dev: str = "cuda", built=None, n_vqa: int = 4,
              telemetry=None) -> dict:
    """One bf16 serving run of 8 requests (``n_vqa`` of them VQA) at
    concurrency 4, max_len 512, 64 new tokens each, with its launch
    check, timing, chime_sim price and profiles; ``built`` is the
    run's (cfg, Model, params) where the caller made them."""
    from repro_torch import kernels
    from repro_torch.serving import LocalBackend
    from repro_torch.simulator import DRAM_ONLY

    cfg, model, params = built or _model(arch, "bfloat16", dev, **knobs)
    max_len, gen_len = 512, 64
    reqs = _requests(cfg, n_vqa=n_vqa, n_text=8 - n_vqa,
                     text_with_image=text_with_image, text_len=256,
                     gen_len=gen_len, seed=2)
    backend = LocalBackend(model, params, 4, max_len, device=dev, **bknobs)
    for k, v in bknobs.items():
        require(getattr(backend, k) == v, f"{label}: backend {k} != {v}")
    engine, step_s, sync = timed_engine(backend, dev, telemetry=telemetry)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = check_run(label, cfg, model, engine, done, len(reqs), counts,
                    needs)
    timing(label, done, wall, step_s, max_len, res)
    res["finished"] = done
    res["sim"] = sim_ledger(label, backend, done)
    res["sim_dram_only"] = sim_ledger(label, backend, done, DRAM_ONLY)
    if telemetry is not None:
        # the ledger, priced live, against the end-of-run price
        led = telemetry.ledger.totals()
        for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
            require(led[k] == res["sim"][k], f"{label}: ledger {k} "
                    f"{led[k]!r} != simulated_efficiency {res['sim'][k]!r}")
        print(f"[sim] {label}: the Telemetry ledger reconciles with "
              f"simulated_efficiency: EXACT")
    if dev == "cuda":
        t1 = time.perf_counter()
        res["profile"] = profile_decode(label, model, params, cfg,
                                        text_with_image, bknobs, dev)
        t2 = time.perf_counter()
        res["prefill_profile"] = profile_prefill(label, model, params, cfg,
                                                 bknobs, dev)
        print(f"[time] {label}: served in {wall:.1f} s; decode profile "
              f"{t2 - t1:.1f} s, prefill profile "
              f"{time.perf_counter() - t2:.1f} s")
    del engine, backend, params
    return res


# the device kernels of each wrapper of which one call launches exactly
# one (the FFN's second kernel, its reduction or phase 2, is not counted);
# the two FFN wrappers share their kernels' names
HEAD_KERNELS = {
    ("fused_norm",): ("fused_norm_kernel",),
    ("qkv_proj",): ("qkv_gemv_kernel", "qkv_wgmma_kernel", "qkv_fma_kernel",
                    "qkv_tf32_kernel"),
    ("attn_stream",): ("attn_wgmma_kernel", "attn_fma_kernel",
                       "attn_tf32_kernel"),
    ("ffn_act", "ffn_act_int8"): ("ffn_stream_mma_kernel", "ffn_up_kernel",
                                  "ffn_act_kernel", "ffn_up_tf32_kernel"),
    ("paged_decode_tiered",): ("paged_decode_tiered_kernel",),
    ("paged_decode_flat",): ("paged_decode_flat_kernel",)}


def profile_launch_check(label, what, rows, counts) -> dict:
    """Each wrapper's launches in a profile (its head kernels' counts in
    ``rows``) against its Python launch counter over the same window
    (``counts``); a mismatch is printed and recorded, not fatal: the
    counters are the record, the profile's times rest on its counts."""
    out = {}
    for wrappers, names in HEAD_KERNELS.items():
        want = sum(counts[w] for w in wrappers)
        got = sum(c for k, c, _ in rows if any(n in k for n in names))
        out["+".join(wrappers)] = {"counter": want, "profile": got}
        if got != want:
            print(f"[profile] {label} {what}: MISMATCH {'+'.join(wrappers)} "
                  f"launched {want} times (counter), {got} in the profile")
    if all(v["counter"] == v["profile"] for v in out.values()):
        print(f"[profile] {label} {what}: every kernel's launches in the "
              f"profile equal its counter")
    return out


# spin cycles at each end of a profiled window: ~5 ms at the H100's ~2 GHz
SPIN_MARGIN = 10_000_000


def device_profile(cuda: bool = True):
    """torch.profiler over CPU and, with ``cuda``, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else []))


def lead_in(cycles: int = SPIN_MARGIN) -> None:
    """The start of a profiled window, before its measured work: a spin
    kernel, synchronized. The profiler loses the first device events of
    a window (DROPPED); the spin kernel takes their place and is left out
    of the rows (`device_rows`). It does not always suffice: the first
    norm and projection of a profiled step are still lost at times
    (printed as a launch-count MISMATCH)."""
    import torch
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def lead_out(cycles: int = SPIN_MARGIN) -> None:
    """The end of a `device_ms` window: a spin kernel queued behind the
    measured calls, synchronized (left out of the rows, as `lead_in`'s)."""
    import torch
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def device_rows(ka) -> list:
    """(kernel, launches, device ms) of a profiled window's key averages
    ``ka``: device-side events only (kernels, memcpy, memset; the aten
    ops that launched them carry the same device time again), the
    lead-in's spin kernel and the "ssm::" ranges' device-side spans
    (`ssm_ranges`: annotations, not kernels) left out, longest first."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in ka
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key
            and not e.key.startswith("ssm::")]
    return sorted(rows, key=lambda r: -r[2])


def profile_decode(label, model, params, cfg, text_with_image, bknobs,
                   dev: str = "cuda", n_steps: int = 4) -> dict:
    """Device time by kernel over ``n_steps`` steady decode steps of 4
    slots (prompts of 256, max_len 512), from torch.profiler; the idle
    share is 1 - kernel time / wall time of the window. Runs after the
    main path's launch counts were read."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.serving import Engine, LocalBackend

    n_vqa = 2 if cfg.frontend is not None else 0
    reqs = _requests(cfg, n_vqa=n_vqa, n_text=4 - n_vqa,
                     text_with_image=text_with_image, text_len=256,
                     gen_len=4 * n_steps, seed=3)
    engine = Engine(LocalBackend(model, params, 4, 512, device=dev,
                                 **bknobs))
    for r in reqs:
        engine.submit(r)
    while engine._inflight is not None or engine.scheduler.pending \
            or int(engine._active.sum()) < len(reqs):
        engine.step()
    for _ in range(2):
        engine.step()                      # steady state: decode only
    torch.cuda.synchronize()
    # the run's paged decode: its last call at the ops layer (the model
    # layout's adapter, which counts nothing; the kernel's wrapper is left
    # as it is) is kept, to time the kernel alone at this decode shape
    # after the window. MLA decodes without one (fused decode is
    # GQA-only), so an MLA model has none to keep
    gqa = any(u.block.mixer in ("attn", "attn_shared") for u in model.plan)
    kern_name = (None if not gqa else "paged_decode_tiered"
                 if cfg.kv_policy == "tiered" else "paged_decode_flat")
    adapter = getattr(ops, kern_name) if kern_name else None
    seen = {}

    def keep(q, k_store, v_store, pos, **kw):
        seen["call"] = (q, k_store, v_store,
                        pos.clone() if torch.is_tensor(pos) else pos, kw)
        return adapter(q, k_store, v_store, pos, **kw)
    kernels.reset_launch_counts()
    if kern_name:
        setattr(ops, kern_name, keep)
    try:
        with device_profile() as prof, ssm_ranges(model):
            lead_in()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        if kern_name:
            setattr(ops, kern_name, adapter)
    counts = kernels.launch_counts()
    ka = prof.key_averages()
    rows = device_rows(ka)
    dev_ms = sum(r[2] for r in rows)
    launch_check = profile_launch_check(label, "decode", rows, counts)
    alone = None
    if kern_name:
        q, k_store, v_store, pos, kw = seen["call"]
        a, kw = getattr(ops, f"{kern_name}_operands")(q, k_store, v_store,
                                                      pos, **kw)
        kern = getattr(PD, kern_name)
        hits = [(c, t) for k, c, t in rows if f"{kern_name}_kernel" in k]
        alone = {"kernel": kern_name,
                 "shape": f"q {tuple(a[0].shape)}, lengths "
                          f"{a[-2].tolist()}",
                 "profile_us_per_launch": 1e3 * sum(t for _, t in hits)
                 / sum(c for c, _ in hits) if hits else None,
                 "device_us": None, "event_us": 1e3 * event_ms(
                     lambda: kern(*a, **kw))}
        alone_ms = device_ms(lambda: kern(*a, **kw))
        if alone_ms is not None and alone_ms < 0.5 * alone["event_us"] / 1e3:
            # a window that lost most of its events reads far below the
            # CUDA events' time of the same calls (1.05 against 21.87 us
            # on the H100 once): not a measurement
            print(f"[profile] {label}: the profiler's {1e3 * alone_ms:.2f} "
                  f"us for {kern_name} alone is under half the CUDA "
                  f"events' {alone['event_us']:.2f} us: events were lost; "
                  f"not measured")
            alone_ms = None
        if alone_ms is not None:
            alone["device_us"] = 1e3 * alone_ms
        in_prof = alone["profile_us_per_launch"]
        print(f"[profile] {label}: {kern_name} at the decode shape "
              f"({alone['shape']}): "
              f"{us(None if in_prof is None else in_prof / 1e3)} a launch "
              f"in the profile; alone {us(alone_ms)} (profiler), "
              f"{alone['event_us']:.2f} us (CUDA events)")
    name = label.split(":")[0].replace(" ", "_")
    (OUT / f"decode_profile_{name}.txt").write_text(
        ka.table(sort_by="self_device_time_total",
                                  row_limit=80))
    # a window with no device event read nothing: busy and idle are None
    out = {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": dev_ms / n_steps if rows else None,
           "device_launches_per_step": sum(r[1] for r in rows) / n_steps,
           "idle_share": 1 - dev_ms / wall_ms if rows and wall_ms else None,
           "launch_check": launch_check, "decode_kernel_alone": alone,
           "top": [{"kernel": k[:90], "launches_per_step": c / n_steps,
                    "ms_per_step": t / n_steps} for k, c, t in rows[:14]]}
    print(f"[profile] {label}: decode step (4 slots, ctx ~256-290): wall "
          f"{out['wall_ms_per_step']:.2f} ms, device busy "
          f"{us(out['device_ms_per_step'], unit='ms')} in "
          f"{out['device_launches_per_step']:.0f} launches, idle share "
          f"{out['idle_share']}")
    for r in out["top"]:
        print(f"[profile]   {r['ms_per_step']:8.3f} ms/step "
              f"{r['launches_per_step']:6.1f} launches/step  {r['kernel']}")
    out["recurrence"] = range_rows(prof, ka, n_steps)
    print_ranges(label, "decode step", out["recurrence"],
                 out["device_ms_per_step"])
    out["top_ops"] = top_ops(ka, n_steps)
    print(f"[profile] {label}: decode step's top torch ops by the device "
          f"time of what they launch (inclusive; nested ops count again):")
    for r in out["top_ops"]:
        print(f"[profile]   {r['ms_per_step']:8.3f} ms/step "
              f"{r['calls_per_step']:6.1f} calls/step  {r['op']}")
    return out


# the recurrences' functions, each timed as a profiler range in the
# serving profiles of a plan that runs them: the mixers (their
# projections included), the scans alone (chunked at prefill, the single
# step at decode), and RWKV's channel mix
SSM_FUNCS = {"ssm": ("apply_rwkv6", "apply_mamba2", "wkv6_chunked",
                     "wkv6_step", "ssd_chunked", "ssd_step"),
             "layers": ("apply_rwkv_cm",)}


@contextlib.contextmanager
def ssm_ranges(model):
    """Within the block, the functions of SSM_FUNCS run inside a
    `record_function` range "ssm::<name>" (module attributes swapped, as
    the model looks them up at call time); nothing when ``model`` runs no
    recurrent mixer."""
    import torch

    from repro_torch.models import layers, ssm
    from repro_torch.models.model import SSM_MIXERS
    saved = []
    if any(u.block.mixer in SSM_MIXERS for u in model.plan):
        for mod in (ssm, layers):
            for name in SSM_FUNCS[mod.__name__.rsplit(".", 1)[1]]:
                fn = getattr(mod, name)

                def ranged(*a, _fn=fn, _name=name, **kw):
                    with torch.profiler.record_function(f"ssm::{_name}"):
                        return _fn(*a, **kw)
                saved.append((mod, name, fn))
                setattr(mod, name, ranged)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def range_rows(prof, ka, n_steps: int) -> list:
    """The "ssm::" ranges of a profiled window, per step: calls, the
    device time of what they launch (inclusive) and the device kernels
    launched under them (walked through the ops each range called)."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    def kernels(e):
        return len(getattr(e, "kernels", [])) + sum(
            kernels(c) for c in getattr(e, "cpu_children", []))
    launches = {}
    for e in prof.events():
        if e.name.startswith("ssm::"):
            launches[e.name] = launches.get(e.name, 0) + kernels(e)
    rows = [{"range": e.key, "calls_per_step": e.count / n_steps,
             "ms_per_step": dev_us(e) / 1e3 / n_steps,
             "launches_per_step": launches.get(e.key, 0) / n_steps}
            for e in ka
            if e.device_type == DeviceType.CPU
            and e.key.startswith("ssm::")]
    return sorted(rows, key=lambda r: -r["ms_per_step"])


def print_ranges(label, what, rows, dev_ms) -> None:
    if not rows:
        return
    print(f"[profile] {label}: {what}: the recurrences' ranges (device ms "
          f"of what each launches, inclusive: a mixer's includes its scan; "
          f"of {us(dev_ms, unit='ms')} busy):")
    for r in rows:
        print(f"[profile]   {r['ms_per_step']:8.3f} ms "
              f"{r['launches_per_step']:8.1f} launches "
              f"{r['calls_per_step']:6.1f} calls  {r['range']}")


def top_ops(ka, n_steps: int, n: int = 12) -> list:
    """The torch ops (aten::bmm, aten::einsum, aten::index_add_, ...)
    that launched the most device time in a profiled window, per step:
    each op's device time includes the ops it calls, so MoE's products
    and MLA's einsums show by name."""
    from torch.autograd import DeviceType
    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
    rows = [(e.key, e.count, dev_us(e) / 1e3) for e in ka
            if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
            and dev_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    return [{"op": k, "calls_per_step": c / n_steps,
             "ms_per_step": t / n_steps} for k, c, t in rows[:n]]


def profile_prefill(label, model, params, cfg, bknobs, dev: str = "cuda",
                    prompt: int = 256) -> dict:
    """Device time by kernel of one whole-prompt extend (a 256-token text
    prompt, committed into slot 0 of a fresh 4-slot pool, max_len 512)
    under torch.profiler, after one warm-up call; the busy share is
    kernel time / wall time of the call. Runs after the main path's
    launch counts were read."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving import LocalBackend

    backend = LocalBackend(model, params, 4, 512, device=dev, **bknobs)
    state = backend.init_pool()
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, prompt)
    batch = {"tokens": toks.astype(np.int32)[None]}

    def call():
        return backend.extend_step(batch, state, backend.fresh_extend(), 0,
                                   0, prompt, True)
    call()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with device_profile() as prof, ssm_ranges(model):
        lead_in()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    ka = prof.key_averages()
    rows = device_rows(ka)
    dev_ms = sum(r[2] for r in rows)
    launch_check = profile_launch_check(label, "prefill", rows, counts)
    name = label.split(":")[0].replace(" ", "_")
    (OUT / f"prefill_profile_{name}.txt").write_text(
        ka.table(sort_by="self_device_time_total",
                                  row_limit=80))
    out = {"prompt": prompt, "wall_ms": wall_ms,
           "device_ms": dev_ms if rows else None,
           "launch_check": launch_check,
           "device_launches": sum(r[1] for r in rows),
           "busy_share": dev_ms / wall_ms if rows and wall_ms else None,
           "top": [{"kernel": k[:90], "launches": c, "ms": t}
                   for k, c, t in rows[:14]]}
    print(f"[profile] {label}: prefill extend ({prompt} tokens): wall "
          f"{wall_ms:.2f} ms, device busy {us(out['device_ms'], unit='ms')} in "
          f"{out['device_launches']} launches, busy share "
          f"{out['busy_share']}")
    for r in out["top"]:
        print(f"[profile]   {r['ms']:8.3f} ms {r['launches']:5d} launches  "
              f"{r['kernel']}")
    out["recurrence"] = range_rows(prof, ka, 1)
    print_ranges(label, f"prefill ({prompt} tokens)", out["recurrence"],
                 out["device_ms"])
    out["top_ops"] = top_ops(ka, 1)
    print(f"[profile] {label}: prefill's top torch ops by the device time "
          f"of what they launch (inclusive):")
    for r in out["top_ops"]:
        print(f"[profile]   {r['ms_per_step']:8.3f} ms "
              f"{r['calls_per_step']:6.0f} calls  {r['op']}")
    return out


def _steady(engine, reqs) -> None:
    """Admit ``reqs`` and step until every one decodes (no prefill left),
    then two more steps: the decode-only steady state."""
    for r in reqs:
        engine.submit(r)
    while engine._inflight is not None or engine.scheduler.pending \
            or int(engine._active.sum()) < len(reqs):
        engine.step()
    for _ in range(2):
        engine.step()


def _decode_window(engine, n_steps: int, dev: str = "cuda") -> dict:
    """``n_steps`` steady decode steps under torch.profiler: wall and
    device ms a step, and the NCCL kernels' share (on the CPU the rows
    are empty and read 0)."""
    import torch

    with device_profile(dev == "cuda") as prof:
        if dev == "cuda":
            lead_in()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        if dev == "cuda":
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof.key_averages()) if dev == "cuda" else []
    nccl = [(k, c, t) for k, c, t in rows if "nccl" in k.lower()]
    dev_ms = sum(t for _, _, t in rows)
    return {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
            "device_ms_per_step": dev_ms / n_steps,
            "nccl_ms_per_step": sum(t for _, _, t in nccl) / n_steps,
            "nccl_launches_per_step": sum(c for _, c, _ in nccl) / n_steps,
            "nccl_kernels": sorted({k[:60] for k, _, _ in nccl}),
            "idle_share": 1 - dev_ms / wall_ms if rows else None}


def sharded_phase(pk: dict, dev: str = "cuda") -> dict:
    """sharded: the serve path through `make_backend("sharded",
    mesh=get_mesh("1x1"))` over NCCL at world size 1 (gloo on the CPU
    rehearsal): fastvlm-1.7b at full width and depth (28 layers, GQA G 6,
    QKV bias, tied head), bf16, tiered store (W 128), 4 slots, max_len
    512, 2 VQA (64 visual + 192 text) and 2 text requests of 256, 64 new
    tokens each. First the same requests on `LocalBackend` (the oracle,
    its decode p50 / p95), then the sharded backend: every pool leaf's
    shape against `cache_shardings`' local shape, the token streams
    equal to the local ones exactly, the exact launch check, one decode
    step's launches and collectives (by kind, per layer), a profiled
    window of 4 decode steps (the NCCL kernels' device time; the local
    path's decode profile is the serving phase's fastvlm run), and the
    peak device memory."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch import sharding as S
    from repro_torch.launch.mesh import get_mesh
    from repro_torch.serving import LocalBackend, make_backend
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    cuda = dev == "cuda"
    mesh = get_mesh("1x1", device=dev)
    want_pg = "nccl" if cuda else "gloo"
    require(dist.get_backend() == want_pg, f"sharded: process group runs "
            f"{dist.get_backend()}, not {want_pg}")
    label, arch, knobs, _, twi, needs = RUNS[0]
    cfg, model, params = _model(arch, "bfloat16", dev, **knobs)
    max_len, gen_len, n_steps = 512, 64, 4

    def reqs(gen=gen_len, seed=2):
        return _requests(cfg, n_vqa=2, n_text=2, text_with_image=twi,
                         text_len=256, gen_len=gen, seed=seed)

    def serve(backend, what):
        engine, step_s, sync = timed_engine(backend, dev)
        sync()
        kernels.reset_launch_counts()
        S.reset_counts()
        t0 = time.perf_counter()
        done = engine.run(reqs())
        sync()
        wall = time.perf_counter() - t0
        res = check_run(what, cfg, backend.model, engine, done, 4,
                        kernels.launch_counts(), needs)
        timing(what, done, wall, step_s, max_len, res)
        res["collectives_run"] = S.counts_by_kind()
        toks = [list(r.generated) for r in sorted(done, key=lambda r: r.rid)]
        return res, toks

    def window(backend, what):
        """One decode step's launches and collectives, then a profiled
        window of ``n_steps`` decode steps, at the steady state."""
        from repro_torch.serving import Engine
        engine = Engine(backend)
        _steady(engine, reqs(gen=4 * n_steps, seed=3))
        kernels.reset_launch_counts()
        S.reset_counts()
        engine.step()
        if cuda:
            torch.cuda.synchronize()
        step = {"launches": kernels.launch_counts(),
                "collectives": S.counts_by_kind(),
                "collectives_per_layer": {
                    k: n / cfg.num_layers
                    for k, n in S.counts_by_kind("u").items()},
                "collectives_outside_layers": {
                    sc: S.counts_by_kind(sc) for sc in ("embed", "head",
                                                        "data")}}
        prof = _decode_window(engine, n_steps, dev)
        print(f"[sharded] {what}: one decode step launches "
              f"{step['launches']}; collectives {step['collectives']} "
              f"(a layer: {step['collectives_per_layer']}; outside the "
              f"layers {step['collectives_outside_layers']})")
        print(f"[sharded] {what}: profiled decode ({n_steps} steps): wall "
              f"{prof['wall_ms_per_step']:.3f} ms a step, device busy "
              f"{prof['device_ms_per_step']:.3f} ms, NCCL kernels "
              f"{prof['nccl_ms_per_step']:.3f} ms in "
              f"{prof['nccl_launches_per_step']:.0f} launches a step "
              f"{prof['nccl_kernels']}, idle share {prof['idle_share']}")
        return dict(step, profile=prof)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    local = LocalBackend(model, params, 4, max_len, device=dev)
    res_l, toks_l = serve(local, f"{label} local")
    del local
    gc.collect()
    sharded = make_backend("sharded", model, params, num_slots=4,
                           max_len=max_len, device=dev, mesh=mesh)
    shapes, _ = sharded.model.cache_spec(4, max_len)
    state = sharded.init_pool()
    leaf_rows = []
    for (path, t), spec, (_, full) in zip(
            tree_leaves_with_path(state.cache),
            tree_leaves(sharded._pool_specs), tree_leaves_with_path(shapes)):
        want = S.local_shape(spec, tuple(full.shape), mesh)
        leaf_rows.append({"leaf": ".".join(path), "shape": tuple(t.shape),
                          "spec": spec, "local_shape": want})
        print(f"[sharded] pool {'.'.join(path):16s} {tuple(t.shape)} "
              f"spec {spec} -> local {want}")
        require(tuple(t.shape) == want, f"sharded: pool leaf {path} "
                f"{tuple(t.shape)} != its local shape {want}")
    del state
    res_s, toks_s = serve(sharded, f"{label} sharded 1x1")
    differ = [(i, j) for i, (a, b) in enumerate(zip(toks_l, toks_s))
              for j, (x, y) in enumerate(zip(a, b)) if x != y]
    print(f"[sharded] token streams vs LocalBackend: "
          f"{'IDENTICAL' if not differ else f'{len(differ)} differ'}")
    require(toks_s == toks_l, f"sharded: token streams part from "
            f"LocalBackend's at (request, step) {differ[:4]}")
    res_s["window"] = window(sharded, "sharded 1x1")
    res_s["pool_leaves"] = leaf_rows
    res_s["local"] = {k: res_l[k] for k in (
        "decode_step_p50_ms", "decode_step_p95_ms", "tok_per_s",
        "ttft_p50_ms", "ttft_p95_ms")}
    res_s["tokens_identical"] = True
    if cuda:
        res_s["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[sharded] peak device memory {res_s['peak_gb']:.2f} GB "
              f"(both backends share the weights)")
    print(f"[sharded] decode step p50 / p95: sharded "
          f"{res_s['decode_step_p50_ms']:.2f} / "
          f"{res_s['decode_step_p95_ms']:.2f} ms, local "
          f"{res_l['decode_step_p50_ms']:.2f} / "
          f"{res_l['decode_step_p95_ms']:.2f} ms")
    res_s.pop("finished", None)
    del sharded, params
    dist.destroy_process_group()
    return res_s


class _NoCheckpoint:
    """A checkpoint manager that keeps nothing: the sharded-train run's
    loop writes no 18.6 GB state (the CPU suite checks the mesh
    checkpoint: saved on 2 x 2, restored on 1 x 2)."""

    def latest_step(self):
        return None

    def save(self, state, step):
        return None


SHARDED_TRAIN_STEPS = 3
# the CPU training suites' tolerances: the loss and grad norm relative,
# a parameter leaf after steps of its largest element
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


def sharded_train_phase(pk: dict, dev: str = "cuda") -> dict:
    """sharded-train: training through the mesh, `launch.train.run` on
    `get_mesh("1x1")` over NCCL at world size 1 (gloo on the CPU
    rehearsal): fastvlm-1.7b at full width and depth (28 layers, f32,
    TF32 off, no remat), 3 steps of 8 x 256 VQA rows from seed 0 with
    the CLI's AdamW (lr 3e-3, warmup 1, total 3). First the same 3 steps
    through the local `make_train_step` on the same init and batches
    (its losses, grad norms, step times and peak memory), then the mesh
    run: per step the loss and grad norm against the local ones
    (relative tolerance `LOSS_RTOL`; every world-1 collective adds no
    arithmetic, so the prediction is equality), exact kernel launches
    (the local step's 57 / 28 / 28 / 28), the collectives by kind, the
    step time, a profiled last step (the NCCL kernels' device time) and
    the peak device memory. Last, at a 2-layer cut (B 2 x S 128, under
    deterministic algorithms), every parameter leaf after 2 steps of
    the placed step against the local step's (the largest difference
    per leaf kind, within `PARAM_TOL` of each leaf's largest element)."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch import sharding as S
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import get_mesh
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = get_mesh("1x1", device=dev)
    want_pg = "nccl" if cuda else "gloo"
    require(dist.get_backend() == want_pg, f"sharded-train: process group "
            f"runs {dist.get_backend()}, not {want_pg}")
    n = SHARDED_TRAIN_STEPS
    args = T.parse_args(["--arch", "fastvlm-1.7b", "--steps", str(n),
                         "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                         "--seed", "0", "--device", dev,
                         "--ckpt-every", "1000"])
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(n // 10, 1),
                      total_steps=n)

    def peak_reset():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def recorder(rows, profile_last):
        def hook(i, run):
            kernels.reset_launch_counts()
            S.reset_counts()
            last = profile_last and i == n - 1
            prof = (device_profile() if last and cuda
                    else contextlib.nullcontext())
            with prof:
                if last and cuda:
                    lead_in()
                sync()
                t0 = time.perf_counter()
                state, m = run()
                sync()
                wall = time.perf_counter() - t0
            row = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "ms": 1e3 * wall,
                   "launches": kernels.launch_counts(),
                   "collectives": S.counts_by_kind(),
                   "collective_bytes": S.bytes_by_kind()}
            if last and cuda:
                drows = device_rows(prof.key_averages())
                nccl = [(k, c, t) for k, c, t in drows if "nccl" in k.lower()]
                busy = sum(t for _, _, t in drows)
                row["profile"] = {
                    "busy_ms": busy, "idle_share": 1 - busy / (1e3 * wall),
                    "nccl_ms": sum(t for _, _, t in nccl),
                    "nccl_launches": sum(c for _, c, _ in nccl),
                    "nccl_kernels": sorted({k[:60] for k, _, _ in nccl})}
            rows.append(row)
            return state, m
        return hook

    # the local step on the same init and batches
    peak_reset()
    cfg, model, params = _train_model(dev)
    pipe = SyntheticPipeline(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=0))
    batches = [pipe.host_slice(t) for t in range(n)]
    local = []
    step, state, hook = (ST.make_train_step(model, opt),
                         adamw_init(params, opt), recorder(local, False))
    for i, b in enumerate(batches):
        state, _ = hook(i, lambda: step(state, b))
    local_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    n_norm, n_gqa, n_ffn = plan_counts(model)
    del params, model, state
    # the mesh run, through the train CLI's mesh function
    peak_reset()
    rows = []

    def step_hook(step):
        hook = recorder(rows, True)
        return lambda state, batch: hook(len(rows),
                                         lambda: step(state, batch))
    got = T.run(args, mesh, step_hook=step_hook, ckpt=_NoCheckpoint())
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    DRYRUN_INPUTS["sharded_train"] = dict(
        _walk_inputs(got["model"].cfg, opt, batches[0]),
        microbatches=args.microbatches, counts=rows[0]["collectives"],
        bytes=rows[0]["collective_bytes"])
    del got
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if cuda:
        want.update(fused_norm=n_norm, qkv_proj=n_gqa, attn_stream=n_gqa,
                    ffn_act=n_ffn)
    diffs = {k: max(abs(r[k] - l[k]) / abs(l[k]) for r, l in zip(rows, local))
             for k in ("loss", "grad_norm")}
    for i, (r, l) in enumerate(zip(rows, local)):
        print(f"[sharded-train] step {i + 1}: loss {r['loss']:.6f} (local "
              f"{l['loss']:.6f}) gnorm {r['grad_norm']:.6f} (local "
              f"{l['grad_norm']:.6f}); {r['ms']:.1f} ms (local "
              f"{l['ms']:.1f}); launches {r['launches']}; collectives "
              f"{r['collectives']}")
    print(f"[sharded-train] largest relative difference from the local "
          f"step: loss {diffs['loss']:.3e}, grad norm "
          f"{diffs['grad_norm']:.3e} (tolerance {LOSS_RTOL:g})")
    require(len(rows) == len(local) == n, f"sharded-train: ran {len(rows)} "
            f"mesh and {len(local)} local steps")
    require(all(d <= LOSS_RTOL for d in diffs.values()),
            f"sharded-train: loss / grad norm differ from the local "
            f"step's {diffs}")
    require(all(r["launches"] == want for r in rows),
            f"sharded-train: launches a step "
            f"{[r['launches'] for r in rows]}, planned {want}")
    require(all(r["collectives"] == rows[0]["collectives"] for r in rows),
            "sharded-train: the steps' collectives differ")
    med = statistics.median(r["ms"] for r in rows)
    lmed = statistics.median(r["ms"] for r in local)
    res = {"steps": rows, "local_steps": local, "max_rel_diff": diffs,
           "step_ms_p50": med, "local_step_ms_p50": lmed,
           "collectives_per_step": rows[0]["collectives"],
           "launches_per_step": rows[0]["launches"],
           "launches": {k: sum(r["launches"][k] for r in rows)
                        for k in want},
           "peak_gb": peak, "local_peak_gb": local_peak}
    prof = rows[-1].get("profile")
    if prof:
        res["profile"] = prof
        print(f"[sharded-train] step {n} profiled: device busy "
              f"{prof['busy_ms']:.1f} ms (idle share "
              f"{prof['idle_share']:.3f}); NCCL kernels "
              f"{prof['nccl_ms']:.3f} ms in {prof['nccl_launches']} "
              f"launches {prof['nccl_kernels']}")
    print(f"[sharded-train] step p50 {med:.1f} ms (local {lmed:.1f} ms); "
          + (f"peak device memory {peak:.2f} GB (local {local_peak:.2f} GB)"
             if cuda else "no device memory on the CPU"))
    res["cut"] = _sharded_train_cut(mesh, dev)
    dist.destroy_process_group()
    peak_reset()
    return res


def _sharded_train_cut(mesh, dev: str) -> dict:
    """fastvlm-1.7b at a 2-layer cut: 2 steps (B 2 x S 128) of the step
    placed on ``mesh`` against the local step, under deterministic
    algorithms; every parameter leaf compared."""
    import warnings

    import torch

    from repro_torch.bridge import shard_params
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg, model, weights = _train_model(dev, TRAIN_CUT)
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2)
    batches = SyntheticPipeline(cfg, DataConfig(2, 128, seed=2)).host_slice
    placed = model.place(mesh)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            states = []
            for m, p in ((model, tree_map(torch.clone, weights)),
                         (placed, shard_params(tree_map(
                             torch.clone, weights),
                             placed.placement.pspec, mesh))):
                st, step = adamw_init(p, opt), make_train_step(m, opt)
                for t in range(2):
                    st, _ = step(st, batches(t))
                states.append(st)
    finally:
        torch.use_deterministic_algorithms(was)
    kinds: dict = {}
    exact = True
    for (path, a), (_, b) in zip(tree_leaves_with_path(states[1].params),
                                 tree_leaves_with_path(states[0].params)):
        exact &= bool(torch.equal(a, b))
        kinds[path[-1]] = max(kinds.get(path[-1], 0.0), _rel(a, b))
    worst = max(kinds.values())
    print(f"[sharded-train] 2-layer cut, 2 steps: params placed vs local "
          f"torch.equal {exact}; largest difference per leaf kind (of the "
          f"leaf's largest element): "
          + ", ".join(f"{k} {v:.1e}" for k, v in sorted(kinds.items())))
    require(worst <= PARAM_TOL, f"sharded-train: 2-layer cut params differ "
            f"by {worst:.2e} of a leaf's largest element")
    del states, weights
    return {"exact": exact, "max_rel_per_kind": kinds}


# what the dryrun phase walks: the train and sharded-train phases' steps
DRYRUN_INPUTS: dict = {}
# the dry run's cell on the host
DRYRUN_CELL = ("granite-3-2b", "decode_32k")


def _walk_inputs(cfg, opt, batch: dict, state=None) -> dict:
    """A step's config, optimizer config and batch shapes for its walk;
    with ``state``, the bytes of the state and the batch the card
    holds."""
    import torch

    from repro_torch.launch.hlo_analysis import nbytes

    spec = {k: (tuple(v.shape), torch.as_tensor(v).dtype)
            for k, v in batch.items()}
    out = {"cfg": cfg, "opt": opt, "batch": spec}
    if state is not None:
        out["card_bytes"] = nbytes(state) + nbytes(
            {k: torch.as_tensor(v) for k, v in batch.items()})
    return out


def _walk_step(inp: dict, mesh=None):
    """`hlo_analysis.analyze` of the make_train_step of ``inp`` on meta
    tensors (placed on ``mesh``, an abstract mesh, where given): the
    analysis and the bytes of its state and batch."""
    import torch

    from repro_torch import sharding as S
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch import steps as ST
    from repro_torch.models import Model
    from repro_torch.optim import TrainState
    from repro_torch.tree import tree_map

    model = Model(inp["cfg"])
    state = ST.abstract_train_state(model, inp["opt"])
    if mesh is not None:
        model = model.place(mesh)
        sh = ST.train_state_shardings(model, model.placement.rules,
                                      inp["opt"])
        state = TrainState(*(tree_map(
            lambda t, sp: torch.empty(S.local_shape(sp, tuple(t.shape),
                                                    mesh),
                                      dtype=t.dtype, device="meta"),
            getattr(state, f), getattr(sh, f))
            for f in ("params", "mu", "nu", "step")))
    batch = {k: torch.empty(shape, dtype=dt, device="meta")
             for k, (shape, dt) in inp["batch"].items()}
    step = ST.make_train_step(model, inp["opt"], inp.get("microbatches", 1))
    a = hlo_analysis.analyze(step, state, batch)
    return a, hlo_analysis.nbytes((state, batch))


def _run_example(name: str, argv: list) -> tuple:
    """examples/<name> run in this process with ``argv`` (its output to
    OUT / example_<name>.txt): (main's result, seconds)."""
    import io
    import runpy

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = runpy.run_path(str(ROOT / "examples" / name),
                             run_name="example")["main"](argv)
    sec = time.perf_counter() - t0
    (OUT / f"example_{name}.txt").write_text(buf.getvalue())
    tail = buf.getvalue().strip().splitlines()[-2:]
    print(f"[dryrun] example {name} {' '.join(argv)}: {sec:.1f} s; "
          + " | ".join(tail))
    return got, sec


def dryrun_phase(report: dict, pk: dict, dev: str = "cuda") -> dict:
    """dryrun: the analytic walk (`launch.hlo_analysis`) of the steps the
    train and sharded-train phases ran, on meta tensors, held to what
    the card held and counted; the three examples on the card; one
    production cell's walk (`launch.dryrun.run_cell`) on the host. It
    builds no model of its own.

      * train (fastvlm-1.7b f32, 28 layers, 8 x 256, local): the walk's
        argument bytes equal the bytes of the params, mu, nu, step and
        batch the card held (exactly); printed: its FLOPs, recompute
        FLOPs (`KernelGrad`'s rerun of the twins' forward) and 6 N T,
        temp + argument bytes against the card's peak allocation, and
        the walk's bound beside the measured step p50;
      * sharded-train (1 x 1 NCCL): the same step on an abstract 1 x 1
        mesh; its collective counts and bytes by kind equal what the
        live wrappers counted in one step;
      * the examples at their reduced sizes (train_lm_torch.py 20
        steps);
      * the dry run of granite-3-2b @ decode_32k on the 16 x 16 mesh:
        its roofline line and the walk's seconds.
    Every figure of a walk is analytic."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import abstract_mesh

    out = {}
    cuda = dev == "cuda"
    tr = DRYRUN_INPUTS.get("train")
    run = report.get("train", {}).get("run")
    if tr is None or run is None:
        print("[dryrun] train: the train phase did not run; skipped")
    else:
        t0 = time.perf_counter()
        a, arg = _walk_step(tr)
        walk_s = time.perf_counter() - t0
        require(arg == tr["card_bytes"], f"dryrun: the walk's argument "
                f"bytes {arg} != the {tr['card_bytes']} the card held")
        mf = 6.0 * run["params"] * TRAIN_B * TRAIN_S
        useful = a["flops"] - a["recompute_flops"]
        peak = run.get("peak_memory_allocated")
        need = a["temp_bytes"] + arg
        bound = hlo_analysis.roofline_terms(
            {"n_chips": 1, "active_params": run["params"],
             "collectives": hlo_analysis.collective_bytes(a)},
            ShapeSpec("train_run", TRAIN_S, TRAIN_B, "train"))
        f32_s = max(a["flops"] / pk["float32"], a["bytes"] /
                    hlo_analysis.HBM_BW)
        out["train"] = {
            "walk_s": walk_s, "argument_bytes": arg, "flops": a["flops"],
            "recompute_flops": a["recompute_flops"],
            "recompute_share": a["recompute_flops"] / a["flops"],
            "model_flops": mf, "bytes": a["bytes"],
            "temp_bytes": a["temp_bytes"], "peak_allocated": peak,
            "peak_ratio": None if not peak else need / peak,
            "bound_s": bound["bound_s"], "dominant": bound["dominant"],
            "bound_f32_s": f32_s,
            "step_ms_p50": run["step_ms_median"]}
        print(f"[dryrun] train walk (analytic, {walk_s:.1f} s): argument "
              f"bytes {arg:,} == the card's; FLOPs {a['flops']:.4e} "
              f"(recompute {a['recompute_flops']:.4e}, "
              f"{100 * out['train']['recompute_share']:.1f}%; without it "
              f"{useful:.4e}), 6 N T {mf:.4e}; bytes {a['bytes']:.4e}")
        print(f"[dryrun] train memory: temp {a['temp_bytes'] / 1e9:.2f} GB "
              f"+ arguments {arg / 1e9:.2f} GB = {need / 1e9:.2f} GB "
              + (f"against the card's peak allocation {peak / 1e9:.2f} GB "
                 f"(ratio {need / peak:.3f})" if peak else "(no card)"))
        print(f"[dryrun] train bound: {1e3 * bound['bound_s']:.1f} ms "
              f"({bound['dominant']}, bf16 peak {hlo_analysis.PEAK_FLOPS:.3g}"
              f" FLOP/s), {1e3 * f32_s:.1f} ms at the f32 peak "
              f"{pk['float32']:.3g}; measured step p50 "
              f"{run['step_ms_median']:.1f} ms")
    sh = DRYRUN_INPUTS.get("sharded_train")
    if sh is None:
        print("[dryrun] sharded-train: the phase did not run; skipped")
    else:
        t0 = time.perf_counter()
        a, _ = _walk_step(sh, abstract_mesh("local"))
        walk_s = time.perf_counter() - t0
        moved = {k: int(v) for k, v in a["collective_bytes"].items() if v}
        print(f"[dryrun] sharded-train walk on an abstract 1 x 1 mesh "
              f"({walk_s:.1f} s): collectives {a['collective_counts']}, "
              f"bytes {moved}; live {sh['counts']}, bytes {sh['bytes']}")
        require(a["collective_counts"] == sh["counts"]
                and moved == sh["bytes"],
                f"dryrun: the walk's collectives {a['collective_counts']} "
                f"/ {moved} != the live step's {sh['counts']} / "
                f"{sh['bytes']}")
        out["sharded_train"] = {"walk_s": walk_s,
                                "counts": a["collective_counts"],
                                "bytes": moved}
    gc.collect()
    ck = ROOT / "build" / "train_lm_ckpt"
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    ex = {}
    try:
        toks, ex["quickstart_s"] = _run_example("quickstart_torch.py",
                                                ["--device", dev])
        require(len(toks) == 5, f"dryrun: quickstart decoded {toks}")
        vlm, ex["serve_vlm_s"] = _run_example("serve_vlm_torch.py",
                                              ["--device", dev])
        require(vlm["write_once_ok"] and vlm["overlap_steps"] > 0
                and vlm["prefix_hits"] > 0, f"dryrun: serve_vlm {vlm}")
        losses, ex["train_lm_s"] = _run_example(
            "train_lm_torch.py", ["--device", dev, "--steps", "20",
                                  "--ckpt-dir", str(ck)])
        require(len(losses) == 20 and all(map(math.isfinite, losses)),
                f"dryrun: train_lm losses {losses}")
        ex.update(serve_vlm=vlm, train_lm_losses=[losses[0], losses[-1]])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    out["examples"] = ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = dryrun.run_cell(*DRYRUN_CELL, multi_pod=False)
    cell_s = time.perf_counter() - t0
    (OUT / f"dryrun_{res['cell']}.json").write_text(json.dumps(res,
                                                               indent=1))
    r = res["roofline"]
    print(f"[dryrun] {res['cell']} (analytic, walked on the host in "
          f"{cell_s:.1f} s): compute {1e3 * r['compute_s']:.3f} ms, memory "
          f"{1e3 * r['memory_s']:.3f} ms, collective "
          f"{1e3 * r['collective_s']:.3f} ms, dominant {r['dominant']}, "
          f"peak {res['memory']['peak_bytes'] / 1e9:.2f} GB a device, "
          f"useful FLOPs {r['useful_flops_ratio']:.3f}")
    out["cell"] = {"name": res["cell"], "walk_s": cell_s,
                   "roofline": r, "memory": res["memory"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,parity,serving,stablelm,"
                                         "starcoder2,paligemma,rwkv6,"
                                         "zamba2,hubert,llama4,train,"
                                         "sharded,sharded-train,dryrun",
                    help="comma-separated phases (default: all but "
                         "deepseek-full); e.g. kernels,train for the "
                         "kernels and the training phase")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # f32 references are full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    pk = peaks(name)
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(built)} kernel libraries built in {build_s:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "kernel_build.log").write_text(
        "\n".join(f"=== {k}\n{v}" for k, v in build.build_logs.items()))
    for k, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"[ptxas] {k}: {line.strip()}")

    report = {"card": card, "build_s": build_s, "phase_s": {}}
    kern = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        report["phase_s"][name] = time.perf_counter() - t
        print(f"[time] {name} phase: {report['phase_s'][name]:.1f} s")
        return out

    if "kernels" in phases:
        report["sass"] = sass_check()
        kern = timed("kernels", kernel_phase, pk)
    if "parity" in phases:
        report["parity"] = timed("parity", parity_phase)
    if "serving" in phases:
        report["serving"] = timed("serving", serving_phase, pk)
    if "deepseek" in phases and not {"parity", "serving"} & phases:
        report["parity"] = {"deepseek-parity": timed(
            "deepseek-parity", _parity_deepseek, "cuda")}
        report["serving"] = {"deepseek": timed("deepseek", deepseek_run,
                                               pk)}
    for key, *_ in DENSE_RUNS + SSM_RUNS:
        if key in phases:
            par = (ssm_parity if key in {r[0] for r in SSM_RUNS}
                   else dense_parity)
            report.setdefault("parity", {})[f"{key}-parity"] = timed(
                f"{key}-parity", par, key)
            report.setdefault("serving", {})[key] = timed(key, dense_run,
                                                          key, pk)
    if "hubert" in phases:
        report.setdefault("serving", {})["hubert"] = timed(
            "hubert", hubert_phase, pk)
    if "llama4" in phases:
        l4 = timed("llama4", llama4_phase, pk)
        report.setdefault("parity", {})["llama4-parity"] = l4.pop(
            "llama4-parity")
        report["moe_determinism"] = l4.pop("moe_determinism")
        report.setdefault("serving", {})["llama4"] = l4["llama4"]
    if "train" in phases:
        report["train"] = timed("train", train_phase, pk)
    if "sharded" in phases:
        report.setdefault("serving", {})["sharded"] = timed(
            "sharded", sharded_phase, pk)
    if "sharded-train" in phases:
        report["sharded_train"] = timed("sharded-train",
                                        sharded_train_phase, pk)
    if "dryrun" in phases:
        report["dryrun"] = timed("dryrun", dryrun_phase, report, pk)
    if "deepseek-full" in phases:
        report.setdefault("parity", {})["deepseek-parity-full"] = timed(
            "deepseek-full", _parity_deepseek, "cuda", 27)
    runs = [*report.get("serving", {}).values(), report.get("train", {}),
            report.get("sharded_train", {})]
    launches = {k: sum(run.get("launches", {}).get(k, 0) for run in runs)
                for k in REPLACES}
    rows = []
    for k in REPLACES:
        if k not in kern:
            continue
        r = kern[k]
        rows.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "tpu_kernel": REPLACES[k],
            "launches": launches.get(k, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"],
            "device_ms": r["device_ms"],
            "host_ms": (None if r["device_ms"] is None
                        else r["ms"] - r["device_ms"]),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "library_kernels": r.get("library_kernels"),
            "shape": r["shape"], "dtype": r["dtype"]})
        # the FFN's other timed shapes (decode at the other model, the
        # prefill tiles), each beside its bound and the cuBLAS chain
        rows[-1]["forms"] = [
            {f: fr[f] for f in ("shape", "variant", "device_ms", "ms",
                                "bound_ms", "bound_by", "chain_device_ms",
                                "chain")}
            for fr in kern.get("ffn_rows", []) if fr["name"] == k] + [
            {f: fr.get(f) for f in ("shape", "device_ms", "event_ms", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms")}
            for fr in kern.get("extra_rows", []) if fr["name"] == k]
        if "event_ms" in r:
            rows[-1]["event_ms"] = r["event_ms"]
    report["kernels"] = rows
    report["kernel_cases"] = kern.get("cases", {})
    report["profiler_windows"] = dict(DROPPED)
    print(f"[time] device_ms windows: {DROPPED}")
    for k in ("ffn_rows", "extra_rows", "tiles", "fused_norm_mobilevlm",
              *(f"qkv_proj_{t}_{w}" for t in ("mobilevlm", "fastvlm")
                for w in ("decode", "prefill"))):
        report[k] = kern.get(k)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
