#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorlink_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: card, power limit and toolchain versions;
2. build: compiles the four CUDA sources (paged decode, fused
   residual+norm, flash attention in bf16 and in f32; one nvcc each,
   sm_90a, all started together), prints ptxas's register lines and the number of HGMMA
   (wgmma) instructions in the flash forward's kernels, then times an
   empty kernel ("[floor]": the launch floor the norm rows print);
   the builds land in a fresh ``TL_COMPILE_CACHE_DIR`` (the kernel-build
   cache), and "[compile cache]" has a child process load the four
   CUDA libraries and the g++-built wire codec from it with no compiler
   run, printing cold build s against warm load s;
3. paged-decode kernel vs its plain PyTorch version at Llama-3-8B head
   shapes (T = 1 and T = 128; mixed lengths with sentinel-tailed block
   tables, a validity mask with a retired row, a window, int8 pools, the
   one-row form of a prefill chunk, decode over rows of whole pages, and
   the one-row chunk at lengths 128, 1024 and 2048; then f32 tensors on
   the general variant, D 64 with a mask per query, T = 4 decode rows
   with a mask per query, the speculative verify pass at T = 4 and 5,
   B 8, no mask, lengths to 2000, on the variant ``kernel_variant``
   names, and the masked decode step at one tensor-parallel rank's heads,
   model 2 (H 16 / Hkv 4) and model 8 (H 4 / Hkv 1)), each held to the
   variant it must launch, with its relative
   error, the fraction of its bound it reached and SDPA on the gathered
   view;
4. fused-norm kernel vs its plain version (rms and layer with bias at
   8 x 4096; LayerNorm of f32 rows whose mean is 1e3 beside a spread of
   ~1.4; D 4100 and 4097, which the 16-byte vector does not divide; 64
   rows x 5120; 4 rows x 32768 f32, split over a cluster of 4 blocks;
   GPT-2-medium's decode step, 8 x 1024 LayerNorm + bias), each with its
   host us per call, the launch floor and the
   time of torch.add + F.rms_norm / F.layer_norm as a two-call reference;
5. flash: the flash-attention forward (B1) and backward (B2) kernels vs
   their plain versions in bf16 at the paths' shapes (BERT-base with a
   padding mask, Llama-3-8B causal GQA, a causal window, a ragged length
   with a fully masked row), each timed beside its plain version, its
   bound and SDPA and its first design's time; B1 with its host us per
   call;
5b. sp kernel: B2's delta form (``flash_attention_bwd(delta=)``, the
   ring's backward) at [sp attention]'s block shapes (one rank's queries
   against a block of keys behind them) against its plain version, timed
   beside the own-delta form, its bound and flash SDPA's forward and
   backward at the whole sequence;
5a. capability: ``measure_capability`` at a size that fills the card (a
   chained 8192-square bf16 matmul, a 1 GiB HBM read), printed with the
   card's name and power limit: the peaks MFU, MBU and the receipt
   auditor are held against, and its ``capability.measured`` flight
   event;
6. serving: Llama-3-8B at full width and depth (random bf16 weights
   from a seed) served by ``PagedContinuousBatchingEngine`` over
   ``InferenceEngine``, built by ``Node._build_serving`` of a started port
   ``Node`` on 127.0.0.1 (its metrics, flight recorder, tracer and the
   capability attached): 12 greedy requests, launch counts checked against
   the path (decode steps on B3's decode variant, prefill chunks on its
   prefill variant, none on the general one), and a teacher-forced check
   of every emitted token against the port's no-cache forward (which runs
   B1 for the long prompts); ``[timer slice]`` prints
   ``stats()["device_time"]`` (the CUDA-event timer: per program count,
   busy and gap s, host-gap share, device tokens/s, MFU, MBU) and
   ``[metering slice]`` gates the meters: their busy seconds sum to the
   timer's within 1%, each has its prompt tokens, 32 emitted tokens and
   KV block-seconds, and each signs into a receipt that verifies and a
   ``ReceiptAuditor`` holding the capability accepts with no anomaly;
   the timer's decode busy a step is within 20% of the profiled
   model-step wall (``[timer slice vs profile]``); ``[telemetry]``:
   ``runtime.profiling.timed_capture(200)`` on a thread while the
   captured engine decodes 8 more requests (the ``GET /profile`` path),
   its breakdown naming B3 and B4; ``[node slice]`` gates the node's
   telemetry (``serving_requests_total`` = 12, ``serving_tokens_total``
   = the emitted tokens, one ``serving.request`` span a request with its
   prefill and decode children, one ``serving.admit`` event an
   admission), a second port node's PING with ``ts_since`` (its PONG's
   ``capability.programs`` and ``host_gap_frac`` are the engine's
   ``device_time()``, its ``kv`` is ``kv_stats_summary()``) and ``GET
   /kv`` and ``GET /metrics`` from the node's status server; ``[node
   slice kv race]``, on a batch of its own after the timed run, gates
   block conservation in every ``kv_stats`` snapshot a reader thread
   takes while another thread steps the engine (one at every step
   boundary, some with chunks in flight, the rest racing the steps);
   ``[node slice step]`` prints the model step with the telemetry sinks
   attached, detached and attached again on the same engine; then the 12
   requests again on an eager engine, SLICE_EAGER_NEW tokens each, under
   the same launch and teacher-forced gates;
6c. mesh paged: [slice]'s first 4 requests (16 tokens each) through the
   paged engine over ``InferenceEngine(model, mesh=make_mesh(
   MeshConfig()))`` (one NCCL rank, captured): tokens identical to a
   no-mesh engine's, one graph, B3 and B4 on the path, no collective
   (a size-1 group skips them);
6a. disagg: the same 12 requests split over a prefill leg P and a
   decode leg D (two engines of the [slice] geometry on one model):
   ``prefill_export``, ``pack_kv_payload(codec="none")``,
   ``unpack_kv_payload``, ``import_prefill`` with ``D.step()`` between
   imports, so grafts land with chunks in flight. Tokens equal the
   [slice] run's exactly; P launches B3 only in its prefill variant, D
   B3 decode and B4 once a layer a decode step, no prefill; every D chunk
   but the first a replay; the legs' export/import counts; the native
   codec built. Prints export, pack, unpack and import times and rates,
   blob bytes a prompt token and the zlib ratio on one request; then the
   timer and metering gates on P and D (P's meters bill prefill and emit
   0; D's carry the blob's bytes) and the profiled decode on D;
6b. disagg int8: 4 of those requests (prompts <= 600) int8 -> int8,
   token-identical to an int8 colocated engine, blobs under 0.6 of the
   float blob, B3's decode variant on int8 pools; then float -> int8 and
   int8 -> float, teacher-forced, with the share of tokens equal to the
   importing engine's colocated run;
6c. pipeserve (right after [slice], on its model): two started port
   ``WorkerNode``s each attach one ``pipeline_stage`` of an
   ``InferenceEngine`` over that model (layers [0, 16) and [16, 32),
   ``stage_spans``' even cut; the stages hold the model's own tensors),
   a port ``ValidatorNode`` plans, and a ``UserNode``'s
   ``RemoteServingClient`` sends [slice]'s first 4 prompts, 32 tokens
   each, through the head's ``PipelineCoordinator``: each stream equal
   to [slice]'s (where one departs, its first position and the
   teacher-forced logit margin there are printed) and every token within
   LOGIT_GAP_TOL of the teacher-forced row max; B3 32 a tick and a
   prefill chunk (16 a stage), B4 32 a tick; TTFT and ms a token;
6d. roles train: a port validator, two port workers and a user train
   BERT-base's 12 blocks split 6 + 6 (bf16, [8, 512, 768] in 2 micros,
   5 SGD steps): step 1's loss against the blocks run in this process,
   the loss falling, B1 48 and B2 24 a step, an honest PoL audit passing
   by digest while an audit of a worker that computes with perturbed
   params fails (B1 = B2 = 24 for the two); prints the step wall, the
   wire codec's share and bytes a step, and the codec on one micro;
7. static: the same model through ``InferenceEngine.generate`` (the
   default path of ``examples/serve_llm.py``): 4 left-padded prompts of
   700 to 2000 tokens, 64 greedy tokens, decode on the blockwise path over
   2304 cache slots; B4 once a layer a decode step, B1 never, every token
   teacher-forced; prefill seconds, decode ms a step and its kernel time,
   and a second call of the same shape;
7a. spec paged: the same Llama-3-8B on the paged engine with speculative
   decoding: 8 greedy requests of 8 tokens (half the prompts repeat a
   64-token phrase), first without speculation, then n-gram
   (``SpecConfig(k=4, rounds=2)``), the target as its own draft (k 3)
   and adaptive K (``SpecConfig.auto(k=4)``, the same draft), captured,
   and n-gram again eagerly; B3 once a
   layer a verify pass (on the variant ``kernel_variant`` names for
   T = K+1) and a prefill chunk, none on the general variant; B4 once a
   layer a draft step and never in n-gram mode; one graph, every spec
   chunk but its first a replay; the self-draft above one token a weight
   pass; acceptance, tokens a weight pass, TTFT, decode tokens/s and the
   share of tokens equal to the run without speculation (no profiled
   window: no gate reads one);
7b. overload: the paged Llama-3-8B engine with a pool of 88 blocks for 4
   requests needing 96, max_queue 2, priorities BATCH, STANDARD,
   INTERACTIVE, BATCH: preemption takes the least protected class first
   (BATCH before STANDARD before INTERACTIVE), every stream is
   teacher-forced and equal to an unpressured run; a queued BATCH request
   is displaced by an INTERACTIVE arrival (``OverloadedError``,
   ``retry_after_s`` > 0); an unmeetable deadline is refused at submit;
   ``result(deadline_s=)`` cancels a request with 2 chunks in flight and
   the pool's free count returns to what it was;
7c. int8: the [slice] requests on Llama-3-8B's weight-only int8 sibling
   (``default_draft_candidates``: quantized one ``Dense`` at a time into
   a meta-built model, no float copy) behind
   ``InferenceEngine(quantize="int8")``, captured: launches on the path,
   every token teacher-forced against the int8 model, the mean KL of
   int8 against bf16 logits on teacher-forced rows under 0.02 nats;
   weight bytes, the model step, the dequantize's share of it, MBU at
   int8 bytes; then 4 requests eagerly;
7d. fused qkv: the [slice] requests on a ``qkv_fused`` Llama-3-8B made
   from the same weights by ``fuse_qkv_params``, teacher-forced against
   the unfused model, its model step against [slice]'s;
7e. autopair: ``autopair_draft`` on the bf16 target (non-spec, the int8
   sibling, n-gram): the verdict, tokens/s per mode, and the burst's
   peak memory under the target plus one sibling;
7f. autotune: an adaptive engine saves to a temporary store (with the
   autopair verdict), a second engine warm-starts from it with the same
   record and K prior, and ``measure_capability(store=, key=)`` loads
   its record on the second call;
7g. chaos: the [overload] script twice under a plan of dispatch slows
   and a drain stall: streams equal to the unfaulted run, INTERACTIVE
   requests complete, the two logs equal; the disarmed hooks' cost;
7h. self-heal: a 2-layer random-weight draft with ``self_heal_accept``
   0.3: the engine downgrades itself, its graphs are dropped and
   re-captured, launches on the path, tokens teacher-forced before and
   after;
7i. async: 8 requests through ``asubmit``/``aresult`` (two at a time)
   equal to ``submit``/``result``;
7k. tp2, once the Llama-3-8B model is freed: two spawned ranks over
   gloo, both on cuda:0 (NCCL takes one rank a device; gloo carries the
   CUDA tensors through host copies: a correctness check of tensor
   parallelism, not a deployment), each holding half of every ``Dense``
   of Llama-3-8B at full width and TP2_LAYERS (4) of its 32 layers,
   eager: [slice]'s first 4
   requests through the paged (``[tp2 paged]``) and the contiguous
   engine (``[tp2 contiguous]``) and 2 left-padded prompts through
   ``generate`` (``[tp2 static]``, profiled), 16 tokens each; each rank
   gates its collectives (2 x 8 + 1 a model call) and launches (B3 8 a
   paged decode step and prefill chunk, B4 8 a decode step), and the
   parent, on the model rebuilt from the same
   seed, every token against the world-1 teacher-forced row max (and,
   printed, its share equal to that model's world-1 paged run). In the
   same job: ``[tp2 disagg]``, two of those requests exported by the TP-2
   paged engine (payloads at the global KV heads, equal on both ranks)
   and imported into a TP-2 engine (tokens equal to [tp2 paged]'s, B3 on
   the decode variant at H 16 / Hkv 4, no prefill chunk) and, in the
   parent, into a one-rank engine (every token teacher-forced; the
   payload against a one-rank export's); and first, while each rank
   still holds the whole model, ``[sp2 static]``: ``generate`` with
   ``kv_seq_shard=True`` on a seq-2 mesh serves [tp2 static]'s prompts
   with half of the world-1 cache a rank, B4 32 a decode step, every
   token teacher-forced in the parent. Then, Llama freed, expert
   parallelism at model 2 (each rank builds the whole model in turn, a
   barrier between, and keeps its blocks): ``[ep2 mixtral paged]``,
   [mixtral paged]'s model (Mixtral-8x7B at full width, 4 layers) with 4
   of the 8 experts and Hq 16 / Hkv 4 a rank, [slice]'s first 4 requests
   through the paged engine for 16 tokens, eager: the MoE layers in
   their fallback form (9 collectives a model call, no all_to_all), B3
   and B4 on the path, a rank's expert bytes half of the whole's, every
   token against the rank's own one-row paged replay (its routing
   recorded for [mixtral paged]); ``[ep2 mixtral train]``,
   ``ShardedTrainer`` at model 2 on a CUDA mesh over the gloo group,
   Mixtral-8x7B's width at 2 layers, SGD, 4 x 512 in 2 micros, 3 steps,
   the MoE layers in their all_to_all form: B1 = B2 = 4 and 16
   all_to_all swaps a step a rank, and in the parent the first loss
   within 1e-3 (relative) of the same step at world 1 (run on one NCCL
   rank before the job) and every gradient leaf of each rank's blocks
   at cosine >= 0.99 of world 1's or at bf16's noise floor (an f32
   world-1 step decides);
7j. mixtral paged, once the Llama-3-8B model is freed: Mixtral-8x7B at
   full width and MIX_LAYERS (4) of its 32 layers (random bf16 weights,
   about 11.8 GB a weight pass; the reference quantizes no expert, the
   full depth's 90.2 GB of experts would not fit, and 4 layers keep the
   run's time in budget beside the roles legs) through the paged engine in the
   [slice] geometry, captured then eager: B3 and B4 4 times a decode
   step, B3's prefill variant 4 times a chunk, replays, the weight-pass
   bytes from the config; every token against two same-T replays (the
   engine's 128-token chunks, then one token a step): one row on a
   paged cache through B3 (its recorded routing: a decode drop
   fraction of exactly 0), and the contiguous cache with the plain
   attention and that routing pinned; then ``generate`` on 8 left-padded prompts of
   100-700 tokens, replayed row by row at T0; then [ep2 mixtral paged]'s
   tokens against this world-1 model's one-row paged replay with rank
   0's routing pinned (the model-2 sums round otherwise and would flip
   router near-ties), and their agreement with this run's tokens;
8. contiguous: GPT-2-medium (random bf16 weights) served by the contiguous
   ``ContinuousBatchingEngine`` (the ``--continuous`` path): 16 greedy
   requests of 1 to 900 tokens, B4 in its LayerNorm + bias form on every
   decode step, every token teacher-forced; TTFT and tokens/s;
8a. spec contiguous: GPT-2-medium on the contiguous engine with n-gram
   speculation (k 4, 2 rounds): the verify pass is per-row T = 5 through
   the plain attention, so no kernel launches in decode (B4 0);
9. rolling: Mistral-7B's width at 4 of its 32 layers through
   ``InferenceEngine(rolling_cache=True).generate`` (the ``--window``
   path): 2 prompts, 4200 greedy tokens, so the ring of prompt + window
   slots wraps; B4 on every decode step, every token teacher-forced
   against the windowed no-cache forward (B1 with its window), and the
   full cache's plan beside it for its bytes;
10. training: BERT-base fine-tuning at batch 8 x seq 512 (f32 master
   params from a seed, bf16 compute, Adam, dropout 0.1) through
   ``Trainer`` with a tracer, metrics and a flight recorder: 30 steps
   with a falling loss, B1/B2 launch counts, ``[train telemetry]`` (one
   ``trainer.step`` span a step after the first's ``compile_step``, the
   ``step_s`` series, ``device_time()`` over every step but the first,
   no non-finite event), one
   step's gradients against the plain attention path, step time, MFU, a
   profiled step, ``[telemetry]``'s ``runtime.profiling.op_breakdown`` of
   one step (naming B1 and B2), and the batch 32 x seq 128 headline shape
   under "auto" and "flash";
10a. lora: the same model and batch with rank-8 adapters (``lora_init``,
   alpha 16, on q, k, v, o, up and down) through
   ``Trainer(train_only="lora")``, 30 steps at lr 1e-3: trainable and
   total counts, step ms, samples/s and MFU at the adapter step's own
   flops, peak memory, a profiled step; B1 = B2 = 12 x 30 launches, every frozen leaf
   bit-identical, every ``lora_a`` moved, a falling loss, the first
   step's adapter gradients against the plain attention's, and the eval
   logits after ``lora_merge`` against the unmerged model's (f32 and
   bf16 tolerances at the top of the file);
10b. checkpoint: the [lora] model with every leaf trainable, 4 steps
   against 2 + an async ``CheckpointManager`` save + restore into a
   fresh ``init_state()`` on the card + 2 steps, dropout generators
   seeded from the step: params, moments and step bit-identical; bytes
   written, save and restore s and GB/s (a temporary directory under
   ``_build/``, removed);
10c. sharded bert: the [train] model and batch through
   ``bert_pipeline_parts`` and ``ShardedTrainer`` (GPipe, 4 micros) on a
   one-rank NCCL mesh (``make_mesh(MeshConfig())``): at dropout 0 the
   first step's loss and every gradient leaf against the single-host
   ``Trainer`` at 4 micros (the [train] thresholds), ``remat=True`` with
   the same loss and twice the B1 launches, then 10 steps at dropout
   0.1 with a falling loss, B1 = B2 = 12 x 4 a step, ``[sharded bert
   telemetry]`` (the ``engine`` spans with ``{"stages", "micros"}``, as
   [train]'s), step ms, samples/s, MFU, peak memory and a profiled step
   beside [train]'s step;
10d. sharded gpt2: GPT-2-medium at full width and SHARD_GPT2_LAYERS
   (12) of its 24 layers through
   ``GPT2.as_pipeline_parts`` under 1F1B (batch 8 x 1024, 4 micros,
   AdamW, bf16) on the same mesh: at dropout 0 the first step's loss
   and every gradient leaf (the tied ``wte`` included) against GPipe,
   each held against the f32 plain-attention gradient where they part,
   then 10 steps at dropout 0.1 with a falling loss, B1 = B2 = 12 x 4 a
   step, tokens/s, MFU, a profiled step, peak memory and
   ``measure_bubble``'s fit beside the closed form; the process group
   is destroyed after the two legs, failed or not;
10e. sp: two spawned ranks over gloo on cuda:0 (the ring's hops through
   pinned host buffers, as ``parallel/sp.py`` stages them on gloo): ``[sp
   attention]`` runs the ring (B1 per block not ahead, B2 given the
   ring's delta) and Ulysses (B1/B2 at H/2 heads) forward and backward at
   Llama-3-8B's attention (1 x 8192 as 2 x 4096, H 32 / Hkv 8, D 128,
   causal) and BERT-base's (8 x 512 as 2 x 256, H 12, D 64, a padding
   mask), each rank's o, dq, dk, dv against B1/B2 on the whole sequence
   ([flash]'s tolerances) and its launches per rank (causal ring: B1 and
   B2's delta form r + 1 times on rank r); then ``[sp2 gpt2]``:
   GPT-2-medium at full width and [sharded gpt2]'s 8 layers with
   ``attn_impl="ring"``
   through ``ShardedTrainer`` on a seq-2 mesh under 1F1B, [sharded
   gpt2]'s batch: the first step's loss and every gradient leaf against
   [sharded gpt2]'s step at seq 1 (its thresholds), B1 and B2's delta
   form 24 x 4 x (r + 1) a step on rank r, a profiled
   step's busy share (gloo through host copies: a correctness check,
   not a speed).
11. the model zoo (slice 19). ``[flash f32]`` (inside [flash]): B1 and
   B2 in their f32 forms (``csrc/flash_attention_f32.cu``) at
   BERT-base's and Llama-3-8B's shapes against the plain f32 versions
   (worst error relative to max |plain|: 1e-4 for o, 1e-3 for each
   gradient), timed beside the plain version, one f32 SDPA call and the
   bound at the f32 vector peak. ``[diag]`` (inside [slice]):
   ``diag.scrape_cluster`` of the [node slice] node's status port, its
   row healthy with its KV pool and the scraped /kv its ``kv_stats``.
   ``[hf llama]`` (after the Llama-3-8B model is freed): the width at 2
   of 32 layers written as an HF-layout BF16 ``.safetensors`` file (a
   small writer here), read by the port's ``load_safetensors`` and mapped
   by ``llama_params_from_hf`` (which must give back the model's state),
   [slice]'s first 4 prompts served captured for 16 tokens, equal to an
   engine built from the same tensors with no file in between, B3 and
   B4 on the path. After [sp]: ``[hf bert f32]`` (BERT-base from an f32
   HF file, 3 ``Trainer`` steps in f32 at 8 x 512, dropout off: B1 f32 and
   B2 f32 12 a step each, step 1 within 1e-4 of plain f32 attention, the
   loss falling), ``[vit]`` (ViT-B/16 at 224 from an HF file, 3
   ``Trainer`` and 3 ``ShardedTrainer`` steps over ``vit_pipeline_parts``
   on one NCCL rank at batch 32 in bf16: falling losses, first losses
   within 1e-2, no B1 at 197 tokens), ``[t5]`` (T5-small from an HF file:
   ``greedy_decode`` of 8 padded sources of 64-512 tokens, 32 tokens each,
   every token within 0.5 of a teacher-forced ``decode()``'s row max; 3
   ``Trainer`` steps falling; no kernel launch) and ``[ingest]`` (an
   ``nn.TransformerEncoder`` at BERT-base's widths through ``from_torch``,
   the forward at 8 x 512 within 1e-4 of the module's own).
12. the f16 forms. ``[flash f32]`` holds B1 and B2 in their f32 forms
   (``csrc/flash_attention_f32.cu``, now on the tensor cores in TF32
   with a three-product split) at the f32 gates
   above, and their f16 forms (the same source) against the plain
   version fed the same f16 tensors (1e-3 of max |plain| for o, 5e-3 for
   each gradient), each row with its bound (``bound_ms``: the function's
   operations at the 3xTF32 rate in f32, at the 16-bit tensor-core rate
   in f16), the TF32 products the form runs at the TF32 rate
   (``bound_ms_tf32``) and its operations at the f32 vector peak
   (``bound_ms_vector``). ``[paged]`` adds f16 q and pools (B3's general
   variant). ``[hf llama]`` adds an f16 sibling of its 2-layer model
   serving 2 prompts: every token within 0.5 of the f16 model's
   teacher-forced row max, B3's general variant 2 x (decode steps +
   prefill chunks). After [hf bert f32], ``[bert f16]``: BERT-base, one
   ``Trainer`` step in f16 at 8 x 512, dropout off: B1 and B2 12 f16
   launches each and no other form, the loss finite and within 1e-3 of
   plain f16 attention's, and each gradient leaf at cosine 0.999 with
   plain f16 attention's, or, where plain f16 is itself off the f32
   gradient, no farther from it than twice plain's error.
13. the f16 forms on the 16-bit tensor cores, and other head dims.
   B1/B2's f16 forms run on ``csrc/flash_attention.cu`` (bf16's source,
   instantiated on f16: wgmma forward, mma.sync m16n8k16 backward with
   each row of dS scaled by a power of two against underflow);
   ``[build]`` counts HGMMA in every forward kernel of both 16-bit forms,
   16-bit HMMA (``HMMA.16816.F32``, no ``.BF16``) in every f16 backward
   kernel, and finds no f16 kernel or entry in ``flash_attention_f32.cu``.
   ``[flash f32]``'s f16 rows carry the fraction of the bound the kernel
   reaches, and B2 again with dO scaled by 2^-16 and 2^-24
   (``F16_DO_SCALES``, gated by ``_f16_grad_ok``). ``[flash d]``: head
   dims 96 and 80 (zero-padded to 128 by the wrappers) in bf16, f32 and
   f16, B1, B2 and B2's delta form against their plain versions at each
   form's tolerances; ``[sp attention]`` runs the ring and Ulysses once
   at D 96 (``SP_CASES["d96"]``).
14. head dims up to 256 and B3's f16 form on the tensor cores.
   ``[build]`` finds HGMMA in the D 256 forward kernels, 16-bit HMMA in
   the D 256 backward kernels (f16's and bf16's) and TF32 HMMA in the
   f32 library's D 256 kernels, and prints each D 256 flash kernel's
   registers and spill bytes (ptxas) beside its D 128 twin's.
   ``[flash d]`` adds D 256 (Gemma-7B's 16 heads at a causal 2048) and
   D 160 (zero-padded to 256) in every form, each row timed beside the
   kernels at D 128 and SDPA at its own D and dtype. ``[paged]``'s f16 q
   runs the decode variant (over f16 pools, with and without the
   decode steps' mask, and over int8 pools, once with V of absmax near
   1e-4) and the prefill variant (the chunk's one row); f16 q over bf16
   pools keeps the general variant. ``[hf llama f16]`` counts every
   decode step's paged read on "decode" and every prefill chunk's on
   "prefill", none on "general".

Legs 6-9, 7a, 7b, 7j and 8a run their decode as CUDA-graph replays (the engines' default)
with ``pipeline_depth`` 2 chunks in flight on the serving engines; the
launch gates hold through the graphs' replay credit, and each leg checks
that every decode chunk (or step) but each graph's first was a replay
and prints a ``[... graphs]`` line (graphs, captures, capture s,
replays, pool bytes). Each leg then runs the same requests on an eager
engine of the same class (``cuda_graphs=False``) under the same gates
and prints ``[... eager vs captured]`` (the share of equal tokens and
each run's worst teacher-forced gap over the first decode chunk) and
``[... step]`` (each run's whole wall; the model-step wall, kernel ms
and busy share from a profiled window of steady-state steps, of the
captured run on the serving engines and of both runs of ``generate``).
Before them, ``[sampler]`` checks the counter sampler's hash bits on the
card against the CPU's.

Each leg's launch counts are set to 0 just before it runs and read just
after; B4's count in the kernels line sums the four serving legs, the
captured speculative draft runs, the disaggregated decode legs (float
and int8) and the legs 7c-7j (the [ep2 mixtral paged] ranks' among them), B3's
the paged leg, the captured speculative runs, both disaggregated runs
(prefill variant on P, decode on D) and the paged legs 7c-7j; B1's and
B2's sum legs 10, 10a, 10b, 10c, 10d and 10e and [ep2 mixtral train]
(``[launches] flash_attention``); B2's delta form, leg 10e's ring runs; the
f32 forms of B1 and B2, [hf bert f32]'s steps; their f16 forms, [bert
f16]'s step. The
last lines are ``[phase seconds]`` (each phase's wall), the card's name
and power limit, a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Nothing of JAX or ``tensorlink_tpu``
is imported.
"""

import asyncio
import collections
import concurrent.futures
import ctypes
import dataclasses
import gc
import json
import os

# before the first cuBLAS call: the proof-of-learning runs of [roles
# train] ask for deterministic cuBLAS kernels, which need a fixed
# workspace configuration
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from tensorlink_tpu_torch import diag as tldiag
from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.config import DistributedConfig, MeshConfig, NodeConfig, TrainConfig
from tensorlink_tpu_torch.convert import apply_dtype_policy
from tensorlink_tpu_torch.models.bert import Bert, BertClassifier, BertConfig, bert_pipeline_parts
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.hf_import import (
    SAFETENSORS_DTYPES,
    bert_params_from_hf,
    llama_params_from_hf,
    load_safetensors,
    t5_params_from_hf,
    vit_params_from_hf,
)
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.models.t5 import T5, T5Config
from tensorlink_tpu_torch.models.torch_ingest import from_torch
from tensorlink_tpu_torch.models.vit import ViT, ViTClassifier, ViTConfig, vit_pipeline_parts
from tensorlink_tpu_torch.nn.layers import Embedding
from tensorlink_tpu_torch.nn.lora import lora_init, lora_merge, trainable_leaf_count
from tensorlink_tpu_torch.nn.module import NamedSharding
from tensorlink_tpu_torch.nn.module import Sequential as RolesSequential
from tensorlink_tpu_torch.nn.staging import layer_param_bytes, stage_spans
from tensorlink_tpu_torch.nn.attention import (
    DECODE_BLOCK,
    DECODE_BLOCKWISE_MIN_WINDOWLESS,
    fuse_qkv_params,
)
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops.decode_glue import (
    FORMS,
    fused_residual_norm,
    fused_residual_norm_reference,
    launch_geometry,
)
from tensorlink_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_reference,
)
from tensorlink_tpu_torch.ops.paged_decode import (
    VARIANTS,
    kernel_variant,
    paged_decode_attention,
    paged_decode_reference,
)
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    counter_bits,
    sample_logits_at,
    weight_pass_bytes,
)
from tensorlink_tpu_torch.p2p.crypto import HAVE_CRYPTOGRAPHY, Identity
from tensorlink_tpu_torch.p2p.node import Node
from tensorlink_tpu_torch.p2p.serialization import pack_arrays, packed_nbytes, unpack_arrays
from tensorlink_tpu_torch.parallel.kvwire import pack_kv_payload, unpack_kv_payload
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    DeadlineExceededError,
    OverloadedError,
    PagedContinuousBatchingEngine,
    Priority,
    SpecConfig,
)
from tensorlink_tpu_torch.parallel import tp
from tensorlink_tpu_torch.parallel.engine import ShardedTrainer
from tensorlink_tpu_torch.parallel.speculative import autopair_draft, default_draft_candidates
from tensorlink_tpu_torch.runtime import chaos, compile_cache
from tensorlink_tpu_torch.runtime.autotune import GLOBAL_MODEL, AutotuneStore, store_key
from tensorlink_tpu_torch.runtime.checkpoint import CheckpointManager
from tensorlink_tpu_torch.runtime.chaos import ChaosPlan
from tensorlink_tpu_torch.runtime.mesh import (
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)
from tensorlink_tpu_torch.runtime.ledger import (
    ReceiptAuditor,
    build_receipt,
    verify_receipt,
)
from tensorlink_tpu_torch.runtime import profiling
from tensorlink_tpu_torch.runtime.flight import FlightRecorder
from tensorlink_tpu_torch.runtime.metrics import Metrics
from tensorlink_tpu_torch.runtime.profiling import measure_capability
from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
from tensorlink_tpu_torch.roles.user import UserNode
from tensorlink_tpu_torch.roles.validator import ValidatorNode
from tensorlink_tpu_torch.roles.worker import WorkerNode
from tensorlink_tpu_torch.runtime.tracing import Tracer
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
PAGED_ATOL, PAGED_RTOL = 2e-2, 1e-2  # bf16 outputs, f32 accumulation both sides
# and, per case, the relative Frobenius error of the whole output: the
# atol alone is half a typical |o| over a long row, so a fault confined to
# one partition could pass it; bf16 rounding of o and of P gives ~3e-3
PAGED_REL = 1e-2
NORM_ATOL, NORM_RTOL = 1e-2, 1e-2  # bf16 outputs of an f32 row reduction
LOGIT_GAP_TOL = 0.5  # teacher-forced: emitted token within this of the row max
# flash: o is a bf16 output of f32 sums whose P operand is rounded to bf16
# (as in B3: atol + rtol elementwise, and the relative Frobenius error of
# the whole output, since over a long row the atol is half a typical |o|);
# lse is f32 math on the same scores; each gradient is a bf16 output of f32
# sums over up to T terms whose P / dS operands are rounded to bf16:
# relative Frobenius error
FLASH_O_ATOL, FLASH_O_RTOL = 2e-2, 1e-2
FLASH_O_REL = 1e-2
FLASH_LSE_ATOL = 1e-3
FLASH_GRAD_REL = 1e-2
# training: kernel vs plain attention gradients of one bf16 step. A leaf
# passes at cosine >= 0.99 with the plain path; where the plain bf16 path
# is itself farther than cosine 0.999 from the f32 gradient (a leaf whose
# gradient sits near bf16's rounding noise), the kernel path must be no
# farther from the f32 gradient than NOISE_RATIO times the plain path
TRAIN_COSINE_MIN = 0.99
TRAIN_SIGNAL_COSINE = 0.999
TRAIN_NOISE_RATIO = 2.0
TRAIN_LOSS_TOL = 1e-2
CLASSES = 3  # the reference bench's classifier width
# LoRA fine-tuning: rank 8, alpha 16 on the default targets (q, k, v, o,
# up, down), adapters trained at lr 1e-3. After lora_merge the eval
# logits must equal the unmerged model's: in f32 within LORA_MERGE_F32
# absolute (the merged weight's own f32 rounding, ~1e-7 a weight, through
# 12 layers); in bf16 (w + ab*s rounded to bf16 once, against bf16 w plus
# a bf16 side product) within a relative Frobenius error of the larger of
# LORA_MERGE_REL and LORA_NOISE_RATIO times the unmerged model's own bf16
# error against its f32 logits
LORA_RANK, LORA_ALPHA, LORA_LR = 8, 16.0, 1e-3
LORA_MERGE_F32 = 1e-3
LORA_MERGE_REL = 3e-2
LORA_NOISE_RATIO = 2.0
CKPT_SAVE_AT, CKPT_STEPS = 2, 4  # [checkpoint]: save after 2 of 4 steps
SHARD_MICRO = 4  # micro-batches of the sharded legs
SHARD_BERT_STEPS = 10
SHARD_GPT2_STEPS = 10
# [sharded gpt2] and [sp2 gpt2]: GPT-2-medium's width at a third of its
# depth (cut to pay for the [roles train], [pipeserve] and zoo legs)
SHARD_GPT2_LAYERS = 8  # 12 before the zoo's legs
# [sp *]: two gloo ranks on cuda:0; name -> (B, H, Hkv, whole T, D,
# causal, mask) of [sp attention]'s cases
SP_WORLD = 2
SP_CASES = {
    "llama": (1, 32, 8, 8192, 128, True, None),
    "bert": (8, 12, 12, 512, 64, False, "bert"),
    # a head dim the wrappers zero-pad (to 128)
    "d96": (1, 8, 8, 2048, 96, True, None),
}
SP2_STEPS = 1
DEV = "cuda"


def say(*parts) -> None:
    print(*parts, flush=True)  # noqa: T201


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class L2Flush:
    """Overwrites a buffer larger than the 50 MB L2 before each timed
    launch, so a kernel reads its inputs from HBM as on the main path."""

    def __init__(self):
        self.buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self):
        self.buf.zero_()


def time_runs(fn, flush: L2Flush, iters: int = 20) -> np.ndarray:
    """Device ms of ``iters`` launches of ``fn``, each timed with CUDA
    events after an L2 flush. A ~1 ms device sleep ahead of the first
    event lets the host enqueue the launch before the card gets there, so
    host launch overhead stays out of the device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return np.asarray(times)


def time_ms(fn, flush: L2Flush, iters: int = 20) -> float:
    """Mean device ms of ``fn`` (see ``time_runs``): every reported
    ``ms`` is this mean."""
    return float(time_runs(fn, flush, iters).mean())


def time_mean_median(fn, flush: L2Flush, iters: int = 20) -> tuple[float, float]:
    """(mean, median) device ms of ``fn`` over the same launches; the
    median is printed beside the mean, since one launch delayed by
    something else on the machine can carry the mean with it."""
    t = time_runs(fn, flush, iters)
    return float(t.mean()), float(np.median(t))


# --------------------------------------------------------------- phases
def host_us(fn, calls: int = 200, samples: int = 5) -> float:
    """Host microseconds per call of ``fn``, the median of ``samples``
    samples: each ``calls`` calls enqueued behind a ~50 ms device sleep,
    so the launch queue never blocks and the host clock reads the
    wrapper's own cost."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name_power = smi()
    say(f"[device] {name_power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {_build.nvcc_version().splitlines()[-1]}")
    return torch.cuda.get_device_name(0), name_power


CUDA_SOURCES = ("paged_decode.cu", "decode_glue.cu", "flash_attention.cu",
                "flash_attention_f32.cu")


def sass_counts(lib_path: str, opcode: str = "HGMMA", unless: str | None = None) -> dict:
    """{kernel: number of ``opcode`` instructions} in the library's SASS
    (HGMMA: wgmma; HMMA.16816.F32: mma.sync m16n8k16, in bf16 with
    ``.BF16`` after it, so ``unless=".BF16"`` counts the f16 ones;
    HMMA.1688.F32.TF32: mma.sync m16n8k8 in tf32). Kernel names are
    mangled: the f16 instantiations carry ``__half``, the bf16 ones
    ``__nv_bfloat16``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in ln and (unless is None or unless not in ln):
            counts[fn] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """{mangled kernel: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v``'s output (each entry's "Compiling entry", then its
    "N bytes spill stores, M bytes spill loads" and "Used R registers")."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            out[fn] = {}
        elif fn is not None and "spill stores" in ln:
            words = ln.replace(",", " ").split()
            at = [i for i, w in enumerate(words) if w == "spill"]
            out[fn]["spill_stores"] = int(words[at[0] - 2])
            out[fn]["spill_loads"] = int(words[at[1] - 2])
        elif fn is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            out[fn]["registers"] = int(words[words.index("Used") + 1])
    return out


def _flash_d_report(report: dict) -> dict:
    """[build]'s D 256 lines: for every flash kernel instantiated at D 256
    (mangled ``Li256E``), its registers and spill bytes beside the D 128
    instantiation of the same kernel, form and band (``Li128E``)."""
    rows = {}
    for name, r in report.items():
        if "Li256E" not in name or "flash_" not in name:
            continue
        twin = report.get(name.replace("Li256E", "Li128E"), {})
        rows[name] = {"d256": r, "d128": twin}
    return rows


def phase_build() -> dict:
    def build_cuda(source):
        t0 = time.perf_counter()
        path, log, _ = _build.build(source, verbose=True)
        return time.perf_counter() - t0, path, log

    t_all = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as ex:
        fcs = {src: ex.submit(build_cuda, src) for src in CUDA_SOURCES}
        built = {src: f.result() for src, f in fcs.items()}
    wall = time.perf_counter() - t_all
    for src, (cuda_s, path, log) in built.items():
        say(f"[build] {src} nvcc {cuda_s:.1f} s -> {path}")
        for ln in log.splitlines():
            # and any wgmma serialization ptxas reports (C75xx)
            if any(w in ln for w in ("registers", "Compiling entry", "spill",
                                     "Performance Loss")):
                say(f"[build]   ptxas: {ln.strip()}")
    lib16 = built["flash_attention.cu"][1]
    # every forward kernel of both 16-bit forms (3 D x band or not) on wgmma
    fwd = {k: n for k, n in sass_counts(lib16).items() if "flash_fwd_kernel" in k}
    for k, n in fwd.items():
        say(f"[build] HGMMA {n} in {k}")
    check(len(fwd) == 12 and min(fwd.values()) > 0
          and sum("__half" in k for k in fwd) == 6
          and sum("Li256E" in k for k in fwd) == 4,
          f"a flash forward kernel has no HGMMA instruction: {fwd}")
    # the backward kernels' products on the 16-bit mma: f16's without
    # .BF16, bf16's with it (D 64 and 128: dq 2 bands, dkv 2 quads x 2
    # bands; D 256: dq and dkv (one quad) x 2 bands)
    hm = {k: n for k, n in sass_counts(lib16, "HMMA.16816.F32", ".BF16").items()
          if "flash_bwd" in k and "__half" in k}
    for k, n in hm.items():
        say(f"[build] HMMA.16816.F32 (f16) {n} in {k}")
    check(len(hm) == 16 and min(hm.values()) > 0,
          f"an f16 flash backward kernel has no f16 mma instruction: {hm}")
    hb = {k: n for k, n in sass_counts(lib16, "HMMA.16816.F32.BF16").items()
          if "flash_bwd" in k and "Li256E" in k and "__nv_bfloat16" in k}
    for k, n in hb.items():
        say(f"[build] HMMA.16816.F32.BF16 {n} in {k}")
    check(len(hb) == 4 and min(hb.values()) > 0,
          f"a bf16 D 256 flash backward kernel has no bf16 mma instruction: {hb}")
    # the f32 form's products run on the tensor cores in tf32; no f16 there
    lib32 = built["flash_attention_f32.cu"][1]
    tc = sass_counts(lib32, "HMMA.1688.F32.TF32")
    for k, n in tc.items():
        say(f"[build] HMMA.1688.F32.TF32 {n} in {k}")
    check(len(tc) == 18 and min(tc.values()) > 0
          and sum("Li256E" in k for k in tc) == 6,
          f"an f32 flash kernel has no tf32 mma instruction: {tc}")
    # D 256 beside D 128: registers and spill bytes (ptxas -v)
    dreport = {}
    for src in ("flash_attention.cu", "flash_attention_f32.cu"):
        dreport.update(_flash_d_report(ptxas_report(built[src][2])))
    for k, r in dreport.items():
        say(f"[build] D 256 vs D 128 {k}: {json.dumps(r)}")
    check(len(dreport) == 18,
          f"[build] expected 18 flash kernels at D 256 in ptxas's report, got {len(dreport)}")
    f16_left = [k for k in tc if "__half" in k] + [
        e for e in ("tl_flash_fwd_f16", "tl_flash_bwd_f16")
        if hasattr(ctypes.CDLL(lib32), e)]
    check(not f16_left, f"flash_attention_f32.cu still holds an f16 form: {f16_left}")
    return {"wall_s": wall, "d256": dreport, **{src: b[0] for src, b in built.items()}}


def phase_floor(flush) -> float:
    """Mean device ms of an empty kernel (torch.cuda._sleep(0)), timed as
    every kernel here is: the least any launch reads."""
    t = time_runs(lambda: torch.cuda._sleep(0), flush)
    floor = {"floor_ms": float(t.mean()), "median_ms": float(np.median(t))}
    say(f"[floor] {json.dumps(floor)}")
    return floor["floor_ms"]


def phase_sampler() -> None:
    """The counter sampler on the card against the CPU for a few (seed,
    position) rows at Llama-3's vocabulary: the same hash bits (gated,
    exact) and the draws they give (printed)."""
    seeds = torch.tensor([0, 1, 11, 2**31 + 7, -5, 123456789, 42, 7])
    pos = torch.tensor([0, 1, 300, 4095, 2**33 + 1, 17, 2048, 99])
    V = 128256
    bits_cpu = counter_bits(seeds, pos, V)
    bits_gpu = counter_bits(seeds.to(DEV), pos.to(DEV), V).cpu()
    logits = torch.randn(len(seeds), V, generator=torch.Generator().manual_seed(5))
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
    tok_cpu = sample_logits_at(logits, seeds, pos, **kw)
    tok_gpu = sample_logits_at(logits.to(DEV), seeds.to(DEV), pos.to(DEV), **kw).cpu()
    same = bool(torch.equal(bits_cpu, bits_gpu))
    say(f"[sampler] {len(seeds)} (seed, position) rows x {V}: hash bits equal "
        f"CPU/CUDA {same}; draws equal {int((tok_cpu == tok_gpu).sum())}/{len(seeds)}")
    # the draws also pass through log and the filter's softmax, whose last
    # bits may differ between devices: printed, not gated
    check(same, "sampler: CUDA hash bits differ from the CPU's")


def _paged_inputs(g, T, case):
    """Llama-3-8B head shapes: H 32, Hkv 8, D 128, bs 16, MB 128, B 8;
    D 64 for "d64_qmask", f32 q and pools for "f32"; f16 q for the cases
    named "f16...", over f16 pools, int8 pools ("f16_int8", and
    "f16_int8_small_v" whose V has absmax near 1e-4) or bf16 pools
    ("f16_over_bf16"), "f16_mask" with the decode steps' mask and
    "f16_one_row" a prefill chunk; one
    rank's heads under tensor parallelism for "tp2_mask" (model 2: H 16, Hkv 4) and
    "tp8_mask" (model 8: H 4, Hkv 1), with the decode steps' mask, and
    for "tp2_chunk", a prefill chunk (one row) at model 2's heads."""
    B, H, Hkv, bs, MB = 8, 32, 8, 16, 128
    if case.startswith("tp"):
        model = int(case[2])
        H, Hkv = H // model, Hkv // model
    D = 64 if case == "d64_qmask" else 128
    dt = (torch.float32 if case == "f32" else
          torch.float16 if case.startswith("f16") else torch.bfloat16)
    kv_dt = torch.bfloat16 if case == "f16_over_bf16" else dt
    NB = B * MB + 64
    dev = DEV
    if case == "full_pages":
        lengths = torch.tensor([16, 128, 256, 512, 1024, 1536, 2032, 2048],
                               dtype=torch.int32)
    elif case == "verify":
        # the speculative verify pass: K + 1 queries a row, no mask, rows
        # of mixed lengths up to 2000
        lengths = torch.tensor([T + 40, 300, 517, 811, 1024, 1500, 1777, 2000],
                               dtype=torch.int32)
    elif case.startswith("chunk_"):
        lengths = torch.full((B,), int(case[len("chunk_"):]), dtype=torch.int32)
    else:
        lengths = torch.tensor(
            [T, 17 + T, 130 + T, 511, 1000, 1503, 1919, 2048], dtype=torch.int32
        ).clamp(max=MB * bs)
    perm = torch.randperm(NB, generator=g)
    bt = torch.full((B, MB), NB, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)  # live blocks; the tail stays sentinel
        bt[b, :n] = perm[b * MB:b * MB + n].int()
    q = torch.randn((B, T, H, D), generator=g).to(dev, dt)
    mask = None
    window = None
    k_scale = v_scale = None
    if case in ("int8", "f16_int8", "f16_int8_small_v"):
        k = torch.randint(-127, 128, (NB, bs, Hkv, D), generator=g,
                          dtype=torch.int8).to(dev)
        v = torch.randint(-127, 128, (NB, bs, Hkv, D), generator=g,
                          dtype=torch.int8).to(dev)
        k_scale = (torch.rand((NB, bs, Hkv), generator=g) / 64).to(dev)
        v_scale = (torch.rand((NB, bs, Hkv), generator=g) / 64).to(dev)
        if case == "f16_int8_small_v":
            # V of absmax near 1e-4: scales absmax / 127 near 8e-7, where
            # p v_scale sinks below f16's normal range
            v_scale = (1e-4 / 127) * (0.5 + v_scale * 32)
    else:
        k = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, kv_dt)
        v = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, kv_dt)
    if case in ("mask", "tp2_mask", "tp8_mask", "f16_mask"):
        # validity mask over the view (the decode steps' form), with
        # holes, and row 0 retired: sentinel table, nothing valid
        kpos = torch.arange(MB * bs)
        valid = kpos[None, :] < lengths[:, None]
        valid &= torch.rand((B, MB * bs), generator=g) > 0.1
        valid[0] = False
        bt[0] = NB
        mask = valid[:, None, None, :].to(dev)
    if case == "full_pages":
        # the decode steps' validity mask over rows that end on a page
        # boundary: every live key valid
        mask = (torch.arange(MB * bs)[None, :] < lengths[:, None])[:, None, None, :].to(dev)
    if case.endswith("qmask"):
        # a mask per query [B, 1, T, Lv] over the view, with holes
        kpos = torch.arange(MB * bs)
        valid = kpos[None, None, :] < lengths[:, None, None]
        valid = valid & (torch.rand((B, T, MB * bs), generator=g) > 0.1)
        mask = valid[:, None].to(dev)
    if case == "window":
        window = 100
    if case in ("one_row", "tp2_chunk", "f16_one_row") or case.startswith("chunk_"):
        # the engine's prefill-chunk form: one row (here 1503 tokens, or
        # the chunk's own length)
        q, bt, lengths = q[5:6].contiguous(), bt[5:6], lengths[5:6]
    args = (q, k, v, bt.to(dev), lengths.to(dev))
    kwargs = {"k_scale": k_scale, "v_scale": v_scale, "mask": mask,
              "window": window}
    return args, kwargs


def _paged_cost(args, kwargs):
    """(bytes, flops) the call needs on this data: q and out once, each
    KV slot some query of its row attends once (with its scale), the
    table, lengths and mask once; 4*D flops per attended (query, key)."""
    q, k, v, bt, lengths = args
    B, T, H, D = q.shape
    bs, Hkv = k.shape[1], k.shape[2]
    Lv = bt.shape[1] * bs
    kpos = torch.arange(Lv, device=q.device)[None, None, :]
    qpos = (lengths.long()[:, None] - T + torch.arange(T, device=q.device))[:, :, None]
    keep = kpos <= qpos
    if kwargs["window"] is not None:
        keep &= kpos > qpos - kwargs["window"]
    if kwargs["mask"] is not None:
        keep &= kwargs["mask"][:, 0]
    keys_read = int(keep.any(dim=1).sum())
    pairs = int(keep.sum()) * H
    per_key = 2 * Hkv * D * k.element_size()
    if kwargs["k_scale"] is not None:
        per_key += 2 * Hkv * 4
    nbytes = (2 * q.numel() * q.element_size() + keys_read * per_key
              + bt.numel() * 4 + lengths.numel() * 4
              + (0 if kwargs["mask"] is None else kwargs["mask"].numel()))
    return nbytes, 4 * D * pairs


def _paged_library_fn(args, kwargs):
    """F.scaled_dot_product_attention over the gathered, dequantized,
    GQA-repeated view — a yardstick only; the port never calls it."""
    q, k, v, bt, lengths = args
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    NB = k.shape[0]
    btc = bt.long().clamp(max=NB - 1)
    kk = k[btc].reshape(B, -1, Hkv, D)
    vv = v[btc].reshape(B, -1, Hkv, D)
    if kwargs["k_scale"] is not None:
        kk = kk.float() * kwargs["k_scale"][btc].reshape(B, -1, Hkv, 1)
        vv = vv.float() * kwargs["v_scale"][btc].reshape(B, -1, Hkv, 1)
    kk = kk.to(q.dtype).repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vv = vv.to(q.dtype).repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    Lv = kk.shape[2]
    kpos = torch.arange(Lv, device=q.device)[None, None, None, :]
    qpos = (lengths.long()[:, None] - T + torch.arange(T, device=q.device))[:, None, :, None]
    keep = kpos <= qpos
    if kwargs["window"] is not None:
        keep = keep & (kpos > qpos - kwargs["window"])
    if kwargs["mask"] is not None:
        keep = keep & kwargs["mask"]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=keep)


# (T, case, variant it must launch): the first design's ten cases, the
# decode form over whole pages, the prefill chunk (one row) at three
# lengths, then the variants' other branches: f32 q and pools (general),
# f16 q over f16 pools (decode, with and without the decode steps' mask;
# the prefill chunk), over int8 pools (decode; again with V of absmax
# near 1e-4) and over bf16 pools (general), D 64 with a mask per query
# (prefill), and 4 queries a row
# with a mask per query (decode: T x group = 16 rows); last the speculative verify
# pass at K = 3 and K = 4 (T 4 and 5, no mask), whose variant
# ``kernel_variant`` names (None here): Llama-3-8B's group of 4 gives 16
# and 20 query rows, so decode at T 4 and prefill at T 5; then the decode
# step at one rank's heads under tensor parallelism, model 2 (H 16 /
# Hkv 4, the [tp2 *] legs' shape) and model 8 (H 4 / Hkv 1), and the
# [tp2 paged] leg's prefill chunk (one row, T 128) at model 2's heads
PAGED_CASES = (
    [(T, case, "decode" if T == 1 else "prefill") for T in (1, 128)
     for case in ("mixed", "mask", "window", "int8", "one_row")]
    + [(1, "full_pages", "decode"), (128, "chunk_128", "prefill"),
       (128, "chunk_1024", "prefill"), (128, "chunk_2048", "prefill"),
       (1, "f32", "general"), (1, "f16", "decode"), (1, "f16_mask", "decode"),
       (128, "f16_one_row", "prefill"), (1, "f16_int8", "decode"),
       (1, "f16_int8_small_v", "decode"), (1, "f16_over_bf16", "general"),
       (128, "d64_qmask", "prefill"),
       (4, "qmask", "decode"), (4, "verify", None), (5, "verify", None),
       (1, "tp2_mask", "decode"), (1, "tp8_mask", "decode"),
       (128, "tp2_chunk", "prefill")]
)


def phase_paged(flush) -> dict:
    g = torch.Generator().manual_seed(1)
    worst = worst_rel = 0.0
    main = None
    verify, local, f16 = {}, {}, {}
    for T, case, want in PAGED_CASES:
        args, kwargs = _paged_inputs(g, T, case)
        if want is None:
            q, k = args[0], args[1]
            want = kernel_variant(q.dtype, k.dtype, T, q.shape[2], k.shape[2],
                                  q.shape[3], args[3].shape[1] * k.shape[1],
                                  kwargs["mask"] is not None)
        before = dict(paged_decode_attention.launches_by_variant)
        out = paged_decode_attention(*args, **kwargs)
        variant = [k for k, n in paged_decode_attention.launches_by_variant.items()
                   if n != before[k]]
        ref = paged_decode_reference(*args, **kwargs)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= PAGED_ATOL + PAGED_RTOL * ref.float().abs()).all())
        check(bool(torch.isfinite(out.float()).all()), f"paged {case} T={T}: non-finite")
        mx = float(err.max())
        rel = _rel(out, ref)
        worst, worst_rel = max(worst, mx), max(worst_rel, rel)
        ms, median_ms = time_mean_median(
            lambda: paged_decode_attention(*args, **kwargs), flush)
        plain_ms = time_ms(lambda: paged_decode_reference(*args, **kwargs), flush, iters=5)
        lib_ms, lib_median_ms = time_mean_median(
            _paged_library_fn(args, kwargs), flush, iters=10)
        nbytes, flops = _paged_cost(args, kwargs)
        bound, bound_by = _bound(nbytes, flops)
        row = {
            "T": T, "case": case, "variant": variant, "max_abs_err": mx,
            "rel_frobenius": rel, "ms": ms, "median_ms": median_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_median_ms": lib_median_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "frac_of_bound": bound / ms, "bytes": nbytes, "flops": flops,
        }
        say(f"[paged] {json.dumps(row)}")
        check(ok, f"paged {case} T={T}: max abs err {mx} beyond "
              f"atol {PAGED_ATOL} + rtol {PAGED_RTOL}")
        check(rel <= PAGED_REL, f"paged {case} T={T}: relative Frobenius "
              f"error {rel} beyond {PAGED_REL}")
        check(variant == [want], f"paged {case} T={T}: ran {variant}, not {want}")
        if T == 1 and case == "mask":
            main = row  # the decode steps' form
        if case == "verify":
            verify[T] = row
        if case.startswith("tp"):
            local[case] = row
        if case.startswith("f16"):
            f16[case] = row
    main = dict(main, max_abs_err=worst, verify=verify, local_heads=local, f16=f16)
    say(f"[paged] all cases within atol {PAGED_ATOL} + rtol {PAGED_RTOL} and "
        f"relative Frobenius error {PAGED_REL}; worst max abs err {worst}, "
        f"worst relative {worst_rel}")
    return main


# (kind, bias, rows, D, dtype, mean offset): the decode step's two forms
# at Llama-3-8B's width, then LayerNorm of f32 rows whose mean (2e3) dwarfs
# their spread (~1.4), where a one-pass variance cancels; D 4100 (8-byte
# vectors) and 4097 (scalar), which the 16-byte vector does not divide; 64
# rows x 5120; rows of 32768 f32, which a cluster of 4 blocks splits; and
# GPT-2-medium's decode step, 8 slots x 1024 with LayerNorm + bias
NORM_CASES = (
    ("rms", False, 8, 4096, torch.bfloat16, 0.0),
    ("layer", True, 8, 4096, torch.bfloat16, 0.0),
    ("layer", True, 8, 4096, torch.float32, 1e3),
    ("layer", True, 8, 4100, torch.bfloat16, 0.0),
    ("rms", False, 8, 4097, torch.bfloat16, 0.0),
    ("rms", False, 64, 5120, torch.bfloat16, 0.0),
    ("layer", True, 4, 32768, torch.float32, 0.0),
    ("layer", True, 8, 1024, torch.bfloat16, 0.0),
)


def phase_norm(flush, floor_ms: float) -> dict:
    g = torch.Generator().manual_seed(2)
    main = None
    worst = 0.0
    for kind, with_bias, rows, D, dt, offset in NORM_CASES:
        x = (torch.randn((rows, D), generator=g) + offset).to(DEV, dt)
        res = (torch.randn((rows, D), generator=g) + offset).to(DEV, dt)
        scale = (1 + 0.1 * torch.randn(D, generator=g)).to(DEV)
        bias = (0.1 * torch.randn(D, generator=g)).to(DEV) if with_bias else None
        kw = {"eps": 1e-5, "kind": kind}
        r, y = fused_residual_norm(x, res, scale, bias, **kw)
        r0, y0 = fused_residual_norm_reference(x, res, scale, bias, **kw)
        torch.cuda.synchronize()
        errs = []
        for a, b in ((r, r0), (y, y0)):
            e = (a.float() - b.float()).abs()
            check(bool((e <= NORM_ATOL + NORM_RTOL * b.float().abs()).all()),
                  f"fused norm {kind} {rows}x{D} {dt}: err {float(e.max())} "
                  f"beyond tolerance")
            errs.append(float(e.max()))
        mx = max(errs)
        worst = max(worst, mx)
        call = lambda: fused_residual_norm(x, res, scale, bias, **kw)  # noqa: E731
        sc, bs = scale.to(dt), None if bias is None else bias.to(dt)
        if kind == "rms":
            two = lambda: F.rms_norm(torch.add(x, res), (D,), sc, 1e-5)  # noqa: E731
        else:
            two = lambda: F.layer_norm(torch.add(x, res), (D,), sc, bs, 1e-5)  # noqa: E731
        el = x.element_size()
        nbytes = 4 * rows * D * el + D * 4 * (2 if with_bias else 1)
        b_ms, bound_by = _bound(nbytes, rows * D * 8, F32_FLOPS)
        row = {"kind": kind, "bias": with_bias, "rows": rows, "D": D,
               "dtype": str(dt).replace("torch.", ""), "mean_offset": offset,
               "geometry": dict(zip(("C", "threads", "vec", "nv"),
                                    launch_geometry(D, el, 4))),
               "max_abs_err": mx, **_timed("", call, flush),
               "plain_ms": time_ms(lambda: fused_residual_norm_reference(
                   x, res, scale, bias, **kw), flush),
               "library_ms": None, "two_call_ms": time_ms(two, flush),
               "bound_ms": b_ms, "bound_by": bound_by, "floor_ms": floor_ms,
               "host_us": host_us(call)}
        say(f"[norm] {json.dumps(row)}")
        if main is None:
            main = row  # Llama's decode form
    return dict(main, max_abs_err=worst)


# The first designs: B1's (mma.sync, synchronous loads, one 64-row tile)
# and B2's (two S/dP passes in the dq kernel, synchronous loads, 32-row
# dkv tiles), the mean of 20 launches on NVIDIA H100 80GB HBM3, 700.00 W,
# as this script measured them in other runs (PERF.md, kernel table),
# printed beside the current mean; tools/kernel_ab.py times both designs
# in one run
B1_FIRST_DESIGN_MS = {"bert": 0.0678, "llama": 0.276, "window": 0.0547}
B2_FIRST_DESIGN_MS = {"bert": 0.277, "llama": 1.78, "window": 0.259}

# name: (B, H, Hkv, T, D, causal, window, mask)
FLASH_CASES = {
    # BERT-base's training shape: rows of 512, 480, 300, 129 valid keys,
    # the rest all valid
    "bert": (8, 12, 12, 512, 64, False, None, "bert"),
    # Llama-3-8B's no-cache forward
    "llama": (1, 32, 8, 2048, 128, True, None, None),
    "window": (1, 32, 8, 1024, 128, True, 256, None),
    # a length no tile divides, with a fully masked row
    "ragged": (2, 12, 12, 300, 64, False, None, "ragged"),
    # GPT-2-medium's training micro-batch in [sharded gpt2] (causal, D 64)
    "gpt2": (2, 16, 16, 1024, 64, True, None, None),
}


# [flash f32]: B1 and B2 in their f32 forms (csrc/flash_attention_f32.cu)
# at BERT-base's and Llama-3-8B's shapes; errors relative to max |plain|
FLASH_F32_CASES = ("bert", "llama")
FLASH_F32_O_REL = 1e-4
FLASH_F32_GRAD_REL = 1e-3
# and their f16 forms against the plain version fed the same f16 tensors:
# both compute in f32 and round each output to f16 once, and one f16
# rounding is 2^-11 ~ 4.9e-4 of the value
FLASH_F16_O_REL = 1e-3
FLASH_F16_GRAD_REL = 5e-3
# each form's (o, gradient) tolerance: bf16 relative Frobenius, f32 and
# f16 relative to max |plain|
FLASH_TOLS = {"bf16": (FLASH_O_REL, FLASH_GRAD_REL),
              "f32": (FLASH_F32_O_REL, FLASH_F32_GRAD_REL),
              "f16": (FLASH_F16_O_REL, FLASH_F16_GRAD_REL)}
# [flash f32]'s f16 B2 rows again with dO scaled down (an f16 model's small
# gradients): the kernels scale dS against f16's underflow
F16_DO_SCALES = (2.0 ** -16, 2.0 ** -24)
F16_STEP = 2.0 ** -24  # f16's least step: its spacing below 2^-14
# [flash d]: head dims other than 64 and 128: 96 and 80 (zero-padded to
# 128 by the wrappers), 256 (built for: Gemma-7B's heads, 16 x 256, at a
# causal 2048) and 160 (zero-padded to 256, GQA 4 with a ragged mask);
# name -> (B, H, Hkv, T, D, causal, window, mask)
FLASH_D_CASES = {
    "d96": (2, 8, 8, 512, 96, True, None, None),
    "d80": (2, 12, 4, 300, 80, False, None, "ragged"),
    "d256": (1, 16, 16, 2048, 256, True, None, None),
    "d160": (2, 8, 2, 384, 160, False, None, "ragged"),
}


def _flash_inputs(g, B, H, Hkv, T, D, mask, dtype=torch.bfloat16):
    def rnd(*shape):
        return torch.randn(shape, generator=g).to(DEV, dtype)

    # [B, T, heads, D] storage read as [B, heads, T, D] views: the layout
    # the training path hands the kernels
    q, k, v, do = (rnd(B, T, h, D).transpose(1, 2) for h in (H, Hkv, Hkv, H))
    kv = None
    if mask == "bert":
        lens = torch.tensor([512, 480, 300, 129] + [T] * (B - 4))
        kv = (torch.arange(T)[None] < lens[:, None]).to(DEV)
    elif mask == "ragged":
        kv = torch.rand((B, T), generator=g) > 0.3
        kv[1] = False
        kv = kv.to(DEV)
    return q, k, v, do, kv


def _flash_keep(B, T, kv, causal, window):
    """[B, T, T] attended (query, key) pairs of one head."""
    qp = torch.arange(T, device=DEV)[:, None]
    kp = torch.arange(T, device=DEV)[None, :]
    keep = torch.ones((T, T), dtype=torch.bool, device=DEV)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
        if not causal:
            keep &= kp < qp + window
    keep = keep[None].expand(B, T, T)
    if kv is not None:
        keep = keep & kv[:, None, :]
    return keep


def _sdpa_fn(q, k, v, do, keep, is_causal: bool, grad: bool):
    """One F.scaled_dot_product_attention call (forward, or forward and
    backward) on the same inputs, with GQA pre-repeated and the boolean
    keep mask — a yardstick only; the port never calls it. The first
    backend (flash, cuDNN, memory-efficient, math) that accepts the call
    is the one timed. -> (fn, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H = q.shape[1]
    rep = H // k.shape[1]
    qq = q.contiguous().requires_grad_(grad)
    kk = k.repeat_interleave(rep, dim=1).contiguous().requires_grad_(grad)
    vv = v.repeat_interleave(rep, dim=1).contiguous().requires_grad_(grad)
    gg = do.contiguous()
    kw = ({"is_causal": True} if is_causal
          else {"attn_mask": keep[:, None].contiguous()})

    def call():
        out = F.scaled_dot_product_attention(qq, kk, vv, **kw)
        if grad:
            torch.autograd.grad(out, (qq, kk, vv), gg)

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel([be]):
                call()
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, be.name
    raise RuntimeError("no SDPA backend accepted the call")


def _bound(nbytes, flops, peak=BF16_FLOPS):
    """(least ms for these bytes and operations, which of the two binds)."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / peak * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


FLASH_FORMS = {"bf16": 2, "f16": 2, "f32": 4}  # B1/B2's forms: bytes an element


def _flash_bounds(form: str, B, H, Hkv, T, D, kv, causal, window) -> dict:
    """The bounds of one B1 call ("fwd") and one B2 call ("bwd") in
    ``form`` at this shape. Bytes: each input read once and each output
    written once (forward q, k, v and the mask in, o and f32 lse out;
    backward q, k, v, do, lse and the mask in, dq, dk, dv out).
    Operations: the function's products over the attended pairs, 4 D a
    pair forward (S, P V) and 10 D backward (S, dP, dQ, dK, dV), at the
    card's peak for the operands: bf16 and f16 at the dense 16-bit
    tensor-core rate, f32 at the 3xTF32 rate (three TF32 products a
    product). The f32 form also carries ``bound_ms_tf32`` (the TF32
    products it runs, ``_tf32_passes``, at TF32_FLOPS: the design's own
    ceiling, not the function's) and ``bound_ms_vector`` (the operations
    at the f32 vector peak, the FFMA design's bound).
    -> {"pairs", "fwd": {...}, "bwd": {...}}."""
    pairs = int(_flash_keep(B, T, kv, causal, window).sum()) * H
    el = FLASH_FORMS[form]
    qo, kv_b = B * T * H * D * el, B * T * Hkv * D * el
    m_b = 0 if kv is None else B * T
    out = {"pairs": pairs}
    for p, nbytes, ops in (("fwd", 2 * qo + 2 * kv_b + m_b + B * H * T * 4, 4 * D * pairs),
                           ("bwd", 3 * qo + 4 * kv_b + m_b + B * H * T * 4, 10 * D * pairs)):
        b, by = (_bound(nbytes, 3 * ops, TF32_FLOPS) if form == "f32"
                 else _bound(nbytes, ops, BF16_FLOPS))
        row = {"bound_ms": b, "bound_by": by, "bytes": nbytes, "flops": ops}
        if form == "f32":
            passes = _tf32_passes(p == "fwd")
            row.update(bound_ms_tf32=_bound(nbytes, 2 * D * pairs * passes, TF32_FLOPS)[0],
                       bound_ms_vector=_bound(nbytes, ops, F32_FLOPS)[0], tf32_passes=passes)
        out[p] = row
    return out


def _timed(prefix: str, fn, flush, iters: int = 20) -> dict:
    """{prefix + "ms": mean, prefix + "median_ms": median} of ``fn``."""
    mean, median = time_mean_median(fn, flush, iters)
    return {f"{prefix}ms": mean, f"{prefix}median_ms": median}


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _rel_max(a, b) -> float:
    """The worst error of a against b, relative to max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _f16_grad_ok(a, b, tol: float = FLASH_F16_GRAD_REL) -> dict:
    """One f16 gradient ``a`` against the plain version's ``b`` from the
    same f16 inputs: its worst error relative to max |b|, the same in
    units of f16's least step, and whether it is within ``tol`` x max |b|
    plus one least step. A dO scaled down by 2^-16 or 2^-24 puts the
    gradients below f16's normal range, where both versions round their
    f32 sums to steps of 2^-24, a few to tens of steps per max |b|: the
    two roundings of sums that agree to 1e-4 still part by one step, which
    no kernel can avoid, so the step is allowed beside the relative gate
    (a kernel whose dS underflowed would be off by max |b| itself)."""
    a, b = a.float(), b.float()
    err, top = float((a - b).abs().max()), float(b.abs().max())
    return {"rel_to_max": err / max(top, 1e-30), "steps": err / F16_STEP,
            "max_steps": top / F16_STEP, "ok": err <= tol * top + F16_STEP}


def phase_flash(flush) -> dict:
    """B1 and B2 against their plain versions on the card, in bf16, at the
    paths' shapes; each timed beside its plain version, its bound and
    SDPA. Returns the BERT case's rows (the training path's shape), with
    the worst errors over every case."""
    g = torch.Generator().manual_seed(5)
    rows = {}
    worst_f = worst_b = worst_rel_o = 0.0
    for name, (B, H, Hkv, T, D, causal, window, mask) in FLASH_CASES.items():
        q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, T, D, mask)
        kw = {"causal": causal, "window": window}
        o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
        ro, rlse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
        grads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw)
        rgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *grads)),
              f"flash {name}: non-finite output")
        e_o = (o.float() - ro.float()).abs()
        o_ok = bool((e_o <= FLASH_O_ATOL + FLASH_O_RTOL * ro.float().abs()).all())
        rel_o = _rel(o, ro)
        e_lse = float((lse - rlse).abs().max())
        rel = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)}
        e_g = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(grads, rgrads))

        keep = _flash_keep(B, T, kv, causal, window)
        bounds = _flash_bounds("bf16", B, H, Hkv, T, D, kv, causal, window)
        is_causal = causal and window is None and kv is None
        lib_f, be_f = _sdpa_fn(q, k, v, do, keep, is_causal, grad=False)
        lib_b, be_b = _sdpa_fn(q, k, v, do, keep, is_causal, grad=True)
        row = {
            "case": name, "B": B, "H": H, "Hkv": Hkv, "T": T, "D": D,
            "causal": causal, "window": window, "mask": mask,
            "pairs": bounds["pairs"],
            "fwd": {
                "max_abs_err": float(e_o.max()), "rel_frobenius": rel_o,
                "lse_max_abs_err": e_lse,
                **_timed("", lambda: flash_attention_fwd_lse(q, k, v, kv, **kw), flush),
                "host_us": host_us(lambda: flash_attention_fwd_lse(q, k, v, kv, **kw)),
                "first_design_mean_ms": B1_FIRST_DESIGN_MS.get(name),
                "plain_ms": time_ms(lambda: flash_attention_fwd_lse_reference(
                    q, k, v, kv, **kw), flush, iters=5),
                **_timed("library_", lib_f, flush, iters=10), "library": be_f,
                **bounds["fwd"],
            },
            "bwd": {
                "max_abs_err": e_g, "rel_frobenius": rel,
                **_timed("", lambda: flash_attention_bwd(
                    q, k, v, ro, rlse, do, kv, **kw), flush),
                "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                    q, k, v, ro, rlse, do, kv, **kw), flush, iters=5),
                "first_design_mean_ms": B2_FIRST_DESIGN_MS.get(name),
                **_timed("library_", lib_b, flush, iters=10),
                "library": f"{be_b} forward+backward",
                **bounds["bwd"],
            },
        }
        say(f"[flash] {json.dumps(row)}")
        check(o_ok, f"flash {name}: o beyond atol {FLASH_O_ATOL} + rtol {FLASH_O_RTOL}")
        check(rel_o <= FLASH_O_REL, f"flash {name}: o relative Frobenius "
              f"error {rel_o} beyond {FLASH_O_REL}")
        check(e_lse <= FLASH_LSE_ATOL, f"flash {name}: lse err {e_lse}")
        check(max(rel.values()) <= FLASH_GRAD_REL,
              f"flash {name}: gradient relative error {rel}")
        worst_f = max(worst_f, float(e_o.max()))
        worst_rel_o = max(worst_rel_o, rel_o)
        worst_b = max(worst_b, e_g)
        rows[name] = row
        del q, k, v, do, o, ro, grads, rgrads, lib_f, lib_b
    say(f"[flash] all cases within tolerance; worst max abs err: o {worst_f}, "
        f"gradients {worst_b}; worst o relative Frobenius {worst_rel_o}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    _flash_head_dims(g, flush)
    tc = _flash_f32(g, flush)
    out = {
        "fwd": dict({k: rows["bert"]["fwd"][k] for k in keys}, max_abs_err=worst_f),
        "bwd": dict({k: rows["bert"]["bwd"][k] for k in keys}, max_abs_err=worst_b),
    }
    for form in ("f32", "f16"):
        for p in ("fwd", "bwd"):
            out[f"{p}_{form}"] = dict(
                {k: tc[form, "bert"][p][k] for k in keys},
                max_abs_err=max(r[p]["max_abs_err"] for (f, _), r in tc.items() if f == form))
    return out


def _tf32_passes(fwd: bool) -> int:
    """TF32 products the f32 kernels run for one attended pair's
    products, in units of a D-long dot: 3 a product (the 3xTF32 split).
    Forward: S, P V; backward: S, dP, dQ, dK, dV (the recomputations of S
    and dP not counted)."""
    return 3 * (2 if fwd else 5)


def _flash_d_times(form, dtype, case, flush, g) -> dict:
    """The times of a [flash d] row whose D is above 128: B1 and B2 at the
    case's shape (mean and median ms of 10 launches after an L2 flush),
    their plain versions, the kernels at the same shape with D 128 (fresh
    inputs), one F.scaled_dot_product_attention call at the case's D and
    dtype (forward, and forward with backward; the first backend that
    takes it) and the bounds at the true D (``_flash_bounds``)."""
    B, H, Hkv, T, D, causal, window, mask = case
    kw = {"causal": causal, "window": window}
    out = {}
    for tag, d in (("", D), ("d128_", 128)):
        q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, T, d, mask, dtype)
        o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
        out.update(_timed(f"{tag}fwd_", lambda: flash_attention_fwd_lse(
            q, k, v, kv, **kw), flush, iters=10))
        out.update(_timed(f"{tag}bwd_", lambda: flash_attention_bwd(
            q, k, v, o, lse, do, kv, **kw), flush, iters=10))
        if tag:
            continue
        out["fwd_plain_ms"] = time_ms(lambda: flash_attention_fwd_lse_reference(
            q, k, v, kv, **kw), flush, iters=3)
        out["bwd_plain_ms"] = time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, kv, **kw), flush, iters=3)
        keep = _flash_keep(B, T, kv, causal, window)
        is_causal = causal and window is None and kv is None
        lib_f, be_f = _sdpa_fn(q, k, v, do, keep, is_causal, grad=False)
        lib_b, be_b = _sdpa_fn(q, k, v, do, keep, is_causal, grad=True)
        out.update(_timed("fwd_library_", lib_f, flush, iters=10),
                   fwd_library=be_f)
        out.update(_timed("bwd_library_", lib_b, flush, iters=10),
                   bwd_library=f"{be_b} forward+backward")
        bounds = _flash_bounds(form, B, H, Hkv, T, D, kv, causal, window)
        out.update(fwd_bound_ms=bounds["fwd"]["bound_ms"],
                   fwd_bound_by=bounds["fwd"]["bound_by"],
                   bwd_bound_ms=bounds["bwd"]["bound_ms"],
                   bwd_bound_by=bounds["bwd"]["bound_by"])
        del keep, lib_f, lib_b
    return out


def _flash_head_dims(g, flush) -> None:
    """[flash d]: B1, B2 and B2's delta form at FLASH_D_CASES' head dims
    (D 256 as built; any other zero-padded by the wrappers to the next of
    128 and 256 and run at the true D's scale) in bf16, f32 and f16,
    against the plain versions fed the same tensors at each form's
    tolerances (``FLASH_TOLS``); each output D wide. A row whose D is
    above 128 also carries its times (``_flash_d_times``)."""
    for form, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                        ("f16", torch.float16)):
        o_tol, g_tol = FLASH_TOLS[form]
        err = _rel if form == "bf16" else _rel_max
        for name, (B, H, Hkv, T, D, causal, window, mask) in FLASH_D_CASES.items():
            q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, T, D, mask, dtype)
            kw = {"causal": causal, "window": window}
            o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
            ro, rlse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
            delta = (do.float() * ro.float()).sum(dim=-1)
            grads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw)
            rgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv, **kw)
            dgrads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, delta=delta, **kw)
            rdgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv,
                                                    delta=delta, **kw)
            torch.cuda.synchronize()
            live = rlse < 1e29
            row = {"case": name, "form": form, "B": B, "H": H, "Hkv": Hkv, "T": T,
                   "D": D, "o": err(o, ro),
                   "lse": float((lse - rlse)[live].abs().max()) if bool(live.any()) else 0.0,
                   **{n: err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)},
                   **{f"delta_{n}": err(a, b)
                      for n, a, b in zip(("dq", "dk", "dv"), dgrads, rdgrads)}}
            kept = all(x.shape[-1] == D and x.dtype == dtype for x in (o, *grads, *dgrads))
            del q, k, v, do, o, ro, grads, rgrads, dgrads, rdgrads
            if D > 128:
                row.update(_flash_d_times(form, dtype, FLASH_D_CASES[name], flush, g))
            say(f"[flash d] {json.dumps(row)}")
            check(kept, f"flash d {form} {name}: outputs not {dtype} of head dim {D}")
            check(row["o"] <= o_tol and row["lse"] <= FLASH_LSE_ATOL,
                  f"flash d {form} {name}: o / lse beyond {o_tol} / {FLASH_LSE_ATOL}: {row}")
            check(max(row[n] for n in ("dq", "dk", "dv", "delta_dq", "delta_dk", "delta_dv"))
                  <= g_tol, f"flash d {form} {name}: gradients beyond {g_tol}: {row}")


def _flash_f32(g, flush) -> dict:
    """[flash f32]: B1 and B2 in their f32 form
    (csrc/flash_attention_f32.cu) and their f16 form (csrc/flash_attention.cu)
    against the plain versions fed the same tensors at FLASH_F32_CASES'
    shapes (the worst error relative to max |plain|: FLASH_F32_O_REL /
    FLASH_F32_GRAD_REL in f32, FLASH_F16_O_REL / FLASH_F16_GRAD_REL in
    f16, and in f16 B2 again at each of F16_DO_SCALES, ``_f16_grad_ok``),
    each timed beside its plain version, one F.scaled_dot_product_attention
    call in the same dtype (the first backend that takes it) and its
    bounds (``_flash_bounds``, with the fraction of the bound reached).
    -> rows by (form, case)."""
    rows = {}
    for form, dtype, o_tol, g_tol in (
            ("f32", torch.float32, FLASH_F32_O_REL, FLASH_F32_GRAD_REL),
            ("f16", torch.float16, FLASH_F16_O_REL, FLASH_F16_GRAD_REL)):
        for name in FLASH_F32_CASES:
            B, H, Hkv, T, D, causal, window, mask = FLASH_CASES[name]
            q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, T, D, mask, dtype)
            kw = {"causal": causal, "window": window}
            o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
            ro, rlse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
            grads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw)
            rgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv, **kw)
            torch.cuda.synchronize()
            check(all(x.dtype == dtype for x in (o, *grads)),
                  f"flash {form} {name}: outputs not {dtype}")
            check(all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *grads)),
                  f"flash {form} {name}: non-finite output")

            rel_o = _rel_max(o, ro)
            scaled = {}
            if form == "f16":
                for sc in F16_DO_SCALES:
                    dos = (do.float() * sc).to(dtype)
                    sg = flash_attention_bwd(q, k, v, ro, rlse, dos, kv, **kw)
                    rsg = flash_attention_bwd_reference(q, k, v, ro, rlse, dos, kv, **kw)
                    scaled[f"{sc:g}"] = {n: _f16_grad_ok(a, b) for n, a, b in
                                         zip(("dq", "dk", "dv"), sg, rsg)}
                    del dos, sg, rsg
            live = rlse < 1e29
            e_lse = float((lse - rlse)[live].abs().max()) if bool(live.any()) else 0.0
            rel_g = {n: _rel_max(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)}
            keep = _flash_keep(B, T, kv, causal, window)
            bounds = _flash_bounds(form, B, H, Hkv, T, D, kv, causal, window)
            is_causal = causal and window is None and kv is None
            lib_f, be_f = _sdpa_fn(q, k, v, do, keep, is_causal, grad=False)
            lib_b, be_b = _sdpa_fn(q, k, v, do, keep, is_causal, grad=True)
            row = {
                "case": name, "dtype": str(dtype).split(".")[1], "B": B, "H": H,
                "Hkv": Hkv, "T": T, "D": D, "causal": causal, "mask": mask,
                "pairs": bounds["pairs"],
                "fwd": {"max_abs_err": float((o.float() - ro.float()).abs().max()),
                        "rel_to_max": rel_o, "lse_max_abs_err": e_lse,
                        **_timed("", lambda: flash_attention_fwd_lse(q, k, v, kv, **kw), flush),
                        "plain_ms": time_ms(lambda: flash_attention_fwd_lse_reference(
                            q, k, v, kv, **kw), flush, iters=5),
                        **_timed("library_", lib_f, flush, iters=10), "library": be_f,
                        **bounds["fwd"]},
                "bwd": {"max_abs_err": max(float((a.float() - b.float()).abs().max())
                                           for a, b in zip(grads, rgrads)),
                        "rel_to_max": rel_g,
                        **_timed("", lambda: flash_attention_bwd(
                            q, k, v, ro, rlse, do, kv, **kw), flush),
                        "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                            q, k, v, ro, rlse, do, kv, **kw), flush, iters=5),
                        **_timed("library_", lib_b, flush, iters=10),
                        "library": f"{be_b} forward+backward",
                        **bounds["bwd"], "do_scaled": scaled},
            }
            for p in ("fwd", "bwd"):
                row[p]["frac"] = row[p]["bound_ms"] / row[p]["ms"]
            say(f"[flash f32] {json.dumps(row)}")
            check(rel_o <= o_tol,
                  f"flash {form} {name}: o error {rel_o} of max |plain| > {o_tol}")
            check(e_lse <= FLASH_LSE_ATOL, f"flash {form} {name}: lse err {e_lse}")
            check(max(rel_g.values()) <= g_tol,
                  f"flash {form} {name}: gradient errors {rel_g} of max |plain| > {g_tol}")
            check(all(r["ok"] for by in scaled.values() for r in by.values()),
                  f"flash {form} {name}: B2 with dO scaled down beyond {g_tol} of max "
                  f"|plain| and one f16 step: {scaled}")
            rows[form, name] = row
            del q, k, v, do, o, ro, grads, rgrads, lib_f, lib_b
    return rows


def phase_sp_kernel(flush) -> dict:
    """B2's delta form at [sp attention]'s block shapes: one rank's T/2
    queries against a block of T/2 keys behind them (no band), the
    ``delta`` the ring passes, against the plain version given the same
    delta ([flash]'s gradient tolerance), timed beside the own-delta
    form on the same inputs, its bound (reads q, k, v, do, lse and delta
    once, writes dq, dk, dv once; 10 D operations an attended pair) and
    the library's yardstick: flash SDPA's forward and backward at the
    whole sequence (the work the ring's blocks add up to). Returns the
    Llama row's numbers, with the worst error over both cases."""
    g = torch.Generator().manual_seed(11)
    rows, worst = {}, 0.0
    for name, (B, H, Hkv, T, D, causal, mask) in SP_CASES.items():
        Tl = T // SP_WORLD
        q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, Tl, D, mask)
        o, lse = flash_attention_fwd_lse_reference(q, k, v, kv)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = flash_attention_bwd(q, k, v, o, lse, do, kv, delta=delta)
        ref = flash_attention_bwd_reference(q, k, v, o, lse, do, kv, delta=delta)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        rel = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        keep = _flash_keep(B, Tl, kv, False, None)
        pairs = int(keep.sum()) * H
        el = q.element_size()
        qo, kv_b = B * Tl * H * D * el, B * Tl * Hkv * D * el
        nbytes = 3 * qo + 4 * kv_b + (0 if kv is None else B * Tl) + 2 * B * H * Tl * 4
        bound, by = _bound(nbytes, 10 * D * pairs)
        qw, kw_, vw, dow, kvw = _flash_inputs(g, B, H, Hkv, T, D, mask)
        lib, be = _sdpa_fn(qw, kw_, vw, dow, _flash_keep(B, T, kvw, causal, None),
                           causal and kvw is None, grad=True)
        row = {
            "case": name, "block": [B, H, Hkv, Tl, D], "whole_T": T,
            "max_abs_err": err, "rel_frobenius": rel,
            **_timed("", lambda: flash_attention_bwd(q, k, v, o, lse, do, kv,
                                                     delta=delta), flush),
            **_timed("own_delta_", lambda: flash_attention_bwd(q, k, v, o, lse, do, kv),
                     flush),
            "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, kv, delta=delta), flush, iters=5),
            **_timed("library_", lib, flush, iters=10),
            "library": f"{be} forward+backward at the whole sequence",
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": 10 * D * pairs,
        }
        say(f"[sp kernel] {json.dumps(row)}")
        check(max(rel.values()) <= FLASH_GRAD_REL,
              f"sp kernel {name}: B2's delta form against its plain version {rel}")
        worst = max(worst, err)
        rows[name] = row
        del q, k, v, do, o, got, ref, qw, kw_, vw, dow, lib
    _free_cuda()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict({k: rows["llama"][k] for k in keys}, max_abs_err=worst)


def _teacher_forced(tag: str, model, prompts, outs, first: int = 8) -> dict:
    """Teacher-forced check of every emitted token: the port's no-cache
    forward over prompt plus output must rank each emitted token within
    LOGIT_GAP_TOL of its row's maximum. Each sequence is padded at its
    end to a multiple of 128, so the reference's routing rule (_tile_ok
    lengths, T >= 512) sends the long ones to B1 (with the model's window,
    if it has one); causal attention keeps the pad out of the checked
    rows. Fails the run on a wider gap, or unless B1 ran once a layer for
    each sequence of >= 512. Also returns the worst gap over the first
    decode chunk (tokens 1 .. ``first``: token 0 is the prefill's)."""
    gaps, exact, n_flash, head = [], 0, 0, []
    flash_attention_fwd_lse.launches = 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = np.concatenate([p, o[:-1]])
            n = len(ids)
            ids = np.concatenate([ids, np.zeros(-n % 128, ids.dtype)])
            n_flash += len(ids) >= 512
            hidden = model(torch.from_numpy(ids).to(DEV)[None], logits=False)
            logits = model.head(hidden[0, len(p) - 1:n]).float()
            check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
            tok = torch.from_numpy(np.asarray(o)).to(DEV)
            gap = logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]
            gaps.append(float(gap.max()))
            head.append(float(gap[1:1 + first].max()) if len(o) > 1 else 0.0)
            exact += int((gap == 0).sum())
    n_tok = sum(len(o) for o in outs)
    k_flash = flash_attention_fwd_lse.launches
    L = len(model.blocks.blocks())
    say(f"[{tag}] teacher-forced: worst logit gap {max(gaps):.4f} "
        f"(tolerance {LOGIT_GAP_TOL}; first decode chunk {max(head):.4f}); "
        f"{exact}/{n_tok} tokens are the exact argmax; "
        f"flash_attention_fwd_lse launches {k_flash} (expected "
        f"{n_flash} sequences of >= 512 x {L} layers)")
    check(max(gaps) <= LOGIT_GAP_TOL, f"{tag}: teacher-forced check failed")
    check(k_flash == n_flash * L and k_flash > 0,
          f"{tag}: no-cache forward: flash launch count off the path")
    return {"worst_gap": max(gaps), "first_chunk_gap": max(head),
            "exact": exact, "tokens": n_tok, "sequences_ge_512": n_flash}


def _agreement(tag: str, captured, eager, tf_c: dict, tf_e: dict) -> None:
    """Print (not gate: on random bf16 weights greedy tokens part where
    logit gaps are hundredths) the share of tokens the eager run emits
    equal to the captured run's, and each run's worst teacher-forced gap
    over the first decode chunk."""
    same = sum(int((np.asarray(a) == np.asarray(b)).sum())
               for a, b in zip(captured, eager))
    total = sum(len(a) for a in captured)
    res = {"tokens_equal": same, "tokens": total, "share": same / total,
           "first_chunk_gap_captured": tf_c["first_chunk_gap"],
           "first_chunk_gap_eager": tf_e["first_chunk_gap"]}
    say(f"[{tag} eager vs captured] {json.dumps(res)}")


def _graph_line(tag: str, st: dict) -> None:
    say(f"[{tag} graphs] {json.dumps(st)}")


def _requests(vocab: int):
    """12 prompts, 1..1500 tokens across chunk (128) and block (16)
    edges; six share a 256-token prefix (requests 0, 1 and 8..11, so the
    late ones find it resident)."""
    r = np.random.default_rng(3)
    lengths = [300, 513, 15, 129, 127, 1, 1023, 777, 1500, 260, 1100, 640]
    shared = {0, 1, 8, 9, 10, 11}
    prefix = r.integers(0, vocab, (256,))
    out = []
    for i, n in enumerate(lengths):
        if i in shared:
            p = np.concatenate([prefix, r.integers(0, vocab, (n - 256,))])
        else:
            p = r.integers(0, vocab, (n,))
        out.append(p)
    return out


def _slice_engine(model: Llama, max_new: int, cuda_graphs: bool = True,
                  capability: dict | None = None, eng: InferenceEngine | None = None,
                  node: Node | None = None, **kw):
    """A paged engine of the [slice] geometry (its own pools and graphs)
    over ``eng``, or a fresh ``InferenceEngine`` of ``model``; built by
    ``node._build_serving`` (the node's metrics, flight recorder and
    tracer attached) when a node is given."""
    if eng is None:
        eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV)
    kw = dict(slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
              gen=GenerationConfig(max_new_tokens=max_new), cuda_graphs=cuda_graphs,
              capability=capability, **kw)
    if node is not None:
        return node._build_serving(eng, paged=True, **kw)
    return PagedContinuousBatchingEngine(eng, **kw)


def _serve_paged(model: Llama, prompts, max_new: int, cuda_graphs: bool,
                 capability: dict | None = None, eng: InferenceEngine | None = None,
                 tag: str = "slice", name: str = "Llama-3-8B",
                 node: Node | None = None):
    """The 12 requests through a fresh paged engine (over ``eng`` when
    given; built by ``node`` when given); launch counts set to 0 just
    before and read just after, then checked against the path. ->
    (engine, request ids, outputs, wall s, counts)."""
    cfg = model.cfg
    t0 = time.perf_counter()
    sch = _slice_engine(model, max_new, cuda_graphs, capability, eng=eng, node=node)
    torch.cuda.synchronize()
    mode = "captured" if cuda_graphs else "eager"
    say(f"[{tag}] {name} {cfg.num_layers} layers dim {cfg.dim} "
        f"vocab {cfg.vocab_size}, {mode} decode, pipeline depth "
        f"{sch.pipeline_depth}: engine ready in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    _zero_counts()
    t_run = time.perf_counter()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    k1, k2 = paged_decode_attention.launches, fused_residual_norm.launches
    by_variant = dict(paged_decode_attention.launches_by_variant)
    outs = [sch.result(rid) for rid in rids]
    st = sch.stats()
    check(all(len(o) == max_new for o in outs), f"{tag}: a request did not finish")
    _check_paged_launches(f"{tag} {mode}", st, k1, k2, by_variant, cfg.num_layers)
    check(st["prefix_matched_tokens"] > 0, f"{tag}: no prefix was shared")
    if cuda_graphs:
        g = st["graphs"]
        check(g["captured"] == 1 and g["replays"] == st["decode_steps"] // 8 - 1,
              f"{tag}: every decode chunk but the first must be a replay: {g}")
    return sch, rids, outs, wall, {"paged": k1, "norm": k2}


def _check_paged_launches(tag: str, st: dict, k1: int, k2: int, by_variant: dict,
                          L: int) -> None:
    """A non-speculative paged run: B3 once a layer a decode step (decode
    variant) and a prefill chunk (prefill variant), none on the general
    one; B4 once a layer a decode step."""
    exp1 = L * (st["decode_steps"] + st["prefill_chunks"])
    exp2 = L * st["decode_steps"]
    exp_var = {"general": 0, "decode": L * st["decode_steps"],
               "prefill": L * st["prefill_chunks"]}
    say(f"[{tag}] launches: paged_decode {k1} (expected {exp1}; by "
        f"variant {by_variant}, expected {exp_var}), "
        f"fused_norm {k2} (expected {exp2}); decode steps "
        f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}")
    check(k1 == exp1 and k1 > 0, f"{tag}: paged-decode launch count off the path")
    check(by_variant == exp_var and min(by_variant["decode"], by_variant["prefill"]) > 0,
          f"{tag}: paged-decode launches off the decode/prefill variants")
    check(k2 == exp2 and k2 > 0, f"{tag}: fused-norm launch count off the path")


class _NodeLoop:
    """An asyncio loop on a thread of its own for the port's nodes: the
    engine runs on this thread while the nodes serve the wire there."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()


class _KvReader:
    """A thread taking ``kv_stats`` snapshots while another thread steps
    the engine: block conservation (in use + free + reusable = all) must
    hold in every one. Between its turns it races the steps (a snapshot
    waits for the scheduler lock, which a step holds through its drain);
    ``after_step`` gives it a turn at every step boundary, where the
    stepping thread waits, so the chunks in flight it records are the
    ones its snapshot saw."""

    def __init__(self, sch):
        self.sch = sch
        self.racing = self.at_boundary = self.inflight = 0
        self.failures: list = []
        self._stop = threading.Event()
        self._turn = threading.Event()
        self._taken = threading.Event()
        self._chunks = 0
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _snap(self) -> None:
        pool = self.sch.kv_stats(limit=256)["pool"]
        if pool["blocks_in_use"] + pool["blocks_free"] + pool["blocks_reusable"] \
                != pool["num_blocks"]:
            self.failures.append(pool)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._turn.wait(0.001):
                self._turn.clear()
                self._snap()
                self.at_boundary += 1
                self.inflight += self._chunks > 0
                self._taken.set()
            else:
                self._snap()
                self.racing += 1

    def after_step(self) -> None:
        """The stepping thread's hook: wait while the reader snapshots."""
        self._chunks = len(self.sch._inflight)
        self._taken.clear()
        self._turn.set()
        check(self._taken.wait(30), "kv_stats reader: no snapshot at a step boundary")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


KV_RACE_REQUESTS = 16  # [node slice kv race]: prompts of 1..300 tokens
KV_RACE_NEW = 24  # ... tokens each, so slots free and refill mid-batch


def _kv_race(sch, prompts, name_power: str) -> None:
    """[node slice kv race]: a short batch of its own, after the [slice]
    run whose numbers are reported, so the reader's lock traffic is in no
    timed window: KV_RACE_REQUESTS prompts (the [slice] prompts cut to at
    most 300 tokens, sharing their prefix) on 8 slots, with admissions,
    prefix hits and evictions while the reader snapshots. Every snapshot
    conserves blocks, one is taken at every step boundary, and some of
    those with chunks in flight."""
    batch = [p[:300] for p in (prompts + prompts)[:KV_RACE_REQUESTS]]
    t0 = time.perf_counter()
    steps = 0
    with _KvReader(sch) as reader:
        rids = [sch.submit(p, max_new=KV_RACE_NEW) for p in batch]
        while sch.step():
            steps += 1
            reader.after_step()
    outs = [sch.result(rid) for rid in rids]
    res = {"requests": len(rids), "steps": steps,
           "snapshots_at_boundary": reader.at_boundary,
           "snapshots_at_boundary_in_flight": reader.inflight,
           "snapshots_racing": reader.racing,
           "conservation_failures": len(reader.failures),
           "host_s": time.perf_counter() - t0, "card": name_power}
    say(f"[node slice kv race] {json.dumps(res)}")
    check(all(len(o) == KV_RACE_NEW for o in outs), "kv race: a request did not finish")
    check(not reader.failures, f"kv_stats broke block conservation: {reader.failures[:2]}")
    check(reader.at_boundary == steps, "kv race: a step boundary without a snapshot")
    check(reader.inflight > 0, "kv race: no snapshot was taken with chunks in flight")


def _http_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


# the [slice] model step PERF.md §6 records from before the telemetry
# was attached (captured paged decode, another host: printed for reference)
SLICE_STEP_RECORDED_MS = 9.17
# [slice]'s eager run: the first tokens of each request (32 until the f16
# legs were added; eager decode steps cost about 55 ms each, the captured
# run's gates are unchanged)
SLICE_EAGER_NEW = 16


def _plain_step_ms(sch, vocab: int) -> float:
    """``_profile_decode``'s plain window alone: the wall a model step."""
    rids, _, dt = _decode_window(sch, vocab)
    sch.run_until_idle()
    for rid in rids:
        sch.result(rid)
    return dt / (PROFILE_STEPS * _model_steps(sch)) * 1e3


def _untraced_step(sch, vocab: int) -> dict:
    """The model step of the node-built engine with its telemetry sinks
    (metrics, flight recorder, tracer, the timer's metrics) detached,
    between two with them attached, on the same graphs and pools."""
    sinks = (sch.metrics, sch.recorder, sch.tracer, sch._timer.metrics)
    traced = [_plain_step_ms(sch, vocab)]
    sch.metrics = sch.recorder = sch.tracer = sch._timer.metrics = None
    try:
        untraced = _plain_step_ms(sch, vocab)
    finally:
        sch.metrics, sch.recorder, sch.tracer, sch._timer.metrics = sinks
    traced.append(_plain_step_ms(sch, vocab))
    return {"traced_ms": traced, "untraced_ms": untraced}


def _node_checks(loop: _NodeLoop, node: Node, sch, outs, name_power: str) -> None:
    """[node slice]: the node's metrics, spans and events of the served
    requests, a second node's PING with
    ``ts_since`` (its PONG carries the engine's device-time programs and
    KV summary) and the status server's /kv and /metrics."""
    st = sch.stats()
    n = len(outs)
    counters = node.metrics.counters
    spans = node.tracer.spans()
    roots = {s.span_id for s in spans if s.name == "serving.request"}
    kids = collections.Counter((s.parent_id, s.name) for s in spans
                               if s.name in ("serving.prefill", "serving.decode"))
    res = {"requests_total": counters["serving_requests_total"],
           "tokens_total": counters["serving_tokens_total"],
           "emitted": sum(len(o) for o in outs), "request_spans": len(roots),
           "admit_events": node.flight.counts.get("serving.admit", 0),
           "preemptions": st["preemptions"]}
    check(res["requests_total"] == n, f"serving_requests_total {res['requests_total']} != {n}")
    check(res["tokens_total"] == res["emitted"],
          f"serving_tokens_total {res['tokens_total']} != {res['emitted']} emitted")
    check(len(roots) == n and all(kids[(r, "serving.prefill")] == 1
                                  and kids[(r, "serving.decode")] == 1 for r in roots),
          "one serving.request span a request, each with its prefill and decode")
    check(res["admit_events"] == n + st["preemptions"], "one serving.admit event an admission")

    peer_node = Node(NodeConfig(role="validator", host="127.0.0.1", port=0))
    loop.run(peer_node.start())
    try:
        peer = loop.run(peer_node.connect("127.0.0.1", node.port))
        pong = loop.run(peer_node.request(peer, {"type": "PING", "ts_since": 0}))
        dt = sch.device_time()
        res["pong_programs"] = sorted(pong["capability"]["programs"])
        res["pong_host_gap_frac"] = pong["capability"]["host_gap_frac"]
        check(pong["capability"]["programs"] == json.loads(json.dumps(dt["programs"]))
              and pong["capability"]["host_gap_frac"] == dt["host_gap_frac"],
              "the PONG's capability is not the engine's device_time()")
        check(pong["kv"] == sch.kv_stats_summary(), "the PONG's kv is not kv_stats_summary()")
        check("timeseries_delta" in pong, "no timeseries delta in the PONG")
    finally:
        loop.run(peer_node.stop())
    port = node._http.bound_port
    kv = _http_json(port, "/kv?limit=8")
    met = _http_json(port, "/metrics")
    res.update(http_kv_chains=kv["total_chains"],
               http_metrics_requests=met["counters"]["serving_requests_total"],
               card=name_power)
    check(kv["pool"] == sch.kv_stats(limit=8)["pool"], "GET /kv differs from kv_stats")
    check(met["counters"]["serving_requests_total"] == n, "GET /metrics off the counters")
    say(f"[node slice] {json.dumps(res)}")


def phase_slice(name_power: str, model: Llama, cap: dict) -> dict:
    """The [slice] requests through a paged engine that a started port
    ``Node`` on 127.0.0.1 builds (``_build_serving``), with the node's
    telemetry attached; then a reader thread races ``kv_stats`` on a batch
    of its own (``_kv_race``), and the model step is timed with the
    sinks detached (``_untraced_step``)."""
    cfg = model.cfg
    max_new = 32
    prompts = _requests(cfg.vocab_size)
    loop = _NodeLoop()
    node = Node(NodeConfig(role="worker", host="127.0.0.1", port=0, http_status_port=0))
    node.capability = cap
    try:
        loop.run(node.start())
        sch, rids, outs, wall, k = _serve_paged(model, prompts, max_new, True, cap,
                                                node=node)
        _node_checks(loop, node, sch, outs, name_power)
        _diag_check(loop, node, sch, name_power)
    finally:
        loop.run(node.stop())
        loop.close()
    st = sch.stats()
    _graph_line("slice", st["graphs"])
    tf = _teacher_forced("slice", model, prompts, outs)
    n_long = sum(len(p) >= 513 for p in prompts)
    check(tf["sequences_ge_512"] == n_long,
          f"{n_long} prompts of >= 513 tokens, {tf['sequences_ge_512']} "
          "teacher-forced sequences of >= 512")

    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    tps = sch.decode_only_tokens / sch.decode_only_s if sch.decode_only_s else None
    res = {
        "requests": len(rids), "tokens": tf["tokens"], "wall_s": wall,
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_p50": float(np.median(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "decode_tokens_per_s": tps,
        "decode_only_steps_tokens": sch.decode_only_tokens,
        "output_tokens_per_s": tf["tokens"] / wall,
        "kv_blocks_peak": st["peak_blocks_in_use"],
        "kv_block_bytes": sch.kv_block_bytes,
        "prefix_matched_tokens": st["prefix_matched_tokens"],
        "preemptions": st["preemptions"],
        "card": name_power,
    }
    say(f"[slice] {json.dumps(res)}")
    _timer_line("slice", sch, name_power)
    _check_meters("slice", sch, rids, prompts, max_new, Identity.generate(), cap,
                  name_power)
    prof = _profile_decode(sch, cfg.vocab_size, name_power)
    _check_timer_vs_profile("slice", sch, prof, name_power)
    _telemetry_capture(sch, cfg.vocab_size, name_power)
    _kv_race(sch, prompts, name_power)
    untraced = _untraced_step(sch, cfg.vocab_size)
    del sch
    gc.collect()
    torch.cuda.empty_cache()

    esch, _, eouts, ewall, _ = _serve_paged(model, prompts, SLICE_EAGER_NEW, False)
    tf_e = _teacher_forced("slice eager", model, prompts, eouts)
    _agreement("slice", [o[:SLICE_EAGER_NEW] for o in outs], eouts, tf, tf_e)
    _step_line("slice", prof, None, wall, ewall)
    step = {"traced_profiled_ms": prof["model_step_ms"], **untraced,
            "recorded_ms": SLICE_STEP_RECORDED_MS, "card": name_power}
    say(f"[node slice step] {json.dumps(step)}")
    del esch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_paged": k["paged"], "launches_norm": k["norm"],
            "prompts": prompts, "outs": outs, "prof": prof}


TELEMETRY_MS = 200  # [telemetry]: the on-demand capture's length
TELEMETRY_WAIT_S = 120  # ... and the most its start or its end may take


def _telemetry_check(tag: str, bundle: dict, want: tuple, name_power: str) -> None:
    """A ``runtime.profiling`` breakdown must name the kernels ``want``
    (``KERNEL_FAMILIES``) among its device time."""
    cats = bundle["categories"]
    res = {"total_ms": bundle["total_s"] * 1e3,
           "families_ms": {k: v["s"] * 1e3 for k, v in cats.items()},
           "ops": {k: v["ops"] for k, v in cats.items()}, "card": name_power}
    say(f"[telemetry] {tag}: {json.dumps(res)}")
    check(all(cats.get(f, {}).get("ops", 0) > 0 for f in want),
          f"telemetry: {tag} does not name {want}: {sorted(cats)}")


def _telemetry_capture(sch, vocab: int, name_power: str) -> None:
    """[telemetry] ``profiling.timed_capture(TELEMETRY_MS)`` on a thread
    while this thread decodes 8 requests on the captured [slice] engine
    (as ``GET /profile`` captures a serving node): its breakdown names B3
    and B4. This thread dispatches chunks only inside the first half of
    the capture's window (``profiling.CAPTURE_LIVE``), never while the
    profiler starts or stops; a capture that does not start or end within
    TELEMETRY_WAIT_S fails the run. The requests are cancelled after."""
    r = np.random.default_rng(6)
    rids = [sch.submit(r.integers(0, vocab, (64,)), max_new=PROFILE_NEW)
            for _ in range(8)]
    while getattr(sch, "_pending", None):
        sch.step()
    sch.step()
    torch.cuda.synchronize()
    out = []  # a daemon thread: one that cannot finish does not hold the exit
    worker = threading.Thread(
        target=lambda: out.append(profiling.timed_capture(TELEMETRY_MS)), daemon=True)
    worker.start()
    check(profiling.CAPTURE_LIVE.wait(TELEMETRY_WAIT_S), "telemetry: the capture did not start")
    t0, steps = time.perf_counter(), 0
    while profiling.CAPTURE_LIVE.is_set() and time.perf_counter() - t0 < TELEMETRY_MS / 2e3:
        sch.step()
        steps += 1
    worker.join(TELEMETRY_WAIT_S)
    check(bool(out), "telemetry: the capture did not end")
    bundle = out[0]
    for rid in rids:
        sch.cancel(rid)
    sch.run_until_idle()
    check(bundle["duration_ms"] == TELEMETRY_MS and steps > 0,
          f"telemetry: capture of {bundle['duration_ms']} ms over {steps} steps")
    _telemetry_check(f"timed_capture({TELEMETRY_MS}) while [slice] decodes "
                     f"({steps} scheduler steps)", bundle["op_breakdown"],
                     ("paged_decode (B3)", "fused_residual_norm (B4)"), name_power)


PROFILE_STEPS = 4  # scheduler steps in the plain timed window
PROFILE_PROF_STEPS = 2  # ... and in the profiled one (fewer events to sum)
PROFILE_NEW = 160  # tokens a profiling request: 20 chunks of 8, so all 8
# rows still decode through both windows after the paged chunked prefills


def _model_steps(sch) -> int:
    """Model passes a scheduler step dispatches: ``decode_chunk`` T == 1
    steps, or under speculation ``rounds`` verify passes plus, in draft
    mode, ``rounds * (k + 1)`` draft steps."""
    if sch.spec is None:
        return sch.decode_chunk
    cfg = sch.spec.cfg
    return cfg.rounds * (1 + (cfg.k + 1 if sch.spec.mode == "draft" else 0))


def _decode_window(sch, vocab: int, max_new: int = PROFILE_NEW):
    """8 fresh requests are prefilled and one pure-decode scheduler step
    warms the pipeline; then PROFILE_STEPS steps run between two device
    syncs. -> (request ids, prefill s, window s); the requests decode on."""
    t_start = time.perf_counter()
    r = np.random.default_rng(4)
    rids = [sch.submit(r.integers(0, vocab, (64,)), max_new=max_new)
            for _ in range(8)]
    while getattr(sch, "_pending", None):  # the paged engine's chunked prefill
        sch.step()
    sch.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        sch.step()
    torch.cuda.synchronize()
    return rids, t0 - t_start, time.perf_counter() - t0


def _profile_decode(sch, vocab: int, name_power: str, tag: str = "profile",
                    max_new: int = PROFILE_NEW) -> dict:
    """Where a decode step's time goes: 8 fresh requests are prefilled,
    one pure-decode scheduler step warms the pipeline, then a window of
    PROFILE_STEPS steps runs between two device syncs plainly and then
    PROFILE_PROF_STEPS under ``torch.profiler`` (CUPTI sees the kernels
    of graph replays, not the per-op CPU rows; ``_device_kernel_times``
    sums them). The wall a model step is the plain
    window over its model steps (``_model_steps``); the busy share is the
    device's kernel time over the profiled window's wall. The profiler
    records device activity only (the kernels; no host op rows, whose
    recording slows an eager window and whose processing took most of
    the call). A profiler that records no device time is reported, not
    fatal: the line is diagnosis, not a check. ``host_s``: the call's own
    seconds, by part."""
    from torch.profiler import ProfilerActivity, profile

    rids, prefill_s, plain_s = _decode_window(sch, vocab, max_new)
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_PROF_STEPS):
            sch.step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    t_tail = time.perf_counter()
    sch.run_until_idle()
    for rid in rids:
        sch.result(rid)
    t_ka = time.perf_counter()
    kernels = _device_kernel_times(prof)
    host_s = {"prefill": prefill_s, "plain_window": plain_s,
              "profiled_window": t_tail - t_prof, "tail": t_ka - t_tail,
              "kernel_sums": time.perf_counter() - t_ka}
    busy_us = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    n_model = PROFILE_STEPS * _model_steps(sch)
    n_prof = PROFILE_PROF_STEPS * _model_steps(sch)
    norm_us = sum(us for name, (us, _) in kernels.items() if "norm" in name.lower())
    # PyTorch's elementwise kernels: the glue, and under weight-only int8
    # the materialised dequantize (the int8 -> bf16 cast and the scale)
    elem_us = sum(us for name, (us, _) in kernels.items()
                  if "elementwise" in name.lower())
    res = {
        "decode_step_s": plain_s / PROFILE_STEPS, "model_steps": _model_steps(sch),
        "model_step_ms": plain_s / n_model * 1e3,
        "profiled_step_s": prof_s / PROFILE_PROF_STEPS,
        "kernel_ms_per_model_step": busy_us / 1e3 / n_prof if busy_us else "not measured",
        "kernel_ms_per_step": (busy_us / 1e3 / PROFILE_PROF_STEPS if busy_us
                               else "not measured"),
        "device_busy_share": busy_us / 1e6 / prof_s if busy_us else "not measured",
        "norm_kernel_share": norm_us / busy_us if busy_us else "not measured",
        "elementwise_ms_per_model_step": (elem_us / 1e3 / n_prof if busy_us
                                          else "not measured"),
        "pipeline_depth": sch.pipeline_depth,
        "top_kernels_ms": {name[:48]: [us / 1e3, n] for name, (us, n) in top[:8]},
        "host_s": host_s,
        "card": name_power,
    }
    say(f"[{tag}] {json.dumps(res)}")
    return res


def _device_kernel_times(prof) -> dict:
    """{name: [device us, count]} of a profile's device activity (kernels,
    copies, memsets), summed straight from its Kineto events:
    ``key_averages`` first builds a FunctionEvent for every one of them,
    which took 2-7 s a decode window."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            t = out.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e3
            t[1] += 1
    return out


def _step_line(tag: str, cap: dict, eager: dict | None, wall_c: float,
               wall_e: float) -> None:
    """Captured against eager: the decode step's wall and busy share, and
    each whole run's wall, on one line. The serving legs profile their
    captured run only (``eager`` None: an eager window is ungated
    diagnosis, cut for the run's time); ``generate``'s legs profile
    both."""
    keys = ("model_step_ms", "kernel_ms_per_model_step", "device_busy_share")
    res = {"captured": {k: cap[k] for k in keys},
           "eager": {k: eager[k] for k in keys} if eager else "not profiled",
           "run_wall_s": {"captured": wall_c, "eager": wall_e}}
    say(f"[{tag} step] {json.dumps(res)}")


# ------------------------------------ timer, metering, disaggregation
# [capability]: sized so the card is filled (the reference's defaults, a
# 512 matmul and 64 MB, read an H100 far below its peak, and the receipt
# auditor would then flag honest prefill receipts as overclaims)
CAP_MATMUL_DIM = 8192
CAP_HBM_MB = 1024
CAP_REPS = 10
TIMER_TOL = 0.2  # decode busy EWMA a step vs the profiled model-step wall
METER_TOL = 0.01  # meters' summed busy_s vs the timer's device busy
INT8_BLOB_MAX = 0.6  # an int8 blob against the float blob of its prompt
DISAGG_INT8_PICK = (0, 1, 5, 9)  # [slice] requests of <= 600 tokens
ZLIB_PICK = 3  # the [slice] request (129 tokens) the zlib ratio is read on


def phase_capability(name_power: str) -> dict:
    rec = FlightRecorder()
    cap = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB,
                             reps=CAP_REPS, recorder=rec)
    say(f"[capability] {json.dumps({**cap, 'card': name_power})}")
    check(cap["peak_tflops"] > 0 and cap["hbm_gbps"] > 0,
          "capability: no matmul or HBM rate measured")
    check(rec.counts.get("capability.measured") == 1, "no capability.measured event")
    return cap


def _timer_line(tag: str, sch, name_power: str) -> dict:
    """``stats()["device_time"]`` on one line: per program the count, busy
    and gap seconds, host-gap share, device tokens/s, MFU and MBU."""
    dt = sch.stats()["device_time"]
    progs = {}
    for name, r in dt["programs"].items():
        both = r["gap_s"] + r["busy_s"]
        progs[name] = {
            "count": r["count"], "busy_s": r["busy_s"], "gap_s": r["gap_s"],
            "host_gap_frac": r["gap_s"] / both if both else 0.0,
            "busy_ewma_s": r["busy_ewma_s"],
            "device_tokens_per_s": r.get("device_tokens_per_sec", 0.0),
            "mfu": r.get("mfu", "not measured"), "mbu": r.get("mbu", "not measured"),
        }
    res = {"programs": progs, "device_busy_s": dt["device_busy_s"],
           "host_gap_s": dt["host_gap_s"], "host_gap_frac": dt["host_gap_frac"],
           "pending": dt["pending"], "card": name_power}
    say(f"[timer {tag}] {json.dumps(res)}")
    check(dt["pending"] == 0, f"timer {tag}: dispatches left unfinalized")
    return dt


def _check_meters(tag: str, sch, rids, prompts, emitted: int, identity, cap: dict,
                  name_power: str, wire=None) -> dict:
    """Gates 2-4 once the engine has drained: the busy seconds of every
    meter it wrote sum to the timer's device busy (every chunk and every
    prefill billed some request); each request's meter has its prompt
    tokens, ``emitted`` tokens, KV block-seconds and (``wire``) the blob
    it was imported from; each signs into a receipt that verifies and
    that an auditor holding ``cap`` accepts without an anomaly."""
    dt = sch.stats()["device_time"]
    timer_busy = sum(r["busy_s"] for r in dt["programs"].values())
    written = sch.drain_meters(limit=1 << 20)
    billed = sum(m["busy_s"] for m in written)
    meters = [sch.meter(rid) for rid in rids]
    check(all(m is not None for m in meters), f"metering {tag}: a meter is missing")
    bad = [i for i, (m, p) in enumerate(zip(meters, prompts))
           if m["prompt_tokens"] != len(p) or m["emitted_tokens"] != emitted
           or m["kv_block_s"] <= 0 or m["busy_s"] <= 0
           or (wire is not None and m["wire_bytes"] != wire[i])]
    aud = ReceiptAuditor(capability_for=lambda worker: cap)
    verdicts = []
    for m in written:
        r = build_receipt(m, identity)
        ok, why = verify_receipt(r)
        check(ok, f"metering {tag}: receipt of rid {m['rid']} fails to verify: {why}")
        verdicts.append(aud.ingest(r))
    refused = [v for v in verdicts if not v["accepted"] or v["anomalies"]]
    res = {
        "meters": len(written), "kind": sch.meter_kind,
        "billed_busy_s": billed, "timer_busy_s": timer_busy,
        "billed_over_timer": billed / timer_busy if timer_busy else None,
        "receipts_accepted": aud.accepted_total, "anomalies": dict(aud.anomaly_counts),
        "identity": "rsa" if HAVE_CRYPTOGRAPHY else "dev (no cryptography package)",
        "busy_s_per_request_mean": float(np.mean([m["busy_s"] for m in meters])),
        "kv_block_s_mean": float(np.mean([m["kv_block_s"] for m in meters])),
        "achieved_tflops_per_request_mean": float(np.mean(
            [m["flops"] / m["busy_s"] / 1e12 for m in meters])),
        "wire_bytes_mean": float(np.mean([m["wire_bytes"] for m in meters])),
        "card": name_power,
    }
    say(f"[metering {tag}] {json.dumps(res)}")
    check(timer_busy > 0 and abs(billed / timer_busy - 1) <= METER_TOL,
          f"metering {tag}: meters bill {billed} s of {timer_busy} s device busy")
    check(not bad, f"metering {tag}: meters of requests {bad} off their counts")
    check(not refused, f"metering {tag}: receipts refused or flagged: {refused}")
    return res


def _check_timer_vs_profile(tag: str, sch, prof: dict, name_power: str) -> None:
    """Gate 1: the timer's decode busy EWMA a T == 1 step against the
    model-step wall the profiled window measured on the same engine."""
    rec = sch.stats()["device_time"]["programs"]["decode"]
    per_step_ms = rec["busy_ewma_s"] / sch.decode_chunk * 1e3
    ratio = per_step_ms / prof["model_step_ms"]
    say(f"[timer {tag} vs profile] " + json.dumps({
        "timer_decode_busy_ewma_ms_per_step": per_step_ms,
        "profile_model_step_ms": prof["model_step_ms"], "ratio": ratio,
        "tolerance": TIMER_TOL, "card": name_power}))
    check(abs(ratio - 1) <= TIMER_TOL,
          f"timer {tag}: decode busy {per_step_ms:.3f} ms a step against a "
          f"{prof['model_step_ms']:.3f} ms model-step wall")


def _import_when_free(D, payload, wire_bytes: int) -> tuple[int, float, tuple, int]:
    """``D.import_prefill``, stepping D while it answers with a typed
    ``OverloadedError`` (no free decode slot yet). -> (rid, host seconds
    and CUDA events of the call that succeeded, refused calls)."""
    refused = 0
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        try:
            rid = D.import_prefill(payload, wire_bytes=wire_bytes)
        except OverloadedError:
            refused += 1
            check(D.step(), "disagg: decode leg full and idle")
            continue
        b.record()
        return rid, time.perf_counter() - t0, (a, b), refused


def _disagg_run(P, D, prompts) -> dict:
    """Each prompt: ``P.prefill_export``, pack (codec none), unpack,
    ``D.import_prefill``; one ``D.step()`` after each import so the next
    graft lands with chunks in flight. -> the decode leg's rids and
    outputs and the per-request times and sizes."""
    gather_s, stage_s = [], []

    def timed(fn, into):
        def wrapped(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            into.append(time.perf_counter() - t0)
            return out
        return wrapped

    # the export's gather (index_select, copy to pinned memory, its one
    # sync) and the import's host staging (pinned copy, upload enqueued)
    P._gather_blocks = timed(P._gather_blocks, gather_s)
    D._stage_graft = timed(D._stage_graft, stage_s)
    rec = {"prefill_export_s": [], "pack_s": [], "unpack_s": [], "import_host_s": [],
           "blob_bytes": [], "payload_bytes": [], "import_events": [], "import_refused": 0}
    rids = []
    for p in prompts:
        t0 = time.perf_counter()
        payload = P.prefill_export(p)
        rec["prefill_export_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        blob = pack_kv_payload(payload, codec="none")
        rec["pack_s"].append(time.perf_counter() - t0)
        del payload
        t0 = time.perf_counter()
        back = unpack_kv_payload(blob)
        rec["unpack_s"].append(time.perf_counter() - t0)
        rec["blob_bytes"].append(len(blob))
        rec["payload_bytes"].append(packed_nbytes(blob))
        del blob
        rid, host_s, events, refused = _import_when_free(D, back, rec["blob_bytes"][-1])
        rids.append(rid)
        rec["import_host_s"].append(host_s)
        rec["import_events"].append(events)
        rec["import_refused"] += refused
        del back
        D.step()
    D.run_until_idle()
    P.run_until_idle()
    torch.cuda.synchronize()
    del P._gather_blocks, D._stage_graft
    rec["export_gather_s"] = gather_s
    rec["import_staging_s"] = stage_s
    rec["import_device_s"] = [a.elapsed_time(b) / 1e3 for a, b in rec.pop("import_events")]
    rec["outs"] = [D.result(rid) for rid in rids]
    rec["rids"] = rids
    return rec


def _ms(xs) -> dict:
    return {"mean": float(np.mean(xs)) * 1e3, "max": float(np.max(xs)) * 1e3}


def _gbps(nbytes, secs) -> dict:
    rates = [n / s / 1e9 for n, s in zip(nbytes, secs)]
    return {"mean": float(np.mean(rates)), "max": float(np.max(rates))}


def phase_disagg(name_power: str, model: Llama, prompts, slice_outs, cap: dict) -> dict:
    """[disagg]: the [slice] requests split over a prefill leg P and a
    decode leg D (two engines on one model, each with its own pools and
    graphs), blocks crossing the packed wire in between; then the timer
    and metering gates on D and P and the profiled decode on D."""
    cfg = model.cfg
    L = cfg.num_layers
    check(native.have_native(),
          "disagg: the native wire codec did not build (the Python CRC "
          "fallback would take minutes on these payloads)")
    P = _slice_engine(model, 32, capability=cap)
    D = _slice_engine(model, 32, capability=cap)
    P.meter_kind, D.meter_kind = "prefill_leg", "decode_leg"
    torch.cuda.synchronize()
    _zero_counts()
    t_run = time.perf_counter()
    rec = _disagg_run(P, D, prompts)
    wall = time.perf_counter() - t_run
    by_variant = dict(paged_decode_attention.launches_by_variant)
    k_norm = fused_residual_norm.launches
    outs = rec["outs"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(outs, slice_outs)]
    sp, sd = P.stats(), D.stats()
    exp_var = {"general": 0, "prefill": L * sp["prefill_chunks"],
               "decode": L * sd["decode_steps"]}
    say(f"[disagg] launches: paged_decode by variant {by_variant} (expected "
        f"{exp_var}), fused_norm {k_norm} (expected {L * sd['decode_steps']}); "
        f"P prefill chunks {sp['prefill_chunks']} decode steps {sp['decode_steps']}, "
        f"D prefill chunks {sd['prefill_chunks']} decode steps {sd['decode_steps']}")
    _graph_line("disagg D", sd["graphs"])
    check(all(same), f"disagg: requests {[i for i, x in enumerate(same) if not x]} "
          "differ from the [slice] run's tokens")
    check(by_variant == exp_var and min(exp_var["prefill"], exp_var["decode"]) > 0,
          "disagg: paged-decode launches off the legs' variants")
    check(k_norm == L * sd["decode_steps"] and sp["decode_steps"] == 0
          and sd["prefill_chunks"] == 0, "disagg: fused-norm launches off the path")
    g = sd["graphs"]
    check(g["captured"] == 1 and g["replays"] == sd["decode_steps"] // 8 - 1,
          f"disagg: every D chunk but the first must be a replay: {g}")
    n_tok = [len(p) for p in prompts]
    for st, side in ((sp["disagg"], "export"), (sd["disagg"], "import")):
        check(st[f"{side}s"] == len(prompts) and st[f"{side}_tokens"] == sum(n_tok)
              and st[f"{side}_blocks"] == sum(-(-n // 16) for n in n_tok),
              f"disagg: {side} counts off: {st}")
    # the zlib ratio on one request (its own export, after the run)
    pz = P.prefill_export(prompts[ZLIB_PICK])
    raw_len = len(pack_kv_payload(pz, codec="none"))
    t0 = time.perf_counter()
    z_len = len(pack_kv_payload(pz, codec="zlib"))
    z_s = time.perf_counter() - t0
    del pz
    res = {
        "requests": len(prompts), "tokens_equal_slice": int(sum(same)),
        "wall_s": wall,
        "prefill_export_ms": _ms(rec["prefill_export_s"]),
        "export_gather_ms": _ms(rec["export_gather_s"]),
        "pack_gbps": _gbps(rec["payload_bytes"], rec["pack_s"]),
        "unpack_gbps": _gbps(rec["payload_bytes"], rec["unpack_s"]),
        "import_host_ms": _ms(rec["import_host_s"]),
        "import_staging_host_ms": _ms(rec["import_staging_s"]),
        "import_device_span_ms": _ms(rec["import_device_s"]),
        "imports_refused_no_slot": rec["import_refused"],
        # over the whole run: a short prompt ships a whole block, so a
        # mean of per-request ratios would weigh the 1-token prompt 16x
        "blob_bytes_per_prompt_token": sum(rec["blob_bytes"]) / sum(n_tok),
        "blob_bytes_per_block_slot": sum(rec["blob_bytes"]) / (16 * sd["disagg"]["import_blocks"]),
        "blob_bytes_total": int(sum(rec["blob_bytes"])),
        "zlib_ratio": {"request": ZLIB_PICK, "tokens": n_tok[ZLIB_PICK],
                       "none_bytes": raw_len, "zlib_bytes": z_len,
                       "ratio": z_len / raw_len, "zlib_s": z_s},
        "native_codec": native.have_native(),
        "P_disagg": sp["disagg"], "D_disagg": sd["disagg"],
        "card": name_power,
    }
    say(f"[disagg] {json.dumps(res)}")
    _timer_line("disagg P", P, name_power)
    _timer_line("disagg D", D, name_power)
    _check_meters("disagg P", P, list(range(len(prompts))), prompts, 0,
                  Identity.generate(), cap, name_power)
    _check_meters("disagg D", D, rec["rids"], prompts, 32, Identity.generate(), cap,
                  name_power, wire=rec["blob_bytes"])
    prof = _profile_decode(D, cfg.vocab_size, name_power, tag="disagg D profile")
    _check_timer_vs_profile("disagg D", D, prof, name_power)
    del P, D
    _free_cuda()
    return {"paged": sum(by_variant.values()), "norm": k_norm,
            "float_blob_bytes": rec["blob_bytes"]}


def _share_equal(outs, refs) -> float:
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, refs))
    return same / sum(len(a) for a in outs)


def phase_disagg_int8(name_power: str, model: Llama, prompts, slice_outs,
                      float_blob_bytes) -> dict:
    """[disagg int8]: 4 of the [slice] requests (prompts <= 600 tokens)
    int8 -> int8 (both legs ``kv_quant="int8"``, token-identical to an
    int8 colocated engine, blobs under INT8_BLOB_MAX of the float blob of
    the same prompt, B3's decode variant on int8 pools), then float ->
    int8 and int8 -> float, each teacher-forced, with the share of
    tokens equal to the importing engine's colocated run."""
    L = model.cfg.num_layers
    pick = list(DISAGG_INT8_PICK)
    ps = [prompts[i] for i in pick]
    check(all(len(p) <= 600 for p in ps), "disagg int8: a prompt over 600")
    C8 = _slice_engine(model, 32, kv_quant="int8")
    rids = [C8.submit(p) for p in ps]
    C8.run_until_idle()
    colo8 = [C8.result(r) for r in rids]
    del C8
    _free_cuda()
    P8 = _slice_engine(model, 32, kv_quant="int8")
    D8 = _slice_engine(model, 32, kv_quant="int8")
    _zero_counts()
    rec = _disagg_run(P8, D8, ps)
    by_variant = dict(paged_decode_attention.launches_by_variant)
    k_norm = fused_residual_norm.launches
    sp, sd = P8.stats(), D8.stats()
    exp_var = {"general": 0, "prefill": L * sp["prefill_chunks"],
               "decode": L * sd["decode_steps"]}
    ratio = [b / float_blob_bytes[i] for b, i in zip(rec["blob_bytes"], pick)]
    same = [bool(np.array_equal(a, b)) for a, b in zip(rec["outs"], colo8)]
    pool_dtype = str(D8._pools[0]["k"].dtype)
    res = {"requests": len(ps), "prompt_tokens": [len(p) for p in ps],
           "int8_int8_tokens_equal_int8_colocated": int(sum(same)),
           "blob_over_float_blob": ratio, "decode_pool_dtype": pool_dtype,
           "launches_by_variant": by_variant, "expected": exp_var,
           "fused_norm": k_norm,
           "export_gather_ms": _ms(rec["export_gather_s"]),
           "import_device_span_ms": _ms(rec["import_device_s"]),
           "card": name_power}
    say(f"[disagg int8] {json.dumps(res)}")
    check(all(same), "disagg int8: int8 -> int8 tokens differ from the int8 "
          "colocated engine's")
    check(max(ratio) < INT8_BLOB_MAX, f"disagg int8: blob ratios {ratio}")
    check(pool_dtype == "torch.int8" and by_variant == exp_var
          and exp_var["decode"] > 0, "disagg int8: B3 launches off the int8 path")
    check(k_norm == L * sd["decode_steps"], "disagg int8: fused-norm launches off the path")
    _check_replays("disagg int8 D", sd)
    del D8
    _free_cuda()
    # float -> int8, then int8 -> float (P8 keeps its warm prefixes)
    PF = _slice_engine(model, 32)
    D8b = _slice_engine(model, 32, kv_quant="int8")
    f2q = _disagg_run(PF, D8b, ps)["outs"]
    del PF, D8b
    _free_cuda()
    DF = _slice_engine(model, 32)
    q2f = _disagg_run(P8, DF, ps)["outs"]
    del P8, DF
    _free_cuda()
    tf1 = _teacher_forced("disagg float->int8", model, ps, f2q)
    tf2 = _teacher_forced("disagg int8->float", model, ps, q2f)
    res = {"float_to_int8_share_equal_int8_colocated": _share_equal(f2q, colo8),
           "int8_to_float_share_equal_float_colocated":
               _share_equal(q2f, [slice_outs[i] for i in pick]),
           "worst_gap": {"float_to_int8": tf1["worst_gap"],
                         "int8_to_float": tf2["worst_gap"]},
           "card": name_power}
    say(f"[disagg int8 cross-form] {json.dumps(res)}")
    return {"paged": sum(by_variant.values()), "norm": k_norm}


# ------------------------------------------------------ contiguous-cache legs
# [static]: examples/serve_llm.py's default path, InferenceEngine.generate on
# a static left-padded batch; T0 + new rounds up to 2304 cache slots, above
# the 2048 where decode takes the blockwise loop
STATIC_LENS = (700, 1200, 1650, 2000)
STATIC_NEW = 64
STATIC_MAX_LEN = 4096
STATIC_PROFILE_STEP = 40  # decode steps 40..47 run under the profiler
# [contiguous]: the --continuous path, 16 requests of 1..900 tokens (eight
# submitted after the first scheduler step); GPT-2's position table ends at
# 1024, so max_len does too
CONT_LENS = (1, 37, 900, 128, 512, 255, 700, 64, 3, 800, 333, 129, 31, 600, 450, 96)
CONT_NEW = 32
CONT_MAX_LEN = 1024
# [rolling]: the --window path at Mistral-7B's width, depth cut to 2 layers:
# the ring (T0 + window = 4352 slots) wraps only after more than 4096 decode
# steps, which 32 layers would take ~16x the chip time to reach
ROLL_LENS = (256, 200)
ROLL_NEW = 4200
ROLL_MAX_LEN = 4608
ROLL_LAYERS = 2
# after the ring's first wrap (step 4097), and both windows (steps 4104..4119)
# inside one block range of the full cache's blockwise read (4096..4351)
ROLL_PROFILE_STEP = 4112


def _zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
    fused_residual_norm.launches = 0
    fused_residual_norm.launches_by_form = dict.fromkeys(FORMS, 0)
    flash_attention_fwd_lse.launches = 0
    flash_attention_fwd_lse.launches_by_variant = {"bf16": 0, "f32": 0, "f16": 0}
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_form = {"own": 0, "delta": 0}
    flash_attention_bwd.launches_by_variant = {"bf16": 0, "f32": 0, "f16": 0}
    tp.reset_collectives()


def _counts() -> dict:
    return {
        "paged_decode": paged_decode_attention.launches,
        "fused_norm": fused_residual_norm.launches,
        "fused_norm_by_form": dict(fused_residual_norm.launches_by_form),
        "flash_fwd": flash_attention_fwd_lse.launches,
        "flash_bwd": flash_attention_bwd.launches,
        "flash_bwd_by_form": dict(flash_attention_bwd.launches_by_form),
        "flash_fwd_by_variant": dict(flash_attention_fwd_lse.launches_by_variant),
        "flash_bwd_by_variant": dict(flash_attention_bwd.launches_by_variant),
        "collectives": sum(tp.collective_counts().values()),
        "all_to_all": tp.all_to_all_model.collectives,
    }


def _check_decode_launches(tag: str, c: dict, expected: int, form: str) -> None:
    """B4 once a layer a decode step, all in ``form``; no other kernel
    (the prefill masks are general, so B1 stays off, as in the JAX
    package; the contiguous cache has no block table for B3)."""
    say(f"[{tag}] launches: {json.dumps(c)}; expected fused_norm {expected} "
        f"({form}), none of the others")
    check(c["fused_norm"] == expected > 0
          and c["fused_norm_by_form"][form] == expected,
          f"{tag}: fused-norm launches off the path")
    check(c["flash_fwd"] == c["flash_bwd"] == c["paged_decode"] == 0,
          f"{tag}: an attention kernel ran on the contiguous path")


def _left_padded(lens, vocab: int, seed: int):
    """(prompts, ids [B, T0], pad mask): prompts of ``lens`` tokens,
    left-padded to the longest."""
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, vocab, (n,)) for n in lens]
    return (prompts, *_pad_left(prompts))


def _pad_left(prompts):
    """(ids [B, T0], pad mask) of ``prompts`` left-padded to the longest."""
    T0 = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), T0), np.int64)
    pad = np.zeros_like(ids)
    for b, p in enumerate(prompts):
        ids[b, T0 - len(p):] = p
        pad[b, T0 - len(p):] = 1
    return ids, pad


def _cache_bytes(eng, B: int, slots: int) -> int:
    attn = eng.model.blocks.blocks()[0].attn
    item = torch.empty((), dtype=eng.cache_dtype).element_size()
    return (2 * len(eng.model.blocks.blocks()) * B * slots
            * attn.num_kv_heads * attn.head_dim * item)


def _generate_traced(tag: str, eng, ids, pad, max_new: int, first: int,
                     name_power: str, active: int = 8) -> dict:
    """``eng.generate`` of ``max_new`` greedy tokens, with the engine's
    step hook (called before decode step i, on the host, replay or not):
    at step 1 a device sync stamps the prefill's end; steps first -
    active .. first - 1 run between two syncs (the plain window, ms a
    step), steps first .. first + active - 1 under torch.profiler between
    two syncs (kernel ms a step; the busy share is that over the plain
    step). -> the tokens, host seconds in all and to the prefill's end,
    and ms a decode step."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])  # the kernels only
    stamps = {}

    def hook(i):
        if i in (1, first - active, first, first + active):
            torch.cuda.synchronize()
            stamps[i] = time.perf_counter()
        if i == first:
            prof.start()
        elif i == first + active:
            prof.stop()

    eng.step_hook = hook
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(ids, GenerationConfig(max_new_tokens=max_new),
                           pad_mask=pad)
        total_s = time.perf_counter() - t0
    finally:
        eng.step_hook = None
    check(first + active in stamps, f"{tag}: the profiled window did not close")
    decode_ms = (stamps[first] - stamps[first - active]) / active * 1e3
    window_s = stamps[first + active] - stamps[first]
    kernels = {name: us / active / 1e3 for name, (us, _) in _device_kernel_times(prof).items()}
    busy = sum(kernels.values())
    norm = sum(v for k, v in kernels.items() if "norm" in k.lower())
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:8]
    res = {
        "model_step_ms": decode_ms,
        "profiled_window_ms_per_step": window_s / active * 1e3,
        "kernel_ms_per_model_step": busy if busy > 0 else "not measured",
        "device_busy_share": busy / decode_ms if busy > 0 else "not measured",
        "norm_kernel_share": norm / busy if busy > 0 else "not measured",
        "top_kernels_ms_per_step": {k[:48]: v for k, v in top},
        "card": name_power,
    }
    say(f"[{tag} profile] {json.dumps(res)}")
    return {"out": out, "total_s": total_s, "prefill_s": stamps[1] - t0,
            "decode_ms": decode_ms, "profile": res}


def _second_call_s(eng, ids, pad, max_new: int) -> float:
    """Host seconds of a second ``generate`` of the same shape (its graphs
    and cache kept from the first)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, GenerationConfig(max_new_tokens=max_new), pad_mask=pad)
    return time.perf_counter() - t0


def phase_static(name_power: str, model: Llama) -> dict:
    """Llama-3-8B (the model phase_slice served) through
    ``InferenceEngine.generate``: 4 left-padded prompts, greedy, decode
    steps as graph replays, then the same call again (graphs kept) and
    the same call on an eager engine; B4 on every decode step of every
    layer, B1 never; every token of both runs within LOGIT_GAP_TOL of the
    teacher-forced row maximum."""
    cfg = model.cfg
    prompts, ids, pad = _left_padded(STATIC_LENS, cfg.vocab_size, seed=6)
    B, T0 = ids.shape
    steps = STATIC_NEW - 1
    runs = {}
    for mode in ("captured", "eager"):
        eng = InferenceEngine(model, max_len=STATIC_MAX_LEN,
                              cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV,
                              cuda_graphs=mode == "captured")
        slots, rolling = eng.cache_plan(T0, STATIC_NEW)
        check(not rolling and slots > DECODE_BLOCKWISE_MIN_WINDOWLESS
              and slots % DECODE_BLOCK == 0,
              f"static: {slots} cache slots do not take the blockwise decode")
        tag = "static" if mode == "captured" else "static eager"
        _zero_counts()
        run = _generate_traced(tag, eng, ids, pad, STATIC_NEW,
                               STATIC_PROFILE_STEP, name_power)
        run["counts"] = c = _counts()
        _check_decode_launches(tag, c, cfg.num_layers * steps, "rms")
        check(run["out"].shape == (B, STATIC_NEW),
              f"{tag}: tokens of shape {run['out'].shape}")
        run["tf"] = _teacher_forced(tag, model, prompts, list(run["out"]))
        if mode == "captured":
            g = eng.graph_stats()
            _graph_line("static", g)
            # one graph a block range: 8 blocks of 256 up to slot 2048, 9 after
            check(g["captured"] == 2 and g["replays"] == steps - 2,
                  f"static: decode steps off the graphs: {g}")
            run["second_call_s"] = _second_call_s(eng, ids, pad, STATIC_NEW)
            run["cache_bytes"] = _cache_bytes(eng, B, slots)
        runs[mode] = run
        eng._gen_state = None  # free the 1.2 GB cache before the next engine
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    cap, eag = runs["captured"], runs["eager"]
    _agreement("static", list(cap["out"]), list(eag["out"]), cap["tf"], eag["tf"])
    _step_line("static", cap["profile"], eag["profile"], cap["total_s"], eag["total_s"])
    res = {
        "model": "Llama-3-8B", "layers": cfg.num_layers, "batch": B, "T0": T0,
        "prompt_lens": list(STATIC_LENS), "new_tokens": STATIC_NEW,
        "cache_slots": slots, "cache_bytes": cap["cache_bytes"],
        "prefill_s": cap["prefill_s"], "generate_s": cap["total_s"],
        "generate_s_second_call": cap["second_call_s"],
        "decode_ms_per_step": cap["decode_ms"],
        "eager_decode_ms_per_step": eag["decode_ms"],
        "tokens_per_s": B * STATIC_NEW / cap["total_s"],
        "tokens_per_s_second_call": B * STATIC_NEW / cap["second_call_s"],
        "decode_tokens_per_s": B * steps / (cap["total_s"] - cap["prefill_s"]),
        "launches_fused_norm": cap["counts"]["fused_norm"], "card": name_power,
    }
    say(f"[static] {json.dumps(res)}")
    return {"launches_norm": cap["counts"]["fused_norm"],
            "worst_gap": cap["tf"]["worst_gap"]}


def _serve_contiguous(model, prompts, cuda_graphs: bool):
    """The 16 requests through a fresh contiguous engine (eight submitted
    after the first scheduler step); B4's launches checked against the
    decode steps. -> (engine, request ids, outputs, wall s, counts)."""
    gcfg = model.cfg
    eng = InferenceEngine(model, max_len=CONT_MAX_LEN, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = ContinuousBatchingEngine(
        eng, slots=8, decode_chunk=8, prefill_block=32,
        gen=GenerationConfig(max_new_tokens=CONT_NEW), cuda_graphs=cuda_graphs,
    )
    tag = "contiguous" if cuda_graphs else "contiguous eager"
    _zero_counts()
    t_run = time.perf_counter()
    rids = [sch.submit(p) for p in prompts[:8]]
    sch.step()
    rids += [sch.submit(p) for p in prompts[8:]]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    c = _counts()
    st = sch.stats()
    outs = [sch.result(rid) for rid in rids]
    check(all(len(o) == CONT_NEW for o in outs), f"{tag}: a request did not finish")
    _check_decode_launches(tag, c, gcfg.num_layers * st["decode_steps"],
                           "layer+bias")
    if cuda_graphs:
        g = st["graphs"]
        check(g["captured"] == 1 and g["replays"] == st["decode_steps"] // 8 - 1,
              f"{tag}: every decode chunk but the first must be a replay: {g}")
    return sch, rids, outs, wall, c


def phase_contiguous(name_power: str) -> dict:
    """GPT-2-medium (random bf16 weights from seed 0) served by the
    contiguous ``ContinuousBatchingEngine``: 16 greedy requests, eight of
    them submitted after the first scheduler step, decode chunks as graph
    replays, then the same requests eagerly; B4 in its LayerNorm + bias
    form on every decode step of every layer."""
    gcfg = GPT2Config.medium()
    t0 = time.perf_counter()
    model = GPT2(gcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    r = np.random.default_rng(7)
    prompts = [r.integers(0, gcfg.vocab_size, (n,)) for n in CONT_LENS]
    sch, rids, outs, wall, c = _serve_contiguous(model, prompts, True)
    st = sch.stats()
    say(f"[contiguous] GPT-2-medium {gcfg.num_layers} layers dim {gcfg.dim} "
        f"vocab {gcfg.vocab_size}: params + run in "
        f"{time.perf_counter() - t0:.1f} s, cache {sch.kv_bytes} bytes, "
        f"pipeline depth {sch.pipeline_depth}")
    _graph_line("contiguous", st["graphs"])
    tf = _teacher_forced("contiguous", model, prompts, outs)
    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    res = {
        "model": "GPT-2-medium", "requests": len(rids), "tokens": tf["tokens"],
        "wall_s": wall, "ttft_s_mean": float(np.mean(ttft)),
        "ttft_s_p50": float(np.median(ttft)), "ttft_s_max": float(np.max(ttft)),
        "decode_tokens_per_s": (sch.decode_only_tokens / sch.decode_only_s
                                if sch.decode_only_s else None),
        "decode_only_steps_tokens": sch.decode_only_tokens,
        "output_tokens_per_s": tf["tokens"] / wall,
        "decode_steps": st["decode_steps"], "prefills": st["prefill_chunks"],
        "cache_bytes": sch.kv_bytes, "card": name_power,
    }
    say(f"[contiguous] {json.dumps(res)}")
    prof = _profile_decode(sch, gcfg.vocab_size, name_power, tag="contiguous profile")
    del sch
    gc.collect()
    torch.cuda.empty_cache()
    esch, _, eouts, ewall, _ = _serve_contiguous(model, prompts, False)
    tf_e = _teacher_forced("contiguous eager", model, prompts, eouts)
    _agreement("contiguous", outs, eouts, tf, tf_e)
    _step_line("contiguous", prof, None, wall, ewall)
    return {"launches_norm": c["fused_norm"], "worst_gap": tf["worst_gap"]}


def phase_rolling(name_power: str) -> dict:
    """Mistral-7B's width at 2 layers (random bf16 weights from seed 0)
    through ``InferenceEngine(rolling_cache=True).generate``: 2
    left-padded prompts, greedy, long enough that the ring wraps, decode
    steps as graph replays, then the same call on an eager engine; B4 on
    every decode step; every token of both runs within LOGIT_GAP_TOL of
    the no-cache windowed forward's row maximum; the full cache's plan
    beside it for its bytes."""
    mcfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_layers=ROLL_LAYERS)
    model = Llama(mcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    kw = {"max_len": ROLL_MAX_LEN, "cache_dtype": torch.bfloat16,
          "param_dtype": torch.bfloat16, "device": DEV}
    ring = InferenceEngine(model, rolling_cache=True, **kw)
    full = InferenceEngine(model, **kw)
    prompts, ids, pad = _left_padded(ROLL_LENS, mcfg.vocab_size, seed=8)
    B, T0 = ids.shape
    slots, rolling = ring.cache_plan(T0, ROLL_NEW)
    full_slots, _ = full.cache_plan(T0, ROLL_NEW)
    check(rolling and slots == T0 + mcfg.attn_window < full_slots,
          f"rolling: plan {slots} slots (ring {rolling}), full {full_slots}")
    made = []  # the caches generate allocates, to read the ring back

    def init_caches(*a, **k):
        made.append(Llama.init_caches(model, *a, **k))
        return made[-1]

    steps = ROLL_NEW - 1
    model.init_caches = init_caches
    try:
        _zero_counts()
        run = _generate_traced("rolling", ring, ids, pad, ROLL_NEW,
                               ROLL_PROFILE_STEP, name_power)
        c = _counts()
    finally:
        del model.init_caches
    _check_decode_launches("rolling", c, ROLL_LAYERS * steps, "rms")
    g = ring.graph_stats()
    _graph_line("rolling", g)
    check(g["captured"] == 1 and g["replays"] == steps - 1,
          f"rolling: decode steps off the graph: {g}")
    cache = made[-1][0]["attn"]
    writes = T0 + c["fused_norm"] // ROLL_LAYERS  # the prompt, then a slot a step
    check("rolling" in cache and cache["k"].shape[1] == slots < writes,
          f"rolling: the ring of {cache['k'].shape[1]} slots took {writes} writes")
    out = run["out"]
    tf = _teacher_forced("rolling", model, prompts, list(out))
    eager = InferenceEngine(model, rolling_cache=True, cuda_graphs=False, **kw)
    _zero_counts()
    run_e = _generate_traced("rolling eager", eager, ids, pad, ROLL_NEW,
                             ROLL_PROFILE_STEP, name_power)
    _check_decode_launches("rolling eager", _counts(), ROLL_LAYERS * steps, "rms")
    tf_e = _teacher_forced("rolling eager", model, prompts, list(run_e["out"]))
    _agreement("rolling", list(out), list(run_e["out"]), tf, tf_e)
    _step_line("rolling", run["profile"], run_e["profile"], run["total_s"],
               run_e["total_s"])
    res = {
        "model": f"Mistral-7B width, {ROLL_LAYERS} of 32 layers",
        "batch": B, "T0": T0, "prompt_lens": list(ROLL_LENS),
        "new_tokens": ROLL_NEW, "window": mcfg.attn_window,
        "ring_slots": slots, "ring_writes": writes,
        "ring_cache_bytes": _cache_bytes(ring, B, slots),
        "full_cache_slots": full_slots,
        "full_cache_bytes": _cache_bytes(full, B, full_slots),
        "prefill_s": run["prefill_s"], "ring_generate_s": run["total_s"],
        "ring_decode_ms_per_step": run["decode_ms"],
        "ring_eager_decode_ms_per_step": run_e["decode_ms"],
        "tokens": int(out.size), "card": name_power,
    }
    say(f"[rolling] {json.dumps(res)}")
    return {"launches_norm": c["fused_norm"], "worst_gap": tf["worst_gap"]}


# ------------------------------------------------------- speculation legs
# [spec paged]: 8 greedy requests of SPEC_NEW tokens on Llama-3-8B; the
# even ones hold a repeated 64-token phrase (prompt lookup finds matches,
# as on code and documents); three of the prompts are long enough for B1
# in the teacher-forced check
SPEC_LENS = (300, 700, 200, 560, 260, 900, 160, 640)
SPEC_NEW = 8
SPEC_PHRASE = 64
SPEC_RUNS = (  # (tag, SpecConfig, the target as its own draft)
    ("ngram", SpecConfig(k=4, rounds=2), False),
    ("draft", SpecConfig(k=3, rounds=2), True),
    ("adaptive", SpecConfig.auto(k=4), True),
)
# [overload]: 4 requests whose budgets need 96 blocks of 16 from a pool
# of 88 (their prompts take 80), with mixed priorities; the first is long
# enough for B1 in the teacher-forced check
OVER_LENS = (480, 280, 260, 240)
OVER_PRIOS = (Priority.BATCH, Priority.STANDARD, Priority.INTERACTIVE,
              Priority.BATCH)
OVER_NEW = 64
OVER_BLOCKS = 88


def _spec_requests(vocab: int):
    r = np.random.default_rng(11)
    phrase = r.integers(0, vocab, (SPEC_PHRASE,))
    out = []
    for i, n in enumerate(SPEC_LENS):
        p = r.integers(0, vocab, (n,))
        if i % 2 == 0:
            # 16 tokens of its own, then the phrase over and over
            p[16:] = np.tile(phrase, -(-n // SPEC_PHRASE))[:n - 16]
        out.append(p)
    return out


def _check_spec_launches(tag: str, c: dict, by_variant: dict, sch, cfg, k: int,
                         draft_layers: int) -> None:
    """B3 once a target layer a prefill chunk (prefill variant), a verify
    pass (at T = K+1, on the variant ``kernel_variant`` names) and a plain
    decode step (decode variant), none on the general one; B4 once a draft
    layer a draft step and once a target layer a plain decode step (none
    in n-gram decode); no B1 or B2 in serving. The counts are the
    engine's own, so a run whose mode changed midway (self-healing) is
    held to the same rule."""
    layers = cfg.num_layers
    exp = dict.fromkeys(VARIANTS, 0)
    exp["prefill"] += layers * sch.prefill_chunks
    exp["decode"] += layers * sch.decode_steps
    if sch.verify_passes:
        vvar = kernel_variant(torch.bfloat16, torch.bfloat16, k + 1, cfg.num_heads,
                              cfg.num_kv_heads, cfg.dim // cfg.num_heads, 2048, False)
        exp[vvar] += layers * sch.verify_passes
    exp_norm = draft_layers * sch.draft_steps + layers * sch.decode_steps
    say(f"[{tag}] launches: paged_decode {c['paged_decode']} by variant "
        f"{by_variant} (expected {exp}); fused_norm {c['fused_norm']} "
        f"(expected {exp_norm}); flash {c['flash_fwd']} / {c['flash_bwd']}")
    check(by_variant == exp and c["paged_decode"] == sum(exp.values()) > 0,
          f"{tag}: paged-decode launches off the path")
    check(c["fused_norm"] == exp_norm, f"{tag}: fused-norm launches off the path")
    check(c["flash_fwd"] == c["flash_bwd"] == 0, f"{tag}: flash ran in serving")


def _check_replays(tag: str, st: dict) -> None:
    """One graph; every chunk but its first a replay."""
    g = st["graphs"]
    sp = st.get("spec")
    chunks = (st["decode_steps"] // 8 if sp is None
              else sp["verify_passes"] // sp["rounds"])
    _graph_line(tag, g)
    check(g["graphs"] == 1 and g["captured"] == 1 and g["replays"] == chunks - 1,
          f"{tag}: every chunk but the first must be a replay of one graph: {g}")


def _serve_spec(tag: str, model, prompts, spec_cfg, self_draft: bool,
                cuda_graphs: bool):
    """The requests through a fresh paged engine (speculative unless
    ``spec_cfg`` is None), launch counts set to 0 just before and read
    just after, checked against the path. -> (engine, request ids,
    outputs, wall s, counts)."""
    cfg = model.cfg
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = PagedContinuousBatchingEngine(
        eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=SPEC_NEW), cuda_graphs=cuda_graphs,
        draft=eng if self_draft else None, speculative=spec_cfg,
    )
    _zero_counts()
    t0 = time.perf_counter()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st = sch.stats()
    outs = [sch.result(rid) for rid in rids]
    check(all(len(o) == SPEC_NEW for o in outs), f"{tag}: a request did not finish")
    _check_spec_launches(tag, c, by_variant, sch, cfg, spec_cfg.k if spec_cfg else 0,
                         cfg.num_layers if self_draft else 0)
    if cuda_graphs:
        _check_replays(tag, st)
    return sch, rids, outs, wall, c


def _spec_line(tag: str, sch, rids, outs, plain_outs, wall: float, prof: dict,
               name_power: str) -> dict:
    sp = sch.stats()["spec"]
    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    same = None if plain_outs is None else sum(
        int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, plain_outs))
    res = {
        "mode": sp["mode"], "k": sp["k"], "rounds": sp["rounds"],
        "adaptive": sp["adaptive"], "k_mean": sp.get("k_mean"),
        "acceptance_rate": sp["acceptance_rate"],
        "tokens_per_weight_pass": sp["accepted_tokens_per_weight_pass"],
        "weight_passes": sp["weight_passes"], "verify_passes": sp["verify_passes"],
        "draft_steps": sp["draft_steps"], "idle_draft_steps": sp["idle_draft_steps"],
        "fallbacks": sp["fallback_total"],
        "spec_chunk_ms": prof["decode_step_s"] * 1e3 if prof else "not measured",
        "kernel_ms_per_chunk": prof["kernel_ms_per_step"] if prof else "not measured",
        "device_busy_share": prof["device_busy_share"] if prof else "not measured",
        "decode_tokens_per_s": (sch.decode_only_tokens / sch.decode_only_s
                                if sch.decode_only_s else None),
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_p50": float(np.median(ttft)),
        "ttft_s_max": float(np.max(ttft)), "wall_s": wall,
        "tokens_equal_to_nonspec": same, "tokens": sum(len(o) for o in outs),
        "card": name_power,
    }
    say(f"[{tag}] {json.dumps(res)}")
    return res


def _free_cuda() -> None:
    """Return what a dropped engine held (its pools, caches, graphs)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_spec_paged(name_power: str, model: Llama) -> dict:
    """Speculative decoding on the paged engine at Llama-3-8B: the
    non-spec run of the requests, then n-gram (k 4), the target as its
    own draft (k 3) and adaptive K (``SpecConfig.auto(k=4)``, the same
    draft), each captured, under the launch, replay and teacher-forced
    gates, and n-gram again eagerly under the same gates (the spec chunk
    body captured against eager); the self-draft must emit more than one
    token a weight pass, and adaptive K must keep one graph."""
    cfg = model.cfg
    prompts = _spec_requests(cfg.vocab_size)
    sch, _, plain_outs, _, _ = _serve_spec(
        "spec paged nonspec", model, prompts, None, False, True)
    del sch
    _free_cuda()
    launches = {"paged": 0, "norm": 0}
    for name, spec_cfg, self_draft in SPEC_RUNS:
        tag = f"spec paged {name}"
        sch, rids, outs, wall, c = _serve_spec(tag, model, prompts, spec_cfg,
                                               self_draft, True)
        launches["paged"] += c["paged_decode"]
        launches["norm"] += c["fused_norm"]
        tf = _teacher_forced(tag, model, prompts, outs)
        res = _spec_line(tag, sch, rids, outs, plain_outs, wall, None, name_power)
        if self_draft and not spec_cfg.adaptive:
            check(res["tokens_per_weight_pass"] > 1.0,
                  f"{tag}: the self-draft emitted no more than one token a pass")
        del sch
        _free_cuda()
        if self_draft:
            # the captured run holds the draft modes' gates; one eager
            # run (n-gram) holds the spec chunk body captured vs eager
            continue
        esch, erids, eouts, ewall, _ = _serve_spec(f"{tag} eager", model, prompts,
                                                   spec_cfg, self_draft, False)
        tf_e = _teacher_forced(f"{tag} eager", model, prompts, eouts)
        _agreement(tag, outs, eouts, tf, tf_e)
        _spec_line(f"{tag} eager", esch, erids, eouts, plain_outs, ewall, None, name_power)
        del esch
        _free_cuda()
    return launches


def phase_spec_contiguous(name_power: str) -> dict:
    """GPT-2-medium on the contiguous engine with n-gram speculation (k 4,
    2 rounds): the verify pass is per-row T = 5 through the plain
    attention, so no attention kernel runs and B4 never (no T == 1 step);
    the [contiguous] leg's 16 requests, captured then eager, with every
    token teacher-forced."""
    gcfg = GPT2Config.medium()
    model = GPT2(gcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    r = np.random.default_rng(7)
    prompts = [r.integers(0, gcfg.vocab_size, (n,)) for n in CONT_LENS]
    spec_cfg = SpecConfig(k=4, rounds=2)
    runs = {}
    for graphs in (True, False):
        tag = "spec contiguous" + ("" if graphs else " eager")
        eng = InferenceEngine(model, max_len=CONT_MAX_LEN, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV)
        sch = ContinuousBatchingEngine(
            eng, slots=8, decode_chunk=8, prefill_block=32,
            gen=GenerationConfig(max_new_tokens=CONT_NEW), cuda_graphs=graphs,
            speculative=spec_cfg,
        )
        _zero_counts()
        t0 = time.perf_counter()
        rids = [sch.submit(p) for p in prompts[:8]]
        sch.step()
        rids += [sch.submit(p) for p in prompts[8:]]
        sch.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        st = sch.stats()
        outs = [sch.result(rid) for rid in rids]
        check(all(len(o) == CONT_NEW for o in outs), f"{tag}: a request did not finish")
        say(f"[{tag}] launches: {json.dumps(c)}; expected none (verify passes "
            f"{st['spec']['verify_passes']})")
        check(c["fused_norm"] == c["paged_decode"] == c["flash_fwd"]
              == c["flash_bwd"] == 0 and st["spec"]["verify_passes"] > 0,
              f"{tag}: a kernel ran on the n-gram contiguous path")
        if graphs:
            _check_replays(tag, st)
        tf = _teacher_forced(tag, model, prompts, outs)
        _spec_line(tag, sch, rids, outs, None, wall, None, name_power)
        runs[graphs] = (outs, tf)
        del sch, eng
        _free_cuda()
    _agreement("spec contiguous", runs[True][0], runs[False][0], runs[True][1],
               runs[False][1])
    return {"worst_gap": runs[True][1]["worst_gap"]}


def _overload_run(tag: str, eng, prompts, cuda_graphs: bool, ref_outs):
    """Priority preemption under a pool too small for the budgets, then
    displacement, deadline refusal and a cancel with chunks in flight,
    on one paged engine."""
    gen = GenerationConfig(max_new_tokens=OVER_NEW)
    sch = PagedContinuousBatchingEngine(
        eng, slots=4, block_size=16, num_blocks=OVER_BLOCKS, prefill_chunk=128,
        decode_chunk=8, max_queue=2, pipeline_depth=2, gen=gen,
        cuda_graphs=cuda_graphs)
    # each preemption: (rid, its priority, the priorities it could have
    # been chosen from: every other running request but the one whose
    # block growth forced it)
    pre, protect = [], [None]
    inner_preempt, inner_alloc = sch._preempt, sch._alloc_with_preemption

    def alloc(n, slot):
        protect[0] = slot
        try:
            return inner_alloc(n, slot)
        finally:
            protect[0] = None

    def preempt(slot):
        req = sch._slot_req[slot]
        others = [int(r.priority) for s, r in enumerate(sch._slot_req)
                  if r is not None and s != protect[0]] or [int(req.priority)]
        pre.append((req.rid, int(req.priority), others))
        return inner_preempt(slot)

    sch._preempt, sch._alloc_with_preemption = preempt, alloc
    rids = [sch.submit(p, priority=q) for p, q in zip(prompts, OVER_PRIOS)]
    sch.run_until_idle()
    outs = [sch.result(rid) for rid in rids]
    say(f"[{tag}] preemptions (rid, priority, candidates' priorities): {pre}")
    check(pre and pre[0][1] == int(Priority.BATCH),
          f"{tag}: the first preemption must take a BATCH stream: {pre}")
    check(all(p == max(others) for _, p, others in pre),
          f"{tag}: a preemption passed over a less protected class: {pre}")
    same = [bool((np.asarray(o) == np.asarray(rf)).all())
            for o, rf in zip(outs, ref_outs)]
    preempted = sorted({rid for rid, _, _ in pre})
    # displacement: four fillers take the slots, two BATCH requests fill
    # the queue, an INTERACTIVE arrival displaces the newer one
    fill = [sch.submit(p, max_new=16) for p in prompts]
    qb = [sch.submit(p, max_new=16, priority="batch") for p in prompts[:2]]
    ri = sch.submit(prompts[2], max_new=16, priority="interactive")
    sch.run_until_idle()
    try:
        sch.result(qb[1])
        displaced = None
    except OverloadedError as e:
        displaced = (e.reason, e.retry_after_s)
    check(displaced is not None and displaced[0] == "displaced" and displaced[1] > 0,
          f"{tag}: the queued BATCH request was not displaced: {displaced}")
    check(all(len(sch.result(r)) == 16 for r in fill + [qb[0], ri]),
          f"{tag}: a request beside the displacement did not finish")
    # a deadline the measured TPOT cannot meet is refused at submit
    tpot = sch.stats()["admission"]["tpot_ewma_s"]
    try:
        sch.submit(prompts[0], max_new=OVER_NEW, deadline_s=1e-3)
        refused = False
    except DeadlineExceededError:
        refused = True
    check(refused, f"{tag}: an unmeetable deadline was admitted (TPOT {tpot})")
    # result(deadline_s=) cancels a running request with chunks in flight
    free0 = sch.pool.available
    rid = sch.submit(prompts[1], max_new=OVER_NEW)
    while sch.stats()["inflight_chunks"] < 2:
        sch.step()
    try:
        sch.result(rid, deadline_s=1e-6)
        cancelled = False
    except DeadlineExceededError:
        cancelled = True
    st = sch.stats()
    freed = {"cancelled": cancelled, "free_before": free0,
             "free_after": sch.pool.available, "busy_slots": st["busy_slots"],
             "inflight": st["inflight_chunks"]}
    check(cancelled and sch.pool.available == free0 and st["busy_slots"] == 0,
          f"{tag}: the cancelled request's blocks did not come back: {freed}")
    res = {"preempted_rids": preempted, "preemptions": len(pre),
           "streams_equal_to_unpressured": same, "displaced": displaced,
           "deadline_refused_with_tpot_s": tpot, "cancel": freed,
           "admission": st["admission"], "graphs": st["graphs"]}
    say(f"[{tag}] {json.dumps(res)}")
    return sch, outs, same


def phase_overload(name_power: str, model: Llama) -> dict:
    """Admission control on the paged Llama-3-8B engine: an unpressured
    run of 4 requests, then the same requests (BATCH, STANDARD,
    INTERACTIVE, BATCH) from a pool of OVER_BLOCKS blocks, captured and
    eager: BATCH is preempted first and INTERACTIVE never while a lower
    class runs; every stream passes the teacher-forced gate and equals
    the unpressured run; then displacement, deadline refusal and a
    cancel with chunks in flight."""
    cfg = model.cfg
    r = np.random.default_rng(13)
    prompts = [r.integers(0, cfg.vocab_size, (n,)) for n in OVER_LENS]
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    ref = PagedContinuousBatchingEngine(
        eng, slots=4, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=OVER_NEW))
    ref_outs = [ref.result(rid) for rid in [ref.submit(p) for p in prompts]]
    check(ref.preemptions == 0, "overload: the unpressured run preempted")
    del ref
    _free_cuda()
    same_all = []
    for graphs in (True, False):
        tag = "overload" + ("" if graphs else " eager")
        sch, outs, same = _overload_run(tag, eng, prompts, graphs, ref_outs)
        _teacher_forced(tag, model, prompts, outs)
        same_all.append(same)
        del sch
        _free_cuda()
    check(all(all(s) for s in same_all),
          f"overload: a preempted stream parted from the unpressured run: {same_all}")
    return {"streams_equal": same_all, "prompts": prompts, "ref_outs": ref_outs}

# --------------------- slice 9: warm start, int8, fused q/k/v, autopair,
# autotune, chaos, self-healing, the async API
KL_BOUND = 0.02  # nats: the reference bench's int8 quality bound
KL_REQUESTS = 4  # [slice] requests whose teacher-forced rows the KL reads
INT8_EAGER = 4  # requests of the short eager int8 comparison ...
INT8_EAGER_NEW = 16  # ... and their tokens
# what a burst holds beside its candidate: the target's and the draft's
# contiguous caches (2 slots x 2048 slots x 32 layers, 0.54 GB each), the
# sibling's materialised dequantize (up to its 1 GB bf16 head, held in a
# graph pool), graph pools and activations; a float copy of the model
# (16 GB) or a second sibling (7.5 GB) would not fit under it
AUTOPAIR_SLACK = 3 * 2**30
HEAL_DRAFT_LAYERS = 2
ASYNC_NEW = 16

_CACHE_CHILD = """
import json, time
t0 = time.perf_counter()
from tensorlink_tpu_torch import diag as tldiag
from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.runtime.compile_cache import compile_report, enable_compile_cache
d = enable_compile_cache()
t1 = time.perf_counter()
for src in %r:
    _build.load(src)
ok = native.have_native()
print(json.dumps({"dir": d, "nvcc_compiles": _build.nvcc_runs,
                  "gxx_compiles": native.gxx_runs, "native": ok,
                  "load_s": time.perf_counter() - t1,
                  "import_s": t1 - t0, "report": compile_report()}))
"""


def phase_compile_cache(name_power: str, build: dict) -> dict:
    """The kernel-build cache: ``phase_build`` compiled the CUDA sources
    into a fresh ``TL_COMPILE_CACHE_DIR``; the wire codec's g++ build
    lands there too. A child process on the same directory then loads
    every library with no compiler run (its key still asks
    ``nvcc --version`` once)."""
    d = compile_cache.active_dir()
    check(d is not None and d == os.environ.get(compile_cache.ENV_VAR),
          f"compile cache: not active on the fresh directory ({d})")
    t0 = time.perf_counter()
    ok = native.have_native()
    gxx_s = time.perf_counter() - t0
    check(ok and native.gxx_runs == 1 and not native.BUILD["compile_cache_hit"],
          "compile cache: the wire codec did not build into the fresh directory")
    entries = compile_cache.cache_entries(d)
    check(entries == len(CUDA_SOURCES) + 1,
          f"compile cache: {entries} libraries in {d}, expected {len(CUDA_SOURCES) + 1}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _CACHE_CHILD % (CUDA_SOURCES,)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ), cwd=os.path.dirname(os.path.abspath(__file__)))
    child_s = time.perf_counter() - t0
    check(res.returncode == 0, f"compile cache: the child failed: {res.stderr[-2000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    libs = child["report"]["libraries"]
    hits = all(r["compile_cache_hit"] for r in libs.values())
    out = {"cold_build_s": {"nvcc_parallel_wall": build["wall_s"],
                            **{k: v for k, v in build.items() if k != "wall_s"},
                            "gxx_wirecodec": gxx_s},
           "warm_load_s": child["load_s"], "child_process_s": child_s,
           "child_import_s": child["import_s"],
           "nvcc_compiles": child["nvcc_compiles"], "gxx_compiles": child["gxx_compiles"],
           "libraries_loaded": len(libs), "all_hits": hits,
           "cache_entries": entries, "card": name_power}
    say(f"[compile cache] {json.dumps(out)}")
    check(child["dir"] == d and child["native"] and len(libs) == len(CUDA_SOURCES) + 1
          and hits and child["nvcc_compiles"] == 0 and child["gxx_compiles"] == 0,
          f"compile cache: the warm process rebuilt or missed: {child}")
    return out


def _state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _dense_int8_bytes(model) -> int:
    """What an int8 sibling allocates: every quantized weight's q and s."""
    return sum(t.numel() * t.element_size() for n, t in model.state_dict().items()
               if n.endswith((".w.q", ".w.s")))


def _kl_rows(model, model_q, prompts, outs) -> float:
    """Mean KL (nats) of ``model_q``'s next-token distribution from
    ``model``'s over the teacher-forced rows of the emitted tokens."""
    kls = []
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = torch.from_numpy(np.concatenate([p, o[:-1]])).to(DEV)[None]
            rows = slice(len(p) - 1, ids.shape[1])
            lp = torch.log_softmax(model.head(model(ids, logits=False)[0, rows]).float(), -1)
            lq = torch.log_softmax(model_q.head(model_q(ids, logits=False)[0, rows]).float(), -1)
            kls.append((lp.exp() * (lp - lq)).sum(-1))
    return float(torch.cat(kls).mean())


def _serve_short(tag: str, eng, prompts, max_new: int, cuda_graphs: bool, **kw):
    """``prompts`` through a fresh [slice]-shaped engine over ``eng``,
    launch counts from 0. -> (engine, outputs, counts, B3 by variant)."""
    sch = _slice_engine(eng.model, max_new, cuda_graphs, eng=eng, **kw)
    _zero_counts()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    outs = [sch.result(r) for r in rids]
    check(all(len(o) == max_new for o in outs), f"{tag}: a request did not finish")
    return sch, outs, c, by_variant


def phase_int8(name_power: str, model: Llama, prompts, slice_outs, slice_prof: dict,
               cap: dict) -> dict:
    """Weight-only int8 at Llama-3-8B: the int8 sibling
    (``default_draft_candidates``: a meta-built model into which the bf16
    weights are quantized one ``Dense`` at a time, every other tensor
    shared) behind ``InferenceEngine(quantize="int8")``, serving the
    [slice] requests captured, then a short eager comparison. Gates: B3
    and B4 launches on the path, every token teacher-forced against the
    int8 model, and the mean KL of int8 against bf16 logits on
    teacher-forced rows under 0.02 nats."""
    cfg = model.cfg
    base = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, device=DEV)
    t0 = time.perf_counter()
    (_, make_sibling), = default_draft_candidates(base)
    eng8 = make_sibling()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    model8 = eng8.model
    sizes = {"state_bytes_int8": _state_bytes(model8), "state_bytes_bf16": _state_bytes(model),
             "weight_pass_bytes_int8": eng8.weight_bytes,
             "weight_pass_bytes_bf16": base.weight_bytes,
             "int8_dense_bytes": _dense_int8_bytes(model8), "quantize_s": quant_s,
             "card": name_power}
    say(f"[int8] weights: {json.dumps(sizes)}")
    check(eng8.quantize == "int8"
          and sizes["weight_pass_bytes_int8"] < 0.6 * sizes["weight_pass_bytes_bf16"],
          "int8: the sibling is not quantized")
    sch, rids, outs, wall, k = _serve_paged(model8, prompts, 32, True, cap, eng=eng8,
                                            tag="int8")
    _graph_line("int8", sch.stats()["graphs"])
    tf = _teacher_forced("int8", model8, prompts, outs)
    kl = _kl_rows(model, model8, prompts[:KL_REQUESTS], slice_outs[:KL_REQUESTS])
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, slice_outs))
    dt = _timer_line("int8", sch, name_power)
    prof = _profile_decode(sch, cfg.vocab_size, name_power, tag="int8 profile")
    elem8, elem = prof["elementwise_ms_per_model_step"], slice_prof["elementwise_ms_per_model_step"]
    k8 = prof["kernel_ms_per_model_step"]
    dequant = ((elem8 - elem) / k8 if isinstance(k8, float) and isinstance(elem, float)
               else "not measured")
    res = {"kl_nats_mean": kl, "kl_bound": KL_BOUND,
           "tokens_equal_to_slice": same, "tokens": tf["tokens"],
           "model_step_ms": prof["model_step_ms"],
           "slice_model_step_ms": slice_prof["model_step_ms"],
           "kernel_ms_per_model_step": k8, "device_busy_share": prof["device_busy_share"],
           "dequantize_share_of_step_kernels": dequant,
           "decode_mbu": dt["programs"].get("decode", {}).get("mbu", "not measured"),
           "decode_mfu": dt["programs"].get("decode", {}).get("mfu", "not measured"),
           "wall_s": wall, "card": name_power}
    say(f"[int8] {json.dumps(res)}")
    check(kl < KL_BOUND, f"int8: mean KL {kl} nats is over the {KL_BOUND} bound")
    del sch
    _free_cuda()
    esch, eouts, ec, ebv = _serve_short("int8 eager", eng8, prompts[:INT8_EAGER],
                                        INT8_EAGER_NEW, False)
    _check_paged_launches("int8 eager", esch.stats(), ec["paged_decode"], ec["fused_norm"],
                          ebv, cfg.num_layers)
    tf_e = _teacher_forced("int8 eager", model8, prompts[:INT8_EAGER], eouts)
    _agreement("int8", [o[:INT8_EAGER_NEW] for o in outs[:INT8_EAGER]], eouts, tf, tf_e)
    del esch, eng8, model8, make_sibling, base
    _free_cuda()
    return {"paged": k["paged"], "norm": k["norm"],
            "int8_dense_bytes": sizes["int8_dense_bytes"]}


def _fused_llama(model: Llama) -> Llama:
    """``model``'s function in the fused q/k/v layout: each layer's q, k
    and v weights go through ``fuse_qkv_params`` into one ``qkv`` weight
    (the only new memory), every other tensor is ``model``'s own."""
    cfg = dataclasses.replace(model.cfg, qkv_fused=True)
    H, G = cfg.num_heads, cfg.num_kv_heads
    src = model.state_dict()
    state = {n: t for n, t in src.items()
             if not any(f".attn.{x}." in n for x in "qkv")}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}.attn."
        attn = {x: {"w": src[f"{pre}{x}.w"]} for x in "qkvo"}
        state[pre + "qkv.w"] = fuse_qkv_params(attn, H, G, cfg.dim // H)["qkv"]["w"]
    fused = Llama(cfg, device="meta", seed=None)
    fused.load_state_dict(state, strict=True, assign=True)
    return fused


def phase_fused(name_power: str, model: Llama, prompts, slice_outs, cap: dict) -> dict:
    """The [slice] requests on a ``qkv_fused=True`` Llama-3-8B made from
    the same weights through ``fuse_qkv_params``, captured: launch and
    replay gates, every token teacher-forced against the unfused model
    (bitwise equality is not expected: the GEMM's shape changes)."""
    fused = _fused_llama(model)
    eng = InferenceEngine(fused, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch, rids, outs, wall, k = _serve_paged(fused, prompts, 32, True, cap, eng=eng,
                                            tag="fused qkv")
    _graph_line("fused qkv", sch.stats()["graphs"])
    tf = _teacher_forced("fused qkv", model, prompts, outs)
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, slice_outs))
    res = {"tokens_equal_to_slice": same, "tokens": tf["tokens"],
           "worst_gap_vs_unfused": tf["worst_gap"], "wall_s": wall, "card": name_power}
    say(f"[fused qkv] {json.dumps(res)}")
    del sch, eng, fused
    _free_cuda()
    return {"paged": k["paged"], "norm": k["norm"]}


def phase_autopair(name_power: str, model: Llama, sibling_bytes: int) -> dict:
    """``autopair_draft`` on the bf16 target with the default candidate
    (its int8 sibling): non-spec, the sibling as draft, then n-gram, each
    a captured burst on a contiguous engine. Gate: the memory allocated
    at the burst's peak stays under the target plus one sibling (plus
    AUTOPAIR_SLACK for the burst engines' caches and graph pools)."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    _free_cuda()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    v = autopair_draft(eng, GenerationConfig())
    torch.cuda.synchronize()
    c = _counts()
    peak = torch.cuda.max_memory_allocated()
    res = {"verdict": v["mode"], "name": v["name"], "tokens_per_s": v["measured"],
           "baseline_tokens_per_s": v["baseline_tokens_per_sec"],
           "calibration_s": v["calibration_s"], "skipped": v["skipped"],
           "peak_above_target_bytes": peak - base, "sibling_bytes": sibling_bytes,
           "bound_bytes": sibling_bytes + AUTOPAIR_SLACK, "launches": c,
           "card": name_power}
    say(f"[autopair] {json.dumps(res)}")
    check(peak - base < sibling_bytes + AUTOPAIR_SLACK,
          f"autopair: {peak - base} bytes above the target at peak: more than one sibling")
    check(set(v["measured"]) >= {"nonspec", "int8-sibling"} and c["fused_norm"] > 0,
          f"autopair: a mode was not measured or no decode ran: {v['measured']} {c}")
    persist = v["persistable"]
    del v, eng
    _free_cuda()
    return {"persistable": persist, "norm": c["fused_norm"], "paged": c["paged_decode"]}


def phase_autotune(name_power: str, model: Llama, persistable: dict) -> dict:
    """The autotune store in a temporary directory: an adaptive n-gram
    engine serves four requests and saves (with the autopair verdict as
    ``draft_pair``); a second engine on the directory warm-starts with
    that record and K prior; ``measure_capability(store=, key=)`` measures
    once and loads the record the second time."""
    d = tempfile.mkdtemp(prefix="autotune-", dir=os.path.join(_build.PKG_DIR, "_build"))
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    spec = SpecConfig(k=4, rounds=2, adaptive=True)
    prompts = _spec_requests(model.cfg.vocab_size)[:4]
    sch = _slice_engine(model, 16, eng=eng, speculative=spec, autotune_dir=d)
    check(sch.autotune_warm_start_s is None, "autotune: a fresh directory warm-started")
    for r in [sch.submit(p) for p in prompts]:
        sch.result(r)
    path = sch.save_autotune(draft_pair=persistable)
    blob = open(path, "rb").read()
    rec = json.loads(blob)
    del sch
    _free_cuda()
    sch2 = _slice_engine(model, 16, eng=eng, speculative=spec, autotune_dir=d)
    prior2 = sch2._kctl.prior()
    warm_s = sch2.autotune_warm_start_s
    same_file = open(path, "rb").read() == blob
    check(sch2.autotune_warm_start_s is not None and sch2._autotune_record == rec
          and prior2 == rec["k_prior"] and rec["draft_pair"] == persistable and same_file,
          f"autotune: the warm start did not read what was saved: {rec} {prior2}")
    del sch2, eng
    _free_cuda()
    store = AutotuneStore.resolve(d)
    key = store_key(GLOBAL_MODEL, ())
    t0 = time.perf_counter()
    c1 = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB, reps=CAP_REPS,
                            store=store, key=key)
    t1 = time.perf_counter()
    c2 = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB, reps=CAP_REPS,
                            store=store, key=key)
    t2 = time.perf_counter()
    res = {"autotune_warm_start_s": warm_s,
           "k_prior": rec["k_prior"], "draft_pair": rec["draft_pair"],
           "record_keys": sorted(rec), "capability_first_s": t1 - t0,
           "capability_second_s": t2 - t1, "second_cached": bool(c2.get("cached")),
           "card": name_power}
    say(f"[autotune] {json.dumps(res)}")
    check(not c1.get("cached") and c2.get("cached")
          and c2["peak_tflops"] == c1["peak_tflops"] and c2["hbm_gbps"] == c1["hbm_gbps"],
          "autotune: the second capability call measured again")
    return res


CHAOS_PLAN = (ChaosPlan(seed=0)
              .fault("serving.dispatch", "slow", every=4, delay_s=0.002, jitter_s=0.002)
              .fault("serving.drain", "slow", at=5, delay_s=0.25))


def phase_chaos(name_power: str, model: Llama, over: dict) -> dict:
    """The [overload] script twice under a plan that slows every 4th
    dispatch (2-4 ms, seeded jitter) and stalls the 5th drain 250 ms.
    Gates: every completed stream equals the unfaulted run's token for
    token (a stall changes timing, not shapes), every INTERACTIVE request
    completes (``_overload_run``'s own gates), and the two runs' harness
    logs are equal. Prints what the disarmed hooks cost a chunk."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    logs, counts = [], {"paged": 0, "norm": 0}
    for run in range(2):
        h = chaos.arm(CHAOS_PLAN)
        _zero_counts()
        try:
            sch, outs, same = _overload_run(f"chaos run {run}", eng, over["prompts"], True,
                                            over["ref_outs"])
        finally:
            chaos.disarm()
        c = _counts()
        counts["paged"] += c["paged_decode"]
        counts["norm"] += c["fused_norm"]
        logs.append(list(h.log))
        check(all(same), f"chaos run {run}: a stream parted from the unfaulted run: {same}")
        interactive = [i for i, q in enumerate(OVER_PRIOS) if q == Priority.INTERACTIVE]
        check(all(len(outs[i]) == OVER_NEW for i in interactive),
              f"chaos run {run}: an INTERACTIVE request did not complete")
        del sch
        _free_cuda()
    n = 1_000_000
    t0 = time.perf_counter()
    for _ in range(n):
        if chaos.ACTIVE is not None:
            pass
    guard_ns = (time.perf_counter() - t0) / n * 1e9
    res = {"faults_fired": len(logs[0]), "log_head": logs[0][:6],
           "logs_equal": logs[0] == logs[1],
           "disarmed_guard_ns": guard_ns, "disarmed_cost_ns_per_chunk": 2 * guard_ns,
           "card": name_power}
    say(f"[chaos] {json.dumps(res)}")
    check(logs[0] == logs[1] and logs[0], "chaos: two runs of one plan logged differently")
    del eng
    _free_cuda()
    return counts


def phase_self_heal(name_power: str, model: Llama, prompts, slice_outs) -> dict:
    """Llama-3-8B paged with a same-vocabulary 2-layer random-weight draft
    and ``SpecConfig(k=3, self_heal_accept=0.3)``: four [slice] requests
    in draft mode (near-zero acceptance), after which the engine
    downgrades itself at the idle point; four more in the new mode.
    Gates: the downgrade, its graph dropped and one captured for the new
    mode, launches on the path, and every token before and after
    teacher-forced (the verify pass runs B3 at T = K+1, whose bf16
    rounding differs from T = 1, so tokens equal to [slice]'s are printed,
    not gated)."""
    cfg = model.cfg
    dmodel = Llama(dataclasses.replace(cfg, num_layers=HEAL_DRAFT_LAYERS), device=DEV,
                   dtype=torch.bfloat16, seed=1)
    deng = InferenceEngine(dmodel, max_len=2048, cache_dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, device=DEV)
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = _slice_engine(model, 32, eng=eng, draft=deng,
                        speculative=SpecConfig(k=3, self_heal_accept=0.3))
    _zero_counts()
    pre, post = prompts[:4], prompts[4:8]
    outs1 = [sch.result(r) for r in [sch.submit(p) for p in pre]]
    sch.run_until_idle()
    st1 = sch.stats()
    healed = st1.get("spec_self_healed")
    outs2 = [sch.result(r) for r in [sch.submit(p) for p in post]]
    sch.run_until_idle()
    torch.cuda.synchronize()
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st2 = sch.stats()
    g1, g2 = st1["graphs"], st2["graphs"]
    res = {"healed": healed, "heals": st2.get("spec_self_heal_total", 0),
           "mode_after": st2["spec"]["mode"] if "spec" in st2 else "nonspec",
           "graphs_before": g1, "graphs_after": g2,
           "verify_passes": sch.verify_passes, "draft_steps": sch.draft_steps,
           "decode_steps": sch.decode_steps,
           "tokens_equal_to_slice": sum(int((np.asarray(a) == np.asarray(b)).sum())
                                        for a, b in zip(outs1 + outs2, slice_outs[:8])),
           "tokens": sum(len(o) for o in outs1 + outs2), "card": name_power}
    say(f"[self-heal] {json.dumps(res)}")
    check(healed is not None and healed["from"] == "draft" and healed["acceptance"] < 0.3,
          f"self-heal: the engine did not downgrade itself: {healed}")
    check(g1["cleared"] == 1 and g1["graphs"] == 0 and g2["captured"] >= 2,
          f"self-heal: graphs not dropped and re-captured: {g1} {g2}")
    _check_spec_launches("self-heal", c, by_variant, sch, cfg, 3, HEAL_DRAFT_LAYERS)
    _teacher_forced("self-heal before", model, pre, outs1)
    _teacher_forced("self-heal after", model, post, outs2)
    del sch, eng, deng, dmodel
    _free_cuda()
    return {"paged": c["paged_decode"], "norm": c["fused_norm"]}


def phase_async(name_power: str, model: Llama, prompts) -> dict:
    """Eight requests through ``asubmit``/``aresult`` from one event loop,
    two ``aresult`` calls at a time (pump threads take turns on the
    scheduler lock, and a graph capture never overlaps another thread's
    launches), against ``submit``/``result`` on a twin engine."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    ps = prompts[:8]
    ref_sch, ref, _, _ = _serve_short("async reference", eng, ps, ASYNC_NEW, True)
    del ref_sch
    _free_cuda()
    sch = _slice_engine(model, ASYNC_NEW, eng=eng)
    _zero_counts()

    async def run():
        rids = [await sch.asubmit(p) for p in ps]
        outs = []
        for i in range(0, len(rids), 2):
            outs += await asyncio.gather(sch.aresult(rids[i]), sch.aresult(rids[i + 1]))
        return outs

    t0 = time.perf_counter()
    outs = asyncio.run(run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st = sch.stats()
    equal = [bool((np.asarray(a) == np.asarray(b)).all()) for a, b in zip(outs, ref)]
    say(f"[async] {json.dumps({'requests': len(ps), 'equal_to_sync': equal, 'wall_s': wall, 'graphs': st['graphs'], 'card': name_power})}")
    _check_paged_launches("async", st, c["paged_decode"], c["fused_norm"], by_variant,
                          model.cfg.num_layers)
    check(all(equal), f"async: tokens differ from submit/result: {equal}")
    del sch, eng
    _free_cuda()
    return {"paged": c["paged_decode"], "norm": c["fused_norm"]}


# ------------------------------------------------ Mixtral (MoE) serving
# [mixtral paged]: Mixtral-8x7B at full width, depth cut to MIX_LAYERS
# of 32 (its bf16 experts alone are 90.2 GB at full depth, and the
# reference quantizes no expert; 4 layers keep the run
# in its time),
# random bf16 weights from seed 0.
# ------------------------------------------------------ serving on a mesh
MESH_REQUESTS = 4  # [slice]'s first requests: the mesh legs' prompts
MESH_NEW = 16
TP2_WORLD = 2
# the [tp2 *] legs' model: Llama-3-8B's width at an eighth of its depth
# (cut to pay for the [ep2 *] legs in the same job, the [roles train] and
# [pipeserve] legs, then the zoo's legs)
TP2_LAYERS = 4
TP2_STATIC_ROWS = 2  # [tp2 static]: the first two prompts, left-padded
TP2_PROFILE_STEP = 8  # [tp2 static]: decode steps 6..7 plain, 8..9 profiled


def _serve_all(sch, prompts) -> list:
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    return [np.asarray(sch.result(rid)) for rid in rids]


def phase_mesh_paged(name_power: str, model: Llama, prompts) -> dict:
    """[mesh paged]: the paged engine of the [slice] geometry over
    ``InferenceEngine(model, mesh=make_mesh(MeshConfig()))`` (one NCCL
    rank, full depth, captured) on [slice]'s first 4 requests, 16 tokens
    each: tokens identical to a no-mesh engine's in this call, one graph
    with every chunk but its first a replay, B3 and B4 launches as
    ``_check_paged_launches`` implies, and no collective (a size-1 group
    skips them). The process group is destroyed after, failed or not.
    -> the launches."""
    prompts = prompts[:MESH_REQUESTS]
    plain = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                            param_dtype=torch.bfloat16, device=DEV)
    ref = _serve_short("mesh paged, no mesh", plain, prompts, MESH_NEW, True)[1]
    del plain
    _free_cuda()
    mesh = make_mesh(MeshConfig())
    try:
        eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV, mesh=mesh)
        t0 = time.perf_counter()
        sch, outs, c, by_variant = _serve_short("mesh paged", eng, prompts, MESH_NEW, True)
        wall = time.perf_counter() - t0
        st = sch.stats()
        _check_paged_launches("mesh paged", st, c["paged_decode"], c["fused_norm"],
                              by_variant, model.cfg.num_layers)
        g = st["graphs"]
        _graph_line("mesh paged", g)
        check(g["graphs"] == 1 and g["captured"] == 1
              and g["replays"] == st["decode_steps"] // 8 - 1,
              f"mesh paged: every chunk but the first must be a replay of one graph: {g}")
        equal = all(np.array_equal(a, b) for a, b in zip(outs, ref))
        res = {"requests": len(prompts), "tokens": sum(len(o) for o in outs),
               "tokens_identical_to_no_mesh": equal, "collectives": c["collectives"],
               "groups": {a: eng.mesh_sizes()[a] for a in ("data", "model")},
               "backend": str(torch.distributed.get_backend(eng.model_group)),
               "wall_s": wall, "decode_steps": st["decode_steps"],
               "prefill_chunks": st["prefill_chunks"], "card": name_power}
        say(f"[mesh paged] {json.dumps(res)}")
        check(equal, "mesh paged: tokens differ from the no-mesh engine's")
        check(c["collectives"] == 0, "mesh paged: a size-1 group issued a collective")
        del sch, eng
    finally:
        shutdown_distributed()
    _free_cuda()
    return {"paged": c["paged_decode"], "norm": c["fused_norm"]}


def _tp2_leg(tag: str, rank: int, fn, calls, L: int) -> tuple:
    """Run one [tp2 *] leg on this rank with its counts set to 0 just
    before and read just after; ``calls()`` -> the model calls it made.
    Each takes logits (the paged engine takes a prefill chunk's at every
    chunk), so each issues 2 x ``L`` all-reduces (attention's ``o`` and
    the MLP's ``down``, or a MoE layer's summed partial combines) and
    the head's gather."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    n = calls()
    want = (2 * L + 1) * n
    if rank == 0:
        say(f"[{tag}] rank 0 launches {json.dumps(c)}; collectives expected {want} "
            f"({n} model calls, 2 x {L} + 1 each); wall {wall:.2f} s")
    check(c["collectives"] == want, f"{tag}: rank {rank} issued {c['collectives']} "
          f"collectives, the model implies {want}")
    check(c["flash_fwd"] == c["flash_bwd"] == 0, f"{tag}: flash ran in serving")
    return out, c, wall


def _tp2_rank(rank: int, world: int, store: str, prompts, s_ids, s_pad,
              out_dir: str, name_power: str) -> None:
    """One rank of the [tp2 *] job: a gloo group of two ranks on cuda:0,
    Llama-3-8B at full width and depth, first whole on every rank for
    [sp2 static], then cut to this rank's blocks by
    ``InferenceEngine(mesh=)``, served eagerly through the paged and
    contiguous engines ([tp2 disagg] after the paged leg) and
    ``generate``; every gate raises in the rank that fails. Rank 0
    prints; the other ranks' output goes nowhere (errors still reach
    stderr)."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.cuda.set_device(0)
    initialize_distributed(DistributedConfig(coordinator=f"file://{store}",
                                             num_processes=world, process_id=rank),
                           device="cpu")
    try:
        mesh = make_mesh(MeshConfig(model=world), device="cpu")
        cfg = _tp2_config()
        L = cfg.num_layers
        gen = GenerationConfig(max_new_tokens=MESH_NEW)
        model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
        sp2 = _sp2_static(rank, world, model, s_ids, s_pad, gen)
        whole = weight_pass_bytes(model)
        eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV,
                              mesh=mesh, cuda_graphs=False)
        _free_cuda()
        if rank == 0:
            say(f"[tp2] Llama-3-8B over a gloo group of {world} ranks on cuda:0: "
                f"rank 0 holds {eng.weight_bytes} weight bytes a pass (whole model "
                f"{whole}, half of it {whole // world}); q block "
                f"{tuple(model.blocks.blocks()[0].attn.q.w.shape)}, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by rank 0")
        res = {"weight_bytes": eng.weight_bytes, "whole_bytes": whole, "sp2_static": sp2}

        sch = PagedContinuousBatchingEngine(
            eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8, gen=gen,
            cuda_graphs=False)
        outs, c, wall = _tp2_leg(
            "tp2 paged", rank, lambda: _serve_all(sch, prompts),
            lambda: sch.prefill_chunks + sch.decode_steps, L)
        by_variant = dict(paged_decode_attention.launches_by_variant)
        st = sch.stats()
        _check_paged_launches("tp2 paged", st, c["paged_decode"], c["fused_norm"],
                              by_variant, L)
        pool = tuple(sch._pools[0]["k"].shape)
        check(pool[2] == cfg.num_kv_heads // world, f"tp2 paged: pools of {pool}")
        res["paged"] = {"outs": outs, "wall": wall, "launches": c, "pool": pool,
                        "decode_steps": st["decode_steps"],
                        "prefill_chunks": st["prefill_chunks"]}
        del sch
        _free_cuda()
        res["disagg"] = _tp2_disagg(rank, world, eng, prompts, gen, outs, out_dir)

        sch = ContinuousBatchingEngine(eng, slots=MESH_REQUESTS, decode_chunk=8,
                                       gen=gen, cuda_graphs=False)
        outs, c, wall = _tp2_leg(
            "tp2 contiguous", rank, lambda: _serve_all(sch, prompts),
            lambda: len(prompts) + sch.decode_steps, L)
        _check_decode_launches("tp2 contiguous", c, L * sch.decode_steps, "rms")
        res["contiguous"] = {"outs": outs, "wall": wall, "launches": c,
                             "cache": tuple(sch._kv[0][0].shape),
                             "decode_steps": sch.decode_steps,
                             "prefill_chunks": sch.prefill_chunks}
        del sch
        _free_cuda()

        def static():
            if rank == 0:  # the profiler on one rank only
                return _generate_traced("tp2 static", eng, s_ids, s_pad, MESH_NEW,
                                        TP2_PROFILE_STEP, name_power, active=2)
            return {"out": eng.generate(s_ids, gen, pad_mask=s_pad), "prefill_s": None,
                    "decode_ms": None, "profile": None}

        out, c, wall = _tp2_leg("tp2 static", rank, static, lambda: MESH_NEW, L)
        _check_decode_launches("tp2 static", c, L * (MESH_NEW - 1), "rms")
        res["static"] = {"outs": list(out["out"]), "wall": wall, "launches": c,
                         "prefill_s": out["prefill_s"], "decode_ms": out["decode_ms"],
                         "profile": out["profile"]}
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del eng, model
        _free_cuda()
        res["ep2_paged"] = _ep2_paged(rank, world, mesh, gen)
        res["ep2_train"] = _ep2_train(rank, world, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


TP2_DISAGG_REQUESTS = 2  # [tp2 disagg]: [slice]'s first two requests


def _tp2_disagg(rank: int, world: int, eng, prompts, gen, colocated, out_dir: str) -> dict:
    """[tp2 disagg] on this rank: [slice]'s first TP2_DISAGG_REQUESTS
    requests' prefill exported by a TP-2 paged engine (the blocks
    all-gathered to the global KV heads: the same payload on every rank)
    and imported into another TP-2 paged engine, eager: its tokens must
    equal [tp2 paged]'s (``colocated``), and its decode leg must launch
    B3 on the decode variant only (H 16 / Hkv 4 a rank), 32 a decode
    step, and B4 32 a decode step. Rank 0 saves the payloads for the
    parent's one-rank engine."""
    cfg = eng.model.cfg
    L = cfg.num_layers
    kw = dict(slots=8, block_size=16, prefill_chunk=128, decode_chunk=8, gen=gen,
              cuda_graphs=False)
    P = PagedContinuousBatchingEngine(eng, **kw)
    t0 = time.perf_counter()
    payloads = [P.prefill_export(p) for p in prompts[:TP2_DISAGG_REQUESTS]]
    export_s = time.perf_counter() - t0
    del P
    _free_cuda()
    D = PagedContinuousBatchingEngine(eng, **kw)
    _zero_counts()
    t0 = time.perf_counter()
    rids = [D.import_prefill(pl) for pl in payloads]
    D.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    outs = [np.asarray(D.result(rid)) for rid in rids]
    steps = D.stats()["decode_steps"]
    heads = tuple(payloads[0]["layers"][0]["k"].shape)
    attn = eng.model.blocks.blocks()[0].attn
    q_heads = attn.q.w.shape[1] // attn.head_dim
    pool = tuple(D._pools[0]["k"].shape)
    res = {"export_s": export_s, "import_decode_wall_s": wall, "payload_k_block": heads,
           "pool": pool, "decode_steps": steps, "launches": c, "by_variant": by_variant}
    if rank == 0:
        say(f"[tp2 disagg] rank 0: {json.dumps(res)}")
        torch.save(payloads, os.path.join(out_dir, "disagg.pt"))
    check(heads[2] == cfg.num_kv_heads and pool[2] == cfg.num_kv_heads // world
          and q_heads == cfg.num_heads // world,
          f"tp2 disagg: payload blocks {heads} (want every KV head), pools {pool}, "
          f"{q_heads} query heads a rank")
    check(all(np.array_equal(a, b) for a, b in zip(outs, colocated)),
          "tp2 disagg: the imported requests' tokens differ from [tp2 paged]'s")
    check(c["paged_decode"] == by_variant["decode"] == L * steps > 0
          and by_variant["prefill"] == by_variant["general"] == 0,
          f"tp2 disagg: B3 launches {by_variant}, expected {L} x {steps} on the decode "
          "variant and no prefill chunk")
    check(c["fused_norm"] == L * steps, f"tp2 disagg: B4 launches {c['fused_norm']}")
    del D, payloads
    _free_cuda()
    return {"outs": outs, "q_heads": q_heads, **res}


def _sp2_static(rank: int, world: int, model, s_ids, s_pad, gen) -> dict:
    """[sp2 static] on this rank: the whole Llama-3-8B through
    ``InferenceEngine(kv_seq_shard=True)`` on a seq mesh of the same gloo
    group, eager: [tp2 static]'s prompts, B4 32 a decode step and no
    other kernel, this rank's cache at 1 / world of the world-1 cache of
    the same plan. The model is left whole."""
    seq_mesh = make_mesh(MeshConfig(seq=world), device="cpu")
    L = model.cfg.num_layers
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV, mesh=seq_mesh,
                          kv_seq_shard=True, cuda_graphs=False)
    stamps = {}

    def hook(i):  # before decode step i: steps 4 .. MESH_NEW - 2 are timed
        torch.cuda.synchronize()
        stamps[i] = time.perf_counter()

    eng.step_hook = hook
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(s_ids, gen, pad_mask=s_pad)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    _check_decode_launches("sp2 static", c, L * (MESH_NEW - 1), "rms")
    decode_ms = (stamps[MESH_NEW - 1] - stamps[4]) / (MESH_NEW - 5) * 1e3
    st = eng._gen_state
    B, slots = st["valid"].shape
    cache = sum(t.numel() * t.element_size() for c_ in st["caches"]
                for t in (c_["attn"]["k"], c_["attn"]["v"]))
    whole = _cache_bytes(eng, B, slots)
    res = {"wall_s": wall, "decode_ms": decode_ms, "cache_bytes": cache,
           "world1_cache_bytes": whole, "slots": slots, "launches": c,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        say(f"[sp2 static] rank 0: {json.dumps(res)}")
    check(cache * world == whole, f"sp2 static: rank {rank} holds {cache} cache bytes, "
          f"the world-1 cache {whole}")
    del eng
    _free_cuda()
    return {"outs": list(out), **res}


# [ep2 mixtral train]: Mixtral-8x7B's width at 2 layers, SGD (f32
# masters and gradients of two ranks' halves fit one card beside the
# parent's world-1 run), batch 4 x 512 in 2 micros, 3 steps
EP_TRAIN_LAYERS = 2
EP_TRAIN_BATCH = (4, 512)
EP_TRAIN_MICRO = 2
EP_TRAIN_STEPS = 3
EP_TRAIN_LR = 1e-2
EP_TRAIN_AUX = 0.01
EP_LOSS_REL = 1e-3  # the first loss against world 1's, relative


def _one_at_a_time(rank: int, world: int, build):
    """``build()`` on each rank in turn, a barrier between: only one
    whole model is on the card while a rank cuts its blocks from it."""
    out = None
    for r in range(world):
        if r == rank:
            out = build()
            _free_cuda()
        torch.distributed.barrier()
    return out


def _expert_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for blk in model.blocks.blocks()
               for t in (blk.mlp.up, blk.mlp.gate, blk.mlp.down))


def _ep2_paged(rank: int, world: int, mesh, gen) -> dict:
    """[ep2 mixtral paged] on this rank: [mixtral paged]'s model
    (Mixtral-8x7B at full width, MIX_LAYERS layers, seed 0) cut by
    ``InferenceEngine(mesh=)`` to 4 of the 8 experts and half of the
    heads a rank, [mixtral paged]'s first 4 requests through the paged
    engine,
    eager: the MoE layers in their fallback form (every rank routes
    every token, one all-reduce of the partial combines a layer, no
    all_to_all), 2 x layers + 1 collectives a model call, B3 and B4 on
    the path, this rank's expert bytes half of the whole model's. Then
    each request's same-T replay alone on a one-row paged cache through
    this rank's blocks, its routing recorded: every token within
    LOGIT_GAP_TOL of it. The parent replays the world-1 model with that
    routing pinned, in [mixtral paged]."""
    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(), num_layers=MIX_LAYERS)
    L = cfg.num_layers
    prompts = _requests(cfg.vocab_size)[:MESH_REQUESTS]

    def build():
        model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
        whole = _expert_bytes(model)
        return InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16, device=DEV, mesh=mesh,
                               cuda_graphs=False), whole

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, whole = _one_at_a_time(rank, world, build)
    build_s = time.perf_counter() - t0
    sch = PagedContinuousBatchingEngine(
        eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8, gen=gen,
        cuda_graphs=False)
    rids = []

    def serve():
        rids.extend(sch.submit(p) for p in prompts)
        sch.run_until_idle()
        torch.cuda.synchronize()
        return [np.asarray(sch.result(rid)) for rid in rids]

    outs, c, wall = _tp2_leg("ep2 mixtral paged", rank, serve,
                             lambda: sch.prefill_chunks + sch.decode_steps, L)
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st = sch.stats()
    _check_paged_launches("ep2 mixtral paged", st, c["paged_decode"], c["fused_norm"],
                          by_variant, L)
    _check_chunk_starts("ep2 mixtral paged", sch, rids, prompts)
    mine = _expert_bytes(eng.model)
    mlp = eng.model.blocks.blocks()[0].mlp
    pool = tuple(sch._pools[0]["k"].shape)
    res = {"build_s": build_s, "wall_s": wall, "launches": c,
           "decode_steps": st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
           "expert_bytes": mine, "whole_expert_bytes": whole,
           "weight_bytes": eng.weight_bytes, "expert_block": tuple(mlp.up.shape),
           "router": tuple(mlp.router.w.shape), "pool": pool,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        say(f"[ep2 mixtral paged] rank 0: {json.dumps(res)}")
    check(mine * world == whole,
          f"ep2 mixtral paged: rank {rank} holds {mine} expert bytes of {whole}")
    check(res["expert_block"][0] == cfg.moe_experts // world
          and res["router"] == (cfg.dim, cfg.moe_experts)
          and pool[2] == cfg.num_kv_heads // world,
          f"ep2 mixtral paged: expert block {res['expert_block']}, router "
          f"{res['router']}, pools {pool}")
    check(c["all_to_all"] == 0, "ep2 mixtral paged: serving took the all_to_all form")
    del sch
    _free_cuda()
    tape = _RouteTape(eng.model)
    rows = []
    with torch.no_grad(), eng.parallel():
        for p, o in zip(prompts, outs):
            tape.record()
            try:
                rows.append(_replay_paged_row(eng.model, p, o))
            finally:
                tape.release()
    res["own_replay"] = _gap_check(f"ep2 mixtral paged rank {rank} vs its one-row "
                                   "paged replay", rows, outs)
    routes = [t.cpu() for t in tape.tape]
    del eng, rows, tape
    _free_cuda()
    return {"outs": outs, "routes": routes, **res}


def _ep_train_setup():
    """[ep2 mixtral train]'s model config, TrainConfig and batch."""
    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(), num_layers=EP_TRAIN_LAYERS)
    B, T = EP_TRAIN_BATCH
    r = np.random.default_rng(5)
    ids = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T + 1))).to(DEV)
    tcfg = TrainConfig(batch_size=B, micro_batches=EP_TRAIN_MICRO, optimizer="sgd",
                       learning_rate=EP_TRAIN_LR, dtype="bfloat16",
                       moe_aux_weight=EP_TRAIN_AUX)
    return cfg, tcfg, {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _lm_loss(logits, batch):
    return softmax_cross_entropy(logits, batch["labels"])


def _ep_train_world1() -> dict:
    """[ep2 mixtral train]'s first step at world 1 (one NCCL rank, the
    process group destroyed after): the bf16 step through B1/B2 and the
    f32 step through the plain attention that decides the leaves at
    bf16's noise floor, -> per tag (loss, gradients on the host)."""
    cfg, tcfg, batch = _ep_train_setup()
    out = {}
    mesh = make_mesh(MeshConfig())
    try:
        model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
        params = dict(model.named_parameters())
        for tag, dtype, impl in (("bf16", "bfloat16", None), ("f32", "float32", "reference")):
            m = model if impl is None else Llama(dataclasses.replace(cfg, attn_impl=impl),
                                                 device="meta", dtype=torch.bfloat16,
                                                 seed=None)
            tr = ShardedTrainer(mesh, dataclasses.replace(tcfg, dtype=dtype),
                                m.as_pipeline_parts(params), _lm_loss)
            loss, grads = tr.loss_and_grads(tr.init_state(), batch)
            # bf16 on the host: its rounding is far below the bf16 step's own
            out[tag] = (float(loss), {k: v.to(torch.bfloat16).cpu()
                                      for k, v in grads.items()})
            del tr, grads, m
            _free_cuda()
        del model, params
    finally:
        shutdown_distributed()
    _free_cuda()
    return out


def _ep2_train(rank: int, world: int, out_dir: str) -> dict:
    """[ep2 mixtral train] on this rank: ``ShardedTrainer`` at model 2,
    pipe 1, on a CUDA mesh over the gloo group, the MoE layers in their
    all_to_all form (``ep.ep_parallel``: each rank routes its batch row
    of a micro, the dispatched tokens swapped to the experts' ranks and
    back), 4 of the 8 experts and half of the heads a rank. The first
    step's loss and gradients (bf16, with the block each leaf is of the
    whole, saved for the parent), then EP_TRAIN_STEPS steps; each gates
    B1 and B2 once a layer and micro and four all_to_all swaps a layer
    and micro (two forward, two backward)."""
    cfg, tcfg, batch = _ep_train_setup()
    L, M = cfg.num_layers, tcfg.micro_batches
    mesh = make_mesh(MeshConfig(model=world), device="cuda")

    def build():
        # the whole weights generated on the card from the seed, kept on
        # the host for the trainer to cut; the modules are a meta-device
        # structure (every call replaces their parameters)
        model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
        params = {k: v.cpu() for k, v in model.named_parameters()}
        del model
        _free_cuda()
        structure = Llama(cfg, device="meta", dtype=torch.bfloat16, seed=None)
        tr = ShardedTrainer(mesh, tcfg, structure.as_pipeline_parts(params), _lm_loss,
                            device=DEV)
        state = tr.init_state()
        # the blocks are cut: the trainer reads the whole weights no more
        tr.parts.embed_params = tr.parts.block_params = tr.parts.head_params = {}
        return tr, state

    torch.cuda.reset_peak_memory_stats()
    tr, state = build()
    per_step, swaps = L * M, 4 * L * M
    _zero_counts()
    loss0, grads = tr.loss_and_grads(state, batch)
    c = _counts()
    check(c["flash_fwd"] == c["flash_bwd"] == per_step and c["all_to_all"] == swaps,
          f"ep2 mixtral train: rank {rank}'s first step launched {c}, expected B1 and "
          f"B2 {per_step} each and {swaps} all_to_all swaps")
    cuts = {k: [(d, *NamedSharding(mesh, tr._specs[k]).block(d))
                for d in NamedSharding(mesh, tr._specs[k]).dims()] for k in grads}
    # rank 0 saves every leaf, the others only their blocks of split ones
    keep = [k for k in grads if rank == 0 or cuts[k]]
    torch.save({"loss": float(loss0), "cuts": {k: cuts[k] for k in keep},
                "grads": {k: grads[k].to(torch.bfloat16).cpu() for k in keep}},
               os.path.join(out_dir, f"ep2_grads{rank}.pt"))
    del grads
    _free_cuda()
    _zero_counts()
    state, losses, secs, (k1, k2) = _sharded_steps(tr, state, batch, EP_TRAIN_STEPS,
                                                   warm=1)
    n = tp.all_to_all_model.collectives
    check(k1 == k2 == per_step * EP_TRAIN_STEPS and n == swaps * EP_TRAIN_STEPS,
          f"ep2 mixtral train: rank {rank} launched B1 {k1}, B2 {k2}, {n} swaps in "
          f"{EP_TRAIN_STEPS} steps, expected {per_step}, {per_step} and {swaps} a step")
    check(all(np.isfinite(losses)), "ep2 mixtral train: non-finite loss")
    res = {"rank": rank, "mesh": tr.describe(), "first_loss": float(loss0),
           "losses": losses, "step_ms": [x * 1e3 for x in secs],
           "launches_per_step": per_step, "all_to_all_per_step": swaps,
           "collectives_per_step": {k: v / EP_TRAIN_STEPS
                                    for k, v in tp.collective_counts().items()},
           "expert_block": tuple(state.params["stages.0.mlp.up"].shape),
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rank == 0:
        say(f"[ep2 mixtral train] rank 0: {json.dumps(res)}")
    del tr, state
    _free_cuda()
    return {**res, "launches": (k1 + per_step, k2 + per_step)}


def _ep2_train_check(d: str, ranks, world1: dict, name_power: str) -> dict:
    """[ep2 mixtral train] in the parent: each rank's first-step
    gradients against its blocks of the world-1 step's (the f32 plain
    step deciding the leaves at bf16's noise floor, as in [sharded
    gpt2]), the first loss against world 1's within EP_LOSS_REL (relative), and
    the ranks' losses equal."""
    ep = [r["ep2_train"] for r in ranks]
    agree = {}
    for rank in range(len(ranks)):
        g = torch.load(os.path.join(d, f"ep2_grads{rank}.pt"), weights_only=False,
                       mmap=True)

        def block(run, k):
            t = run[1][k]
            for dim, i, n in g["cuts"][k]:
                t = t.chunk(n, dim=dim)[i]
            return t.to(DEV).float()

        trip = [(g["loss"], {k: v.to(DEV).float() for k, v in g["grads"].items()})]
        trip += [(world1[t][0], {k: block(world1[t], k) for k in g["grads"]})
                 for t in ("bf16", "f32")]
        agree[rank] = _grad_agreement(*trip)
        del g, trip
        _free_cuda()
    loss_diff = abs(ep[0]["first_loss"] - world1["bf16"][0])
    rel = loss_diff / abs(world1["bf16"][0])
    res = {"first_loss": ep[0]["first_loss"], "world1_loss": world1["bf16"][0],
           "world1_f32_loss": world1["f32"][0], "loss_abs_diff": loss_diff,
           "loss_rel_diff": rel,
           "losses": ep[0]["losses"], "step_ms_rank0": ep[0]["step_ms"],
           "gradients_by_rank": agree, "expert_block": ep[0]["expert_block"],
           "all_to_all_per_step": ep[0]["all_to_all_per_step"],
           "collectives_per_step_rank0": ep[0]["collectives_per_step"],
           "peak_allocated_gib": [x["peak_allocated_gib"] for x in ep],
           "transport": "gloo on one card (all_to_all_single of CUDA tensors)",
           "card": name_power}
    say(f"[ep2 mixtral train] {json.dumps(res)}")
    check(rel <= EP_LOSS_REL, f"ep2 mixtral train: first loss "
          f"{ep[0]['first_loss']} vs world 1's {world1['bf16'][0]}")
    check(all(not a["failed"] for a in agree.values()),
          f"ep2 mixtral train: gradient disagreement "
          f"{ {r: a['failed'] for r, a in agree.items()} }")
    check(all(x["losses"] == ep[0]["losses"] for x in ep),
          "ep2 mixtral train: the ranks report different losses")
    return res


def _tp2_config() -> LlamaConfig:
    return dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=TP2_LAYERS)


def phase_tp2(name_power: str, prompts) -> dict:
    """[tp2 paged], [tp2 contiguous], [tp2 static]: one job of two spawned
    ranks over gloo, both on cuda:0 (NCCL takes one rank a device; gloo
    carries the CUDA tensors of the collectives through host copies, so
    this is a correctness check of tensor parallelism at full width, not
    a deployment), Llama-3-8B at full width and TP2_LAYERS of its 32
    layers, eager. Each rank holds its blocks (half of every ``Dense``)
    and serves [slice]'s first 4 requests through the paged and the
    contiguous engine and 2 left-padded prompts through ``generate``, 16
    tokens each; each rank gates its own collectives (2 x TP2_LAYERS + 1
    a model call) and launches (B3 TP2_LAYERS times a paged decode step
    and prefill chunk, B4 TP2_LAYERS times a decode step), and both ranks
    must emit the same
    tokens. Here, on the whole model rebuilt from the same seed after the
    job: every emitted token within LOGIT_GAP_TOL of the teacher-forced
    row max; printed, the greedy agreement with that model's world-1
    paged run of the same requests and each rank's weight bytes against
    half of the whole model's. The [ep2 *] legs run in the same job."""
    prompts = prompts[:MESH_REQUESTS]
    s_ids, s_pad = _pad_left(prompts[:TP2_STATIC_ROWS])
    t0 = time.perf_counter()
    ep_world1 = _ep_train_world1()
    world1_s = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="tp2-", dir=os.path.join(_build.PKG_DIR, "_build"))
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _tp2_rank, args=(TP2_WORLD, os.path.join(d, "store"), prompts, s_ids, s_pad, d,
                         name_power),
        nprocs=TP2_WORLD, start_method="spawn", join=True)
    job_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(TP2_WORLD)]
    model = Llama(_tp2_config(), device=DEV, dtype=torch.bfloat16, seed=0)
    world1 = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16, device=DEV)
    ref_outs = _serve_short("tp2 world 1", world1, prompts, MESH_NEW, True)[1]
    del world1
    _free_cuda()
    out = {"job_s": job_s, "card": name_power}
    s_prompts = prompts[:TP2_STATIC_ROWS]
    for leg, legp, ref in (("paged", prompts, ref_outs),
                           ("contiguous", prompts, ref_outs),
                           ("static", s_prompts, ref_outs[:TP2_STATIC_ROWS])):
        r0 = ranks[0][leg]
        for r in ranks[1:]:
            check(all(np.array_equal(a, b) for a, b in zip(r[leg]["outs"], r0["outs"])),
                  f"tp2 {leg}: the ranks emitted different tokens")
        tf = _teacher_forced(f"tp2 {leg}", model, legp, r0["outs"])
        same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(r0["outs"], ref))
        total = sum(len(a) for a in r0["outs"])
        out[leg] = {"worst_gap": tf["worst_gap"], "exact": tf["exact"],
                    "tokens": tf["tokens"], "equal_to_world1": same,
                    "share_equal_to_world1": same / total, "wall_s": r0["wall"],
                    "launches_rank0": r0["launches"]}
        if "decode_steps" in r0:
            out[leg]["model_calls"] = r0.get("prefill_chunks", 0) + r0["decode_steps"]
    st = ranks[0]["static"]
    out["static"].update(prefill_s=st["prefill_s"], model_step_ms=st["decode_ms"],
                         profile=st["profile"])
    out["disagg"] = _tp2_disagg_world1(model, prompts[:TP2_DISAGG_REQUESTS], d, ranks,
                                       ref_outs, name_power)
    sp2 = [r["sp2_static"] for r in ranks]
    check(all(np.array_equal(a, b) for r in sp2[1:] for a, b in zip(r["outs"], sp2[0]["outs"])),
          "sp2 static: the ranks emitted different tokens")
    tf = _teacher_forced("sp2 static", model, s_prompts, sp2[0]["outs"])
    same = sum(int((np.asarray(a) == np.asarray(b)).sum())
               for a, b in zip(sp2[0]["outs"], ref_outs[:TP2_STATIC_ROWS]))
    out["sp2_static"] = {"worst_gap": tf["worst_gap"], "exact": tf["exact"],
                         "tokens": tf["tokens"], "equal_to_world1": same,
                         "share_equal_to_world1": same / tf["tokens"],
                         **{k: sp2[0][k] for k in ("wall_s", "decode_ms", "cache_bytes",
                                                  "world1_cache_bytes", "slots")},
                         "cache_bytes_by_rank": [r["cache_bytes"] for r in sp2]}
    out["weight_bytes"] = [r["weight_bytes"] for r in ranks]
    out["half_of_whole"] = ranks[0]["whole_bytes"] / TP2_WORLD
    out["max_memory_allocated"] = [r["max_memory_allocated"] for r in ranks]
    out["pool_shape"] = ranks[0]["paged"]["pool"]
    out["contiguous_cache_shape"] = ranks[0]["contiguous"]["cache"]
    say(f"[tp2] {json.dumps(out)}")
    del model
    _free_cuda()
    ep_train = _ep2_train_check(d, ranks, ep_world1, name_power)
    ep_train["world1_s"] = world1_s
    del ep_world1
    shutil.rmtree(d, ignore_errors=True)
    ep = [r["ep2_paged"] for r in ranks]
    check(all(np.array_equal(a, b) for r in ep[1:] for a, b in zip(r["outs"], ep[0]["outs"])),
          "ep2 mixtral paged: the ranks emitted different tokens")
    return {"paged": sum(r[leg]["launches"]["paged_decode"] for r in ranks
                         for leg in ("paged", "disagg")),
            "norm": sum(r[leg]["launches"]["fused_norm"] for r in ranks
                        for leg in ("paged", "disagg", "contiguous", "static", "sp2_static")),
            "ep2_paged": {"outs": ep[0]["outs"], "routes": ep[0]["routes"], "ranks": [
                {k: v for k, v in r.items() if k not in ("outs", "routes")} for r in ep]},
            "ep2_launches": {
                "paged": sum(r["launches"]["paged_decode"] for r in ep),
                "norm": sum(r["launches"]["fused_norm"] for r in ep),
                "flash": tuple(sum(r["ep2_train"]["launches"][i] for r in ranks)
                               for i in (0, 1))}}


def _tp2_disagg_world1(model, prompts, d: str, ranks, ref_outs, name_power: str) -> dict:
    """[tp2 disagg]'s one-rank decode leg: the TP-2 payloads (rank 0's
    file) imported into a one-rank paged engine on the whole model,
    eager. Its KV blocks carry TP-2's rounding, so its tokens are held
    by the teacher-forced gate (not equal to either colocated run); the
    printed line gives their agreement with the world-1 and the TP-2
    colocated tokens and the payload's distance from a one-rank export
    of the same prompts."""
    payloads = torch.load(os.path.join(d, "disagg.pt"), weights_only=False)
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV, cuda_graphs=False)
    kw = dict(slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
              gen=GenerationConfig(max_new_tokens=MESH_NEW), cuda_graphs=False)
    D = PagedContinuousBatchingEngine(eng, **kw)
    _zero_counts()
    rids = [D.import_prefill(pl) for pl in payloads]
    D.run_until_idle()
    c = _counts()
    outs = [np.asarray(D.result(rid)) for rid in rids]
    tf = _teacher_forced("tp2 disagg one-rank decode", model, prompts, outs)
    del D
    P = PagedContinuousBatchingEngine(eng, **kw)
    mine = [P.prefill_export(p) for p in prompts]
    diff = max(float((a[n].float() - b[n].float()).abs().max())
               for pa, pb in zip(payloads, mine)
               for a, b in zip(pa["layers"], pb["layers"]) for n in a)
    share = {name: sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, ref))
             / sum(len(a) for a in outs)
             for name, ref in (("world1", ref_outs), ("tp2", ranks[0]["disagg"]["outs"]))}
    res = {"worst_gap": tf["worst_gap"], "exact": tf["exact"], "tokens": tf["tokens"],
           "share_equal": share, "payload_max_abs_diff_vs_one_rank_export": diff,
           "launches": c, "card": name_power,
           "tp2_leg": {k: ranks[0]["disagg"][k] for k in (
               "export_s", "import_decode_wall_s", "payload_k_block", "pool",
               "decode_steps")}}
    say(f"[tp2 disagg] {json.dumps(res)}")
    del P, eng, payloads, mine
    _free_cuda()
    return res


MIX_LAYERS = 4
MIX_NEW = 16
MIX_GEN_LENS = (100, 700, 310, 520, 180, 640, 260, 450)
MIX_GEN_NEW = 16
MIX_GEN_PROFILE_STEP = 8  # decode steps 4..7 plain, 8..11 profiled


def _mixtral_weight_bytes(cfg) -> int:
    """bf16 bytes one weight pass reads, from the config: per layer q, k,
    v, o, the router and all E experts' up, gate and down; the untied
    head."""
    d, H, G, F_, E = cfg.dim, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_dim, \
        cfg.moe_experts
    Dh = d // H
    attn = d * H * Dh + 2 * d * G * Dh + H * Dh * d
    return 2 * (cfg.num_layers * (attn + 3 * E * d * F_ + d * E) + d * cfg.vocab_size)


class _RouteTape:
    """The routing decisions of every MoE call while recording (each
    call's ``dispatch``, in call order) and their replay: a pinned call
    takes the next recorded dispatch, and its combine weights from its
    own router probabilities normalised over the recorded experts, as
    ``MoEFeedForward._route`` normalises them. Wraps each block's
    ``mlp._route`` on the instance; used around eager replays only, never
    inside a captured body. Kept and offered (token, choice) routes are
    summed on the device by T == 1 (decode) and T > 1 (prefill) calls."""

    KEYS = ("decode", "prefill")

    def __init__(self, model):
        self._mlps = [blk.mlp for blk in model.blocks.blocks()]
        self.tape = []
        self.kept = torch.zeros(2, dtype=torch.float64, device=DEV)
        self.offered = [0, 0]

    def record(self) -> None:
        for mlp in self._mlps:
            mlp._route = self._recorder(mlp._route, mlp.top_k)

    def _recorder(self, inner, top_k):
        def route(logits, *args, **kw):
            d, c, aux = inner(logits, *args, **kw)
            self.tape.append(d.bool())
            i = 0 if d.shape[1] == 1 else 1
            self.kept[i] += d.sum().double()
            self.offered[i] += d.shape[0] * d.shape[1] * top_k
            return d, c, aux
        return route

    def pin(self) -> None:
        self.tape.reverse()  # pop() then takes the calls in their order
        for mlp in self._mlps:
            mlp._route = self._pinned

    def _pinned(self, logits, *args, **kw):
        d = self.tape.pop().float()
        check(d.shape[:3] == logits.shape, "route tape out of step with the replay")
        c = d * torch.softmax(logits.float(), dim=-1)[..., None]
        c = c / c.sum(dim=(2, 3), keepdim=True).clamp_min(1e-9)
        return d, c, torch.zeros((), device=logits.device)

    def release(self) -> None:
        for mlp in self._mlps:
            del mlp._route  # the class's method again

    def drops(self) -> dict:
        kept = self.kept.tolist()
        return {k: {"drop_fraction": 1.0 - kept[i] / self.offered[i] if self.offered[i]
                    else None, "routes": self.offered[i]}
                for i, k in enumerate(self.KEYS)}


def _set_index(caches, at: int) -> None:
    idx = torch.tensor(at, dtype=torch.int32, device=DEV)
    for c in caches:
        c["attn"]["index"] = idx


def _replay_chunked(model, p, o, chunk: int, block: int = 16) -> torch.Tensor:
    """A paged request's same-T replay through the contiguous cache and
    the plain attention: the prompt in the engine's ``chunk``-token
    prefill calls (the last padded with zeros at its tail, as the engine
    pads it), then one fed token a step. -> f32 logits [len(o), V], row i
    the distribution token i was sampled from.

    The tail pads are routed, and their first choices take capacity
    before the real tokens' second choices, so they must see what they
    see in the engine: the prompt's ``ceil(n / block)`` blocks are
    mapped at prefill, and B3 never reads a key whose block-table entry
    is the sentinel, so every key past the last mapped block is masked
    here."""
    n, new = len(p), len(o)
    cap = -(-(n + new + chunk) // block) * block
    caches = model.init_caches(1, cap, dtype=torch.bfloat16)
    mapped = torch.arange(cap, device=DEV) < -(-n // block) * block
    mask = mapped[None, None, None, :]
    rows = []
    for pos in range(0, n, chunk):
        nreal = min(chunk, n - pos)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :nreal] = p[pos:pos + nreal]
        _set_index(caches, pos)
        h, _ = model(torch.from_numpy(buf).to(DEV), caches=caches,
                     positions=(pos + torch.arange(chunk, device=DEV))[None],
                     mask=mask, logits=False)
    rows.append(model.head(h[0, nreal - 1]))
    for i, t in enumerate(o[:-1]):
        _set_index(caches, n + i)
        h, _ = model(torch.tensor([[int(t)]], device=DEV), caches=caches,
                     positions=torch.tensor([[n + i]], device=DEV), logits=False)
        rows.append(model.head(h[0, -1]))
    return torch.stack(rows).float()


def _replay_padded(model, ids_row, pad_row, o) -> torch.Tensor:
    """One row of a left-padded ``generate``, replayed alone at the same
    T: the T0 prompt (pads included, first in the row's capacity count)
    in one call with ``generate``'s mask and positions, then one fed
    token a step over the contiguous cache. -> f32 logits [len(o), V]."""
    T0, new = len(ids_row), len(o)
    cap = -(-(T0 + new) // 16) * 16
    caches = model.init_caches(1, cap, dtype=torch.bfloat16)
    pad = torch.from_numpy(np.asarray(pad_row)).to(DEV).bool()
    pos = (pad.long().cumsum(0) - 1).clamp_min(0)[None]
    q = torch.arange(T0, device=DEV)
    mask = ((q[None, :] <= q[:, None]) & pad[None, :])[None, None]
    _set_index(caches, 0)
    h, _ = model(torch.from_numpy(np.asarray(ids_row)).to(DEV)[None], caches=caches,
                 positions=pos, mask=mask, logits=False)
    rows = [model.head(h[0, -1])]
    valid = torch.ones(cap, dtype=torch.bool, device=DEV)
    valid[:T0] = pad
    n_real = int(np.asarray(pad_row).sum())
    for i, t in enumerate(o[:-1]):
        _set_index(caches, T0 + i)
        h, _ = model(torch.tensor([[int(t)]], device=DEV), caches=caches,
                     positions=torch.tensor([[n_real + i]], device=DEV),
                     mask=valid[None, None, None, :], logits=False)
        rows.append(model.head(h[0, -1]))
    return torch.stack(rows).float()


def _gap_check(tag: str, logits_rows, outs, first: int = 8) -> dict:
    """Every emitted token within LOGIT_GAP_TOL of its replay row's
    maximum; prints the worst gap (and over tokens 1 .. ``first``), how
    many are the exact argmax and how many sit past the tolerance."""
    gaps, head, exact, over = [], [], 0, 0
    for lg, o in zip(logits_rows, outs):
        check(bool(torch.isfinite(lg).all()), f"{tag}: non-finite replay logits")
        tok = torch.from_numpy(np.asarray(o)).to(DEV)
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        gaps.append(float(gap.max()))
        head.append(float(gap[1:1 + first].max()) if len(o) > 1 else 0.0)
        exact += int((gap == 0).sum())
        over += int((gap > LOGIT_GAP_TOL).sum())
    n_tok = sum(len(o) for o in outs)
    say(f"[{tag}] same-T replay: worst logit gap {max(gaps):.4f} (tolerance "
        f"{LOGIT_GAP_TOL}; first decode chunk "
        f"{max(head):.4f}); {exact}/{n_tok} tokens are the exact argmax, {over} past "
        "the tolerance")
    check(max(gaps) <= LOGIT_GAP_TOL, f"{tag}: same-T replay check failed")
    return {"worst_gap": max(gaps), "first_chunk_gap": max(head), "exact": exact,
            "tokens": n_tok, "past_tolerance": over}


def _replay_paged_row(model, p, o, chunk: int = 128, block: int = 16,
                      L: int = 2048) -> torch.Tensor:
    """A paged request's same-T replay alone on a one-row paged cache of
    the engine's geometry (B3 for attention, as in the engine): the
    prompt's ``ceil(n / block)`` blocks mapped for its ``chunk``-token
    prefill calls, every block for the one-token steps. -> f32 logits
    [len(o), V]."""
    MB = L // block
    pools = [blk.attn.init_paged_cache(MB, block, 1, MB, dtype=torch.bfloat16,
                                       device=DEV) for blk in model.blocks.blocks()]
    bt = pools[0]["block_table"]
    n = len(p)
    bt[0, :-(-n // block)] = torch.arange(-(-n // block), dtype=torch.int32, device=DEV)

    def caches(at: int):
        idx = torch.tensor([at], dtype=torch.int32, device=DEV)
        return [{"attn": {"k": c["k"], "v": c["v"], "index": idx, "block_table": bt}}
                for c in pools]

    rows = []
    for pos in range(0, n, chunk):
        nreal = min(chunk, n - pos)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :nreal] = p[pos:pos + nreal]
        h, _ = model(torch.from_numpy(buf).to(DEV), caches=caches(pos),
                     positions=(pos + torch.arange(chunk, device=DEV))[None],
                     mask=None, logits=False)
    rows.append(model.head(h[0, nreal - 1]))
    bt[0] = torch.arange(MB, dtype=torch.int32, device=DEV)
    view = torch.arange(L, device=DEV)
    for i, t in enumerate(o[:-1]):
        h, _ = model(torch.tensor([[int(t)]], device=DEV), caches=caches(n + i),
                     positions=torch.tensor([[n + i]], device=DEV),
                     mask=(view < n + i + 1)[None, None, None, :], logits=False)
        rows.append(model.head(h[0, -1]))
    return torch.stack(rows).float()


def _replay_paged(model, prompts, outs, memo: dict, tape: "_RouteTape") -> dict:
    """Two same-T replays of each request (a (prompt, tokens) pair
    already replayed is reused from ``memo``): ``"paged"`` alone on a
    one-row paged cache through B3 (the engine's numerics; ``tape``
    records its routing); ``"plain"`` through the contiguous cache and
    the plain attention with that routing pinned. -> per kind, the
    logits rows."""
    out = {"paged": [], "plain": []}
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            key = (p.tobytes(), np.asarray(o).tobytes())
            if key not in memo:
                tape.record()
                try:
                    paged = _replay_paged_row(model, p, o)
                finally:
                    tape.release()
                tape.pin()
                try:
                    plain = _replay_chunked(model, p, o, 128)
                finally:
                    tape.release()
                check(not tape.tape, "route tape: recorded calls left unreplayed")
                memo[key] = {"paged": paged, "plain": plain}
            for kind in out:
                out[kind].append(memo[key][kind])
    return out


def _check_chunk_starts(tag: str, sch, rids, prompts, shared: int = 256,
                        chunk: int = 128) -> None:
    """The replay chunks every prompt from 0, which is the engine's own
    chunking only if each request's prefix hit is a multiple of the
    chunk: from each request's prefill-chunk count, its hit is 0 or the
    ``shared`` prefix, and those hits sum to the engine's matched tokens."""
    hits = 0
    for rid, p in zip(rids, prompts):
        n, k = len(p), sch._requests[rid].prefill_chunks
        m = 0 if k == -(-n // chunk) else shared
        check(k == -(-(n - m) // chunk),
              f"{tag}: request {rid} ran {k} prefill chunks for {n} tokens")
        hits += m
    matched = sch.stats()["prefix_matched_tokens"]
    check(hits == matched and shared % chunk == 0,
          f"{tag}: prefix hits {hits} against {matched} matched tokens")


def _ep2_tokens(name_power: str, model, prompts, ep2: dict, world1_outs) -> None:
    """[ep2 mixtral paged]'s tokens against the world-1 Mixtral: every
    token within LOGIT_GAP_TOL of the row max of this model's same-T
    replay (one row on a paged cache through B3, as [mixtral paged]'s
    own tokens are held) with the routing pinned to rank 0's replay at
    model 2: routing is discontinuous, and the model-2 sums round
    otherwise, so a free replay would flip router near-ties."""
    outs = ep2["outs"]
    tape = _RouteTape(model)
    tape.tape = [t.to(DEV) for t in ep2["routes"]]
    tape.pin()
    try:
        with torch.no_grad():
            rows = [_replay_paged_row(model, p, o) for p, o in zip(prompts, outs)]
    finally:
        tape.release()
    check(not tape.tape, "ep2 mixtral paged: route tape left unreplayed")
    gap = _gap_check("ep2 mixtral paged vs world-1 paged replay, model-2 routing pinned",
                     rows, outs)
    same = sum(int((np.asarray(a) == np.asarray(b)[:len(a)]).sum())
               for a, b in zip(outs, world1_outs))
    r0 = ep2["ranks"][0]
    res = {"worst_gap_world1_pinned": gap["worst_gap"], "tokens": gap["tokens"],
           "exact_argmax": gap["exact"],
           "worst_gap_own_replay": [r["own_replay"]["worst_gap"] for r in ep2["ranks"]],
           "equal_to_world1": same,
           "share_equal_to_world1": same / gap["tokens"],
           **{k: r0[k] for k in ("wall_s", "build_s", "decode_steps", "prefill_chunks",
                                 "expert_bytes", "whole_expert_bytes", "weight_bytes",
                                 "expert_block", "pool")},
           "collectives_rank0": r0["launches"]["collectives"],
           "peak_allocated_gib": [r["peak_allocated_gib"] for r in ep2["ranks"]],
           "transport": "gloo on one card", "card": name_power}
    say(f"[ep2 mixtral paged] {json.dumps(res)}")


def phase_mixtral(name_power: str, cap: dict, ep2: dict) -> dict:
    """Mixtral-8x7B (``LlamaConfig.mixtral_8x7b()`` at full width, 8 of
    32 layers, random bf16 weights from seed 0, built in bf16 on the
    card) through ``PagedContinuousBatchingEngine`` in the [slice]
    geometry, captured then eager: the [slice] requests, B3's decode
    variant and B4 8 times a decode step, B3's prefill variant 8 times
    a chunk, no general launch, replays after each graph's first chunk;
    the weight-pass bytes equal the config's. Every token within
    LOGIT_GAP_TOL of two same-T replays (each prompt in the engine's
    128-token chunks, the last padded as the engine pads it, then one
    token a step): alone on a one-row paged cache through B3, whose
    routing (recorded outside any captured body) must show a decode drop
    fraction of exactly 0, and through the contiguous cache and the plain
    attention with that routing pinned. Then ``InferenceEngine.generate`` on 8
    left-padded prompts of 100-700 tokens, 16 new tokens, under a
    row-by-row replay at T0 (plain attention on both sides). Then
    ``ep2``, [ep2 mixtral paged]'s tokens from the [tp2] job (the same
    model at model 2, [slice]'s first 4 requests), under the same two
    same-T replays of this world-1 model; printed, their agreement with
    this run's first 16 tokens of those requests."""
    cfg = dataclasses.replace(LlamaConfig.mixtral_8x7b(), num_layers=MIX_LAYERS)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    want = _mixtral_weight_bytes(cfg)
    say(f"[mixtral paged] Mixtral-8x7B width (dim {cfg.dim}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, hidden {cfg.hidden_dim}, {cfg.moe_experts} "
        f"experts, top-{cfg.moe_top_k}), {L} of 32 layers, built in {build_s:.1f} s; "
        f"weight-pass bytes {eng.weight_bytes} (config: {want}); "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; {name_power}")
    check(eng.weight_bytes == want,
          f"mixtral paged: weight_bytes {eng.weight_bytes} != {want} from the config")
    prompts = _requests(cfg.vocab_size)
    runs = {}
    for mode in ("captured", "eager"):
        captured = mode == "captured"
        tag = "mixtral paged" if captured else "mixtral paged eager"
        sch, rids, outs, wall, k = _serve_paged(
            model, prompts, MIX_NEW, captured, cap if captured else None, eng=eng,
            tag="mixtral paged", name="Mixtral-8x7B")
        st = sch.stats()
        if captured:
            _graph_line("mixtral paged", st["graphs"])
            dt = _timer_line("mixtral paged", sch, name_power)
        _check_chunk_starts(tag, sch, rids, prompts)
        ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
        runs[mode] = {
            "outs": outs, "wall": wall, "launches": k,
            "ttft_s_mean": float(np.mean(ttft)), "ttft_s_max": float(np.max(ttft)),
            "decode_tokens_per_s": (sch.decode_only_tokens / sch.decode_only_s
                                    if sch.decode_only_s else None),
            "decode_steps": st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
            "prof": _profile_decode(sch, cfg.vocab_size, name_power,
                                    tag="mixtral paged profile") if captured else None,
        }
        del sch
        _free_cuda()
    cap_run, eag_run = runs["captured"], runs["eager"]
    tape = _RouteTape(model)
    memo = {}
    checks = {}
    for mode, run in runs.items():
        rows = _replay_paged(model, prompts, run["outs"], memo, tape)
        sfx = "" if mode == "captured" else " eager"
        checks[mode] = {
            "paged": _gap_check(f"mixtral paged{sfx} vs one-row paged replay", rows["paged"],
                                run["outs"]),
            "plain": _gap_check(f"mixtral paged{sfx} vs plain replay, routing pinned",
                                rows["plain"], run["outs"]),
        }
    del memo
    routing = tape.drops()
    tf, tf_e = checks["captured"]["plain"], checks["eager"]["plain"]
    _agreement("mixtral paged", cap_run["outs"], eag_run["outs"], tf, tf_e)
    _step_line("mixtral paged", cap_run["prof"], None, cap_run["wall"], eag_run["wall"])
    say(f"[mixtral paged routing] {json.dumps(routing)}")
    check(routing["decode"]["routes"] > 0 and routing["decode"]["drop_fraction"] == 0.0,
          f"mixtral paged: decode steps dropped routes: {routing['decode']}")
    _ep2_tokens(name_power, model, prompts[:MESH_REQUESTS], ep2,
                cap_run["outs"][:MESH_REQUESTS])

    # the static path: left-padded generate, the pads first in each row's
    # capacity count
    gprompts, ids, pad = _left_padded(MIX_GEN_LENS, cfg.vocab_size, seed=7)
    B, T0 = ids.shape
    _zero_counts()
    gen = _generate_traced("mixtral static", eng, ids, pad, MIX_GEN_NEW,
                           MIX_GEN_PROFILE_STEP, name_power, active=4)
    c = _counts()
    _check_decode_launches("mixtral static", c, L * (MIX_GEN_NEW - 1), "rms")
    check(gen["out"].shape == (B, MIX_GEN_NEW),
          f"mixtral static: tokens of shape {gen['out'].shape}")
    eng._gen_state = None
    _free_cuda()
    tape = _RouteTape(model)
    tape.record()
    try:
        with torch.no_grad():
            rows = [_replay_padded(model, ids[b], pad[b], gen["out"][b]) for b in range(B)]
        gtf = _gap_check("mixtral static", rows, list(gen["out"]))
    finally:
        tape.release()
    groute = tape.drops()
    del rows, tape
    check(groute["decode"]["drop_fraction"] == 0.0,
          f"mixtral static: decode steps dropped routes: {groute['decode']}")
    res = {
        "model": "Mixtral-8x7B", "layers": L, "experts": cfg.moe_experts,
        "top_k": cfg.moe_top_k, "weight_pass_bytes": eng.weight_bytes,
        "build_s": build_s, "requests": len(prompts), "tokens": tf["tokens"],
        "wall_s": cap_run["wall"], "eager_wall_s": eag_run["wall"],
        "ttft_s_mean": cap_run["ttft_s_mean"], "ttft_s_max": cap_run["ttft_s_max"],
        "decode_tokens_per_s": cap_run["decode_tokens_per_s"],
        "eager_decode_tokens_per_s": eag_run["decode_tokens_per_s"],
        "model_step_ms": cap_run["prof"]["model_step_ms"],
        "kernel_ms_per_model_step": cap_run["prof"]["kernel_ms_per_model_step"],
        "device_busy_share": cap_run["prof"]["device_busy_share"],
        "decode_mbu": dt["programs"]["decode"].get("mbu", "not measured"),
        "prefill_mfu": dt["programs"]["prefill_chunk"].get("mfu", "not measured"),
        "prefill_mbu": dt["programs"]["prefill_chunk"].get("mbu", "not measured"),
        "prefill_chunk_drop_fraction": routing["prefill"]["drop_fraction"],
        "decode_drop_fraction": routing["decode"]["drop_fraction"],
        "worst_gap_one_row_paged": max(c["paged"]["worst_gap"] for c in checks.values()),
        "worst_gap_plain_pinned": max(tf["worst_gap"], tf_e["worst_gap"]),
        "static": {"batch": B, "T0": T0, "new_tokens": MIX_GEN_NEW,
                   "prefill_s": gen["prefill_s"], "generate_s": gen["total_s"],
                   "decode_ms_per_step": gen["decode_ms"],
                   "prefill_drop_fraction": groute["prefill"]["drop_fraction"],
                   "worst_gap": gtf["worst_gap"]},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "card": name_power,
    }
    say(f"[mixtral paged] {json.dumps(res)}")
    del eng, model
    _free_cuda()
    return {"paged": cap_run["launches"]["paged"], "norm": cap_run["launches"]["norm"],
            "static_norm": c["fused_norm"]}


def _bert_loss(module, params, batch, rng):
    logits = functional_call(
        module, params, (batch["input_ids"],),
        {"attention_mask": batch["attention_mask"], "rng": rng,
         "train": rng is not None},
    )
    return softmax_cross_entropy(logits, batch["labels"])


def _bert_batch(B, T, vocab, lens=None, seed=0):
    r = np.random.default_rng(seed)
    am = np.ones((B, T), np.int32)
    for b, n in enumerate(lens or []):
        am[b, n:] = 0
    return {
        "input_ids": torch.from_numpy(r.integers(0, vocab, (B, T))).to(DEV),
        "attention_mask": torch.from_numpy(am).to(DEV),
        "labels": torch.from_numpy(r.integers(0, CLASSES, (B,))).to(DEV),
    }


def _timed_steps(trainer, state, batch, gen, n, warm=3):
    """n steps from ``state`` (each ended by a device read of its loss);
    -> (final state, losses, per-step seconds after ``warm`` steps)."""
    losses, secs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, st = trainer.train_step(state, batch, gen)
        losses.append(float(st["loss"]))
        if i >= warm:
            secs.append(time.perf_counter() - t0)
    return state, losses, secs


def _profile_step(trainer, state, batch, gen) -> dict:
    """One training step under torch.profiler: kernel time over the
    step's wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = trainer.train_step(state, batch, gen)
        loss = float(st["loss"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    groups: dict[str, float] = {}
    for e in kernels:
        group = profiling.kernel_family(e.key)
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    return {
        "loss": loss, "profiled_step_s": wall,
        "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / wall if busy_us else "not measured",
        "kernel_ms_by_group": groups,
        # the host side of the same step: CPU time of every op, kernel
        # launches, tensor allocations
        "host_cpu_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
        "kernel_launches": sum(e.count for e in host if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")),
        "tensor_allocations": sum(e.count for e in host if e.key in (
            "aten::empty", "aten::empty_strided")),
        "top_kernels_ms": {
            e.key[:60]: [e.self_device_time_total / 1e3, e.count] for e in top[:10]
        },
    }


def _grad_agreement(kernel, plain, f32, direct_min: float = TRAIN_COSINE_MIN) -> dict:
    """Per-leaf agreement of (loss, grads) triples; see TRAIN_* above
    (``direct_min`` in place of TRAIN_COSINE_MIN)."""
    (lk, gk), (lp, gp), (lf, gf) = kernel, plain, f32

    def cos(a, b):
        a, b = a.flatten().double(), b.flatten().double()
        return float(a @ b / (a.norm() * b.norm()))

    direct, floor, failed, k_bias = {}, {}, [], {}
    for name, g in gp.items():
        if name.endswith("attn.k.b"):
            # zero in exact arithmetic (a softmax row is invariant to a
            # shift common to all its keys): both paths hold rounding noise
            k_bias[name] = float(gk[name].norm())
            continue
        if float(g.norm()) == 0:
            continue
        c = cos(gk[name], g)
        if c >= direct_min:
            direct[name] = c
            continue
        e_k = float((gk[name].double() - gf[name].double()).norm())
        e_p = float((g.double() - gf[name].double()).norm())
        floor[name] = {"cos_kernel_plain": c, "cos_plain_f32": cos(g, gf[name]),
                       "err_kernel_f32": e_k, "err_plain_f32": e_p}
        if cos(g, gf[name]) >= TRAIN_SIGNAL_COSINE or e_k > TRAIN_NOISE_RATIO * e_p:
            failed.append(name)
    return {
        "loss_kernel": float(lk), "loss_plain": float(lp), "loss_f32": float(lf),
        "leaves": len(direct) + len(floor),
        f"cosine_ge_{direct_min}": len(direct),
        "min_cosine_direct": min(direct.values()) if direct else None,
        "near_noise_floor": floor,
        "min_cos_kernel_f32": min(cos(gk[n], gf[n]) for n in direct),
        "min_cos_plain_f32": min(cos(gp[n], gf[n]) for n in direct),
        "k_bias_max_norm_kernel": max(k_bias.values()) if k_bias else None,
        "failed": failed,
    }


def phase_train(name_power: str) -> dict:
    """BERT-base fine-tuning through the port's Trainer at batch 8 x seq
    512, where attention runs B1 forward and B2 backward."""
    cfg = BertConfig.base()
    B, T, steps = 8, 512, 30
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=0)  # f32 params
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="adam",
                       learning_rate=1e-4, dtype="bfloat16", grad_clip_norm=1.0)
    trainer = Trainer(model, _bert_loss, tcfg, tracer=Tracer(), metrics=Metrics(),
                      flight=FlightRecorder(), device=DEV)
    state0 = trainer.init_state()
    n_params = sum(p.numel() for p in state0.params.values())
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = cfg.num_layers

    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    state, losses, secs = _timed_steps(trainer, state0, batch, gen, steps)
    k1, k2 = flash_attention_fwd_lse.launches, flash_attention_bwd.launches
    _train_telemetry("train", trainer, "trainer", steps, name_power)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(secs))
    flops = 6.0 * n_params * B * T + 12.0 * L * B * T * T * cfg.dim
    res = {
        "model": "BERT-base classifier", "params": n_params, "batch": B,
        "seq": T, "steps": steps, "loss_first5_mean": first,
        "loss_last5_mean": last, "losses": losses,
        "launches_fwd": k1, "launches_bwd": k2,
        "expected_launches": L * steps,
        "step_ms_median": step_s * 1e3, "step_ms_min": min(secs) * 1e3,
        "step_ms_max": max(secs) * 1e3,
        "samples_per_s": B / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": name_power,
    }
    say(f"[train] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(last < first, f"loss did not fall: {first} -> {last}")
    check(k1 == L * steps and k2 == L * steps,
          f"flash launches {k1}/{k2}, expected {L * steps} each")

    # the first step's gradients through the kernels against the plain
    # attention path, same params and batch, dropout off; both held
    # against the f32 gradient of the plain path
    grads = {}
    for tag, impl, dtype in (("kernel", None, None),
                             ("plain", "reference", None),
                             ("f32", "reference", "float32")):
        tr = trainer
        if impl is not None:
            tr = Trainer(
                BertClassifier(dataclasses.replace(cfg, attn_impl=impl),
                               CLASSES, device=DEV, seed=None),
                _bert_loss,
                tcfg if dtype is None else dataclasses.replace(tcfg, dtype=dtype),
                device=DEV,
            )
        grads[tag] = tr.loss_and_grads(state0.params, batch)
        del tr
    gres = _grad_agreement(*(grads[t] for t in ("kernel", "plain", "f32")))
    say(f"[train] first-step gradients vs plain attention: {json.dumps(gres)}")
    check(not gres["failed"], f"gradient disagreement: {gres['failed']}")
    check(abs(gres["loss_kernel"] - gres["loss_plain"]) <= TRAIN_LOSS_TOL,
          "loss differs")
    del grads

    prof = _profile_step(trainer, state, batch, gen)
    prof["card"] = name_power
    say(f"[train] profile: {json.dumps(prof)}")
    _telemetry_check("op_breakdown of one [train] step", profiling.op_breakdown(
        lambda: trainer.train_step(state, batch, gen)),
        ("flash_fwd (B1)", "flash_bwd (B2)"), name_power)

    # the headline shape, batch 32 x seq 128: "auto" takes the plain
    # attention path below MIN_KERNEL_SEQ_AUTO, "flash" forces the kernels
    # (in turns: auto, flash, flash, auto; 3 warm-up + 10 timed steps each)
    hb = _bert_batch(32, 128, cfg.vocab_size, seed=1)
    trainers = {"auto": trainer, "flash": Trainer(
        BertClassifier(dataclasses.replace(cfg, attn_impl="flash"), CLASSES,
                       device=DEV, seed=None),
        _bert_loss, tcfg, device=DEV)}
    head = {impl: {"step_ms_runs": [], "flash_launches": 0, "loss_finite": True}
            for impl in trainers}
    for impl in ("auto", "flash", "flash", "auto"):
        flash_attention_fwd_lse.launches = 0
        _, hl, hs = _timed_steps(trainers[impl], state, hb, gen, 13)
        h = head[impl]
        h["step_ms_runs"].append(float(np.median(hs)) * 1e3)
        h["flash_launches"] += flash_attention_fwd_lse.launches
        h["loss_finite"] &= bool(np.isfinite(hl).all())
    hflops = 6.0 * n_params * 32 * 128 + 12.0 * L * 32 * 128 * 128 * cfg.dim
    for h in head.values():
        ms = float(np.mean(h["step_ms_runs"]))
        h.update(step_ms=ms, samples_per_s=32e3 / ms,
                 mfu=hflops / (ms / 1e3) / BF16_FLOPS)
    head["card"] = name_power
    say(f"[train] headline batch 32 x seq 128: {json.dumps(head)}")
    check(head["auto"]["flash_launches"] == 0, "auto at seq 128 ran the kernel")
    check(head["flash"]["flash_launches"] == 2 * 13 * L,
          "flash at seq 128 skipped the kernel")
    check(head["auto"]["loss_finite"] and head["flash"]["loss_finite"],
          "non-finite loss at the headline shape")
    return {"launches_fwd": k1, "launches_bwd": k2, "step_ms_median": step_s * 1e3,
            "samples_per_s": B / step_s, "mfu": flops / step_s / BF16_FLOPS}


def _lora_bert(cfg, seed: int | None = 0) -> BertClassifier:
    """BERT-base classifier with rank-8 adapters on the default targets
    (f32 masters; ``seed`` None leaves the weights for functional_call)."""
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=seed)
    return lora_init(model, torch.Generator(device=DEV).manual_seed(1),
                     rank=LORA_RANK, alpha=LORA_ALPHA)


def _eval_logits(model, batch, dtype, drop_b: bool = False) -> torch.Tensor:
    """Eval logits of ``model``'s own weights cast to ``dtype`` (with
    ``drop_b``, every ``lora_b`` zeroed: the base model)."""
    params = {k: (torch.zeros_like(p) if drop_b and k.endswith("lora_b") else p).to(dtype)
              for k, p in model.named_parameters()}
    with torch.no_grad():
        return functional_call(
            model, params, (batch["input_ids"],),
            {"attention_mask": batch["attention_mask"]}).float()


def phase_lora(name_power: str) -> dict:
    """BERT-base LoRA fine-tuning through ``Trainer(train_only="lora")``
    at [train]'s geometry: only the adapters train, every frozen leaf
    stays bit-identical, B1/B2 run in every layer (q, k and v adapters
    need dq, dk and dv), the kernels' adapter gradients agree with the
    plain attention's, and ``lora_merge`` leaves the eval logits as they
    were."""
    cfg = BertConfig.base()
    B, T, steps = 8, 512, 30
    L = cfg.num_layers
    model = _lora_bert(cfg)
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="adam",
                       learning_rate=LORA_LR, dtype="bfloat16", grad_clip_norm=1.0,
                       train_only="lora")
    trainer = Trainer(model, _bert_loss, tcfg, device=DEV)
    state0 = trainer.init_state()
    n_lora, n_total = trainable_leaf_count(state0.params)
    frozen0 = {k: p.clone() for k, p in state0.params.items() if not trainer.trainable(k)}
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    gen = torch.Generator(device=DEV).manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    state, losses, secs = _timed_steps(trainer, state0, batch, gen, steps)
    k1, k2 = flash_attention_fwd_lse.launches, flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(secs))
    # forward and the activation gradients of every product, the adapters'
    # own included (4 N a token, the embedding tables left out: their
    # forward is a gather), the adapters' weight gradients (2 N_lora),
    # attention as [train] counts it; the frozen weights' dW products are
    # not computed
    n_embed = sum(p.numel() for m in model.modules() if isinstance(m, Embedding)
                  for p in m.parameters())
    flops = ((4.0 * (n_total - n_embed) + 2.0 * n_lora) * B * T
             + 12.0 * L * B * T * T * cfg.dim)
    changed = [k for k, p in frozen0.items() if not torch.equal(state.params[k], p)]
    unmoved = [k for k in state0.params if k.endswith("lora_a")
               and torch.equal(state.params[k], state0.params[k])]
    res = {
        "model": "BERT-base classifier, LoRA r8 a16 on q,k,v,o,up,down",
        "trainable": n_lora, "total": n_total, "embedding": n_embed,
        "batch": B, "seq": T,
        "steps": steps, "lr": LORA_LR, "loss_first5_mean": first,
        "loss_last5_mean": last, "losses": losses,
        "launches_fwd": k1, "launches_bwd": k2, "expected_launches": L * steps,
        "step_ms_median": step_s * 1e3, "step_ms_min": min(secs) * 1e3,
        "step_ms_max": max(secs) * 1e3, "samples_per_s": B / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / BF16_FLOPS,
        "peak_allocated_gib": peak / 2**30, "frozen_leaves": len(frozen0),
        "frozen_changed": changed, "lora_a_unmoved": unmoved, "card": name_power,
    }
    say(f"[lora] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "non-finite LoRA loss")
    check(last < first, f"LoRA loss did not fall: {first} -> {last}")
    check(k1 == L * steps and k2 == L * steps,
          f"LoRA flash launches {k1}/{k2}, expected {L * steps} each")
    check(not changed, f"frozen leaves moved: {changed[:5]}")
    check(not unmoved, f"adapters did not move: {unmoved[:5]}")
    del frozen0
    prof = _profile_step(trainer, state, batch, gen)
    prof["card"] = name_power
    say(f"[lora] profile: {json.dumps(prof)}")

    # adapter gradients through B1/B2 against the plain attention's, and
    # both against the plain path in f32: at the first step (every lora_b
    # is 0, so every lora_a gradient is exactly 0 and the 6 L lora_b
    # leaves carry it) and at the trained state (b != 0: all 12 L leaves)
    trainers = {"kernel": trainer}
    for tag, impl, dtype in (("plain", "reference", None),
                             ("f32", "reference", "float32")):
        trainers[tag] = Trainer(
            _lora_bert(dataclasses.replace(cfg, attn_impl=impl), seed=None), _bert_loss,
            tcfg if dtype is None else dataclasses.replace(tcfg, dtype=dtype), device=DEV)
    for when, st, need in (("first-step", state0, 6 * L), ("trained", state, 12 * L)):
        gres = _grad_agreement(*(trainers[t].loss_and_grads(st.params, batch)
                                 for t in ("kernel", "plain", "f32")))
        say(f"[lora] {when} adapter gradients vs plain attention: {json.dumps(gres)}")
        check(gres["leaves"] >= need,
              f"{when}: only {gres['leaves']} adapter leaves had gradients, expected {need}")
        check(not gres["failed"], f"{when} LoRA gradient disagreement: {gres['failed']}")
        check(abs(gres["loss_kernel"] - gres["loss_plain"]) <= TRAIN_LOSS_TOL,
              f"{when} LoRA loss differs")
    del trainers

    # merge for serving: the trained adapters folded into w; bf16 eval
    # through B1 ("auto" at seq 512), f32 eval on a plain-attention twin
    # (the kernels take bf16 only)
    model.load_state_dict(state.params)
    twin = _lora_bert(dataclasses.replace(cfg, attn_impl="reference"), seed=None)
    twin.load_state_dict(state.params)
    ev = _bert_batch(B, T, cfg.vocab_size, lens=[512, 400, 256, 64], seed=3)
    un16 = _eval_logits(model, ev, torch.bfloat16)
    un32 = _eval_logits(twin, ev, torch.float32)
    effect = float((_eval_logits(twin, ev, torch.float32, drop_b=True) - un32).abs().max())
    lora_merge(model)
    lora_merge(twin)
    left = [k for k, _ in model.named_parameters() if "lora_" in k]
    f32_err = float((_eval_logits(twin, ev, torch.float32) - un32).abs().max())
    bf16_rel = _rel(_eval_logits(model, ev, torch.bfloat16), un16)
    bf16_noise = _rel(un16, un32)
    bf16_tol = max(LORA_MERGE_REL, LORA_NOISE_RATIO * bf16_noise)
    mres = {"f32_max_abs_err": f32_err, "f32_tol": LORA_MERGE_F32,
            "bf16_rel_err": bf16_rel, "bf16_unmerged_vs_f32_rel": bf16_noise,
            "bf16_tol": bf16_tol,
            "adapter_effect_f32_max_abs": effect,
            "logits_f32_max_abs": float(un32.abs().max()),
            "adapter_leaves_left": len(left), "card": name_power}
    say(f"[lora] merge: {json.dumps(mres)}")
    check(not left, "lora_merge left adapter leaves")
    check(f32_err <= LORA_MERGE_F32, f"merged f32 logits differ by {f32_err}")
    check(bf16_rel <= bf16_tol, f"merged bf16 logits differ: rel {bf16_rel}")
    check(effect > 10 * max(f32_err, 1e-6),
          f"the adapters barely move the logits ({effect}): the merge check sees nothing")
    del model, twin, trainer, state, state0
    _free_cuda()
    return {"launches_fwd": k1, "launches_bwd": k2}


def phase_checkpoint(name_power: str) -> dict:
    """Save and resume on the card: the [lora] model with every leaf
    trainable (``train_only=None``, Adam), 4 steps uninterrupted against
    2 steps, an async ``CheckpointManager`` save, a restore into a fresh
    ``init_state()`` on the card, and 2 more steps; each step's dropout
    generator is seeded from the step, so the resumed run draws the same
    masks. Params, moments and step must be bit-identical."""
    cfg = BertConfig.base()
    B, T = 8, 512
    L = cfg.num_layers
    model = _lora_bert(cfg)
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="adam",
                       learning_rate=1e-4, dtype="bfloat16", grad_clip_norm=1.0)
    trainer = Trainer(model, _bert_loss, tcfg, device=DEV)
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])

    def run(state, steps):
        for step in steps:
            gen = torch.Generator(device=DEV).manual_seed(1000 + step)
            state, _ = trainer.train_step(state, batch, gen)
        return state

    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    full = run(trainer.init_state(), range(CKPT_STEPS))
    part = run(trainer.init_state(), range(CKPT_SAVE_AT))
    torch.cuda.synchronize()
    build_root = os.path.join(_build.PKG_DIR, "_build")
    with tempfile.TemporaryDirectory(prefix="checkpoint-", dir=build_root) as d:
        with CheckpointManager(d, async_save=True) as mgr:
            t0 = time.perf_counter()
            check(mgr.save(CKPT_SAVE_AT, part), "the checkpoint save did not start")
            call_s = time.perf_counter() - t0
            mgr.wait_until_finished()
            save_s = time.perf_counter() - t0
            step_dir = os.path.join(d, str(CKPT_SAVE_AT))
            nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
            target = trainer.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed = mgr.restore(target=target)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        del target
    resumed = run(resumed, range(CKPT_SAVE_AT, CKPT_STEPS))
    k1, k2 = flash_attention_fwd_lse.launches, flash_attention_bwd.launches
    diff = [k for k in full.params if not torch.equal(full.params[k], resumed.params[k])]
    diff += [f"{m}:{k}" for m in ("m", "v") for k in full.opt_state[m]
             if not torch.equal(full.opt_state[m][k], resumed.opt_state[m][k])]
    same_step = int(full.step) == int(resumed.step) == CKPT_STEPS
    on_card = all(t.device.type == "cuda" for t in resumed.params.values())
    res = {
        "trainer": "the [lora] model, every leaf trainable, Adam lr 1e-4",
        "steps": CKPT_STEPS, "saved_at": CKPT_SAVE_AT, "leaves": len(full.params),
        "bytes_written": nbytes, "save_call_s": call_s, "save_s": save_s,
        "restore_s": restore_s, "save_gb_s": nbytes / save_s / 1e9,
        "restore_gb_s": nbytes / restore_s / 1e9, "launches_fwd": k1,
        "launches_bwd": k2, "expected_launches": L * (2 * CKPT_STEPS),
        "differing": diff[:10], "n_differing": len(diff), "step_equal": same_step,
        "restored_on_card": on_card, "card": name_power,
    }
    say(f"[checkpoint] {json.dumps(res)}")
    check(not diff and same_step, f"resume differs from the uninterrupted run: {diff[:5]}")
    check(on_card, "restored tensors are not on the card")
    check(k1 == k2 == L * 2 * CKPT_STEPS, f"checkpoint flash launches {k1}/{k2}")
    del model, trainer, full, part, resumed
    _free_cuda()
    return {"launches_fwd": k1, "launches_bwd": k2}


def _bert_trainer_name(name: str) -> str:
    """A ShardedTrainer leaf name (one stage) -> the BertClassifier's."""
    if name.startswith("embed."):
        return "bert." + name[6:]
    if name.startswith("stages."):
        return "bert.encoder." + name[7:]
    if name.startswith("head.pooler."):
        return "bert." + name[5:]
    return "head." + name[len("head.cls."):]


def _sharded_steps(tr, state, batch, n, warm=3):
    """n ShardedTrainer steps (each ended by a read of its loss) ->
    (state, losses, per-step seconds after ``warm`` steps, launches of
    B1 and B2 over the n steps)."""
    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    losses, secs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, st = tr.train_step(state, batch)
        losses.append(float(st["loss"]))
        if i >= warm:
            secs.append(time.perf_counter() - t0)
    return state, losses, secs, (flash_attention_fwd_lse.launches,
                                 flash_attention_bwd.launches)


def _flash_counts_of(fn):
    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    out = fn()
    return out, (flash_attention_fwd_lse.launches, flash_attention_bwd.launches)


def phase_sharded_bert(name_power: str, mesh, train_res: dict) -> dict:
    """BERT-base through ``bert_pipeline_parts`` and ``ShardedTrainer``
    (GPipe, 4 micros) on the one-rank mesh, against the single-host
    ``Trainer`` at 4 micros on the same params and batch."""
    cfg = BertConfig.base()
    B, T, L, M = 8, 512, cfg.num_layers, SHARD_MICRO
    tcfg = TrainConfig(batch_size=B, micro_batches=M, optimizer="adam",
                       learning_rate=1e-4, dtype="bfloat16", grad_clip_norm=1.0)
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    loss = lambda logits, b: softmax_cross_entropy(logits, b["labels"])  # noqa: E731

    # parity at dropout 0: one step's loss and gradients, sharded vs the
    # single-host Trainer (both through B1/B2), the f32 plain path beside
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    model0 = BertClassifier(cfg0, CLASSES, device=DEV, seed=0)
    params = dict(model0.named_parameters())
    tr0 = ShardedTrainer(mesh, tcfg, bert_pipeline_parts(model0.bert, params, CLASSES),
                         loss)
    st0 = tr0.init_state()
    (ls, gs), k_sh = _flash_counts_of(lambda: tr0.loss_and_grads(st0, batch))
    gs = {_bert_trainer_name(k): v for k, v in gs.items()}
    single = Trainer(model0, _bert_loss, tcfg, device=DEV)
    state_single = single.init_state()
    (lt, gt), k_single = _flash_counts_of(lambda: _micro_grads(single, state_single, batch, M))
    twin = BertClassifier(dataclasses.replace(cfg0, attn_impl="reference"), CLASSES,
                          device=DEV, seed=None)
    f32 = Trainer(twin, _bert_loss, dataclasses.replace(tcfg, dtype="float32"), device=DEV)
    lf, gf = _micro_grads(f32, state_single, batch, M)
    gres = _grad_agreement((ls, gs), (lt, gt), (lf, gf))
    rel = abs(float(ls) - float(lt)) / abs(float(lt))
    gres.update(loss_rel_diff=rel, launches_sharded=k_sh, launches_single=k_single)
    say(f"[sharded bert] first-step loss and gradients vs the single-host Trainer "
        f"at {M} micros: {json.dumps(gres)}")
    check(rel <= 1e-2, f"sharded loss {float(ls)} vs single-host {float(lt)}")
    check(not gres["failed"], f"sharded gradient disagreement: {gres['failed']}")
    check(k_sh == (L * M, L * M), f"sharded flash launches {k_sh}, expected {L * M} each")
    del gs, gt, gf, single, f32, twin

    # remat: the same loss, B1 twice a micro
    trr = ShardedTrainer(mesh, dataclasses.replace(tcfg, remat=True),
                         bert_pipeline_parts(model0.bert, params, CLASSES), loss)
    (lr_, _), k_remat = _flash_counts_of(lambda: trr.loss_and_grads(st0, batch))
    rres = {"loss": float(lr_), "loss_no_remat": float(ls), "launches": k_remat,
            "expected": (2 * L * M, L * M)}
    say(f"[sharded bert] remat: {json.dumps(rres)}")
    check(abs(float(lr_) - float(ls)) <= 1e-6 * abs(float(ls)) + 1e-6,
          f"remat loss {float(lr_)} vs {float(ls)}")
    check(k_remat == (2 * L * M, L * M), f"remat flash launches {k_remat}")
    del trr, tr0, st0, model0, params
    _free_cuda()

    # training at dropout 0.1
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=0)
    tr = ShardedTrainer(mesh, tcfg, bert_pipeline_parts(
        model.bert, dict(model.named_parameters()), CLASSES), loss,
        tracer=Tracer(), metrics=Metrics(), flight=FlightRecorder())
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state()
    steps = SHARD_BERT_STEPS
    state, losses, secs, (k1, k2) = _sharded_steps(tr, state, batch, steps)
    _train_telemetry("sharded bert", tr, "engine", steps, name_power,
                     attrs={"stages": 1, "micros": M})
    peak = torch.cuda.max_memory_allocated()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(secs))
    n_params = sum(p.numel() for p in model.parameters())
    flops = 6.0 * n_params * B * T + 12.0 * L * B * T * T * cfg.dim
    res = {
        "model": "BERT-base classifier", "mesh": tr.describe(), "batch": B, "seq": T,
        "steps": steps, "losses": losses, "loss_first5_mean": first,
        "loss_last5_mean": last, "launches_fwd": k1, "launches_bwd": k2,
        "launches_per_step": (k1 / steps, k2 / steps), "expected_per_step": L * M,
        "step_ms_median": step_s * 1e3, "step_ms_min": min(secs) * 1e3,
        "step_ms_max": max(secs) * 1e3, "samples_per_s": B / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / BF16_FLOPS,
        "train_step_ms_median": train_res["step_ms_median"],
        "train_samples_per_s": train_res["samples_per_s"],
        "peak_allocated_gib": peak / 2**30, "card": name_power,
    }
    say(f"[sharded bert] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "non-finite sharded BERT loss")
    check(last < first, f"sharded BERT loss did not fall: {first} -> {last}")
    check(k1 == k2 == L * M * steps, f"sharded BERT flash launches {k1}/{k2}")
    prof = _profile_step(tr, state, batch, None)
    prof["card"] = name_power
    say(f"[sharded bert] profile: {json.dumps(prof)}")
    del model, tr, state
    _free_cuda()
    return {"launches_fwd": k1, "launches_bwd": k2}


def _train_telemetry(tag: str, tr, prefix: str, steps: int, name_power: str,
                     attrs: dict | None = None) -> None:
    """A trainer's telemetry after ``steps`` steps of one batch shape: one
    ``{prefix}.compile_step`` span (the first call of the shape) and a
    ``{prefix}.step`` span each later step, the ``step_s`` series counted,
    no non-finite event; the single-host ``Trainer``'s ``device_time()``
    timed every step but the first."""
    spans = collections.Counter(s.name for s in tr.tracer.spans())
    snap = tr.metrics.snapshot()
    res = {"spans": dict(spans), "step_s_n": snap.get("step_s", {}).get("n", 0),
           "train_steps": snap["counters"].get("train_steps", 0),
           "nonfinite_events": tr.flight.counts.get("train_nonfinite", 0)}
    want = min(steps - 1, tr.metrics.window)
    check(spans[f"{prefix}.compile_step"] == 1 and spans[f"{prefix}.step"] == steps - 1,
          f"{tag}: {spans} spans for {steps} steps")
    check(res["step_s_n"] == want and res["train_steps"] == steps,
          f"{tag}: step_s counted {res['step_s_n']}, train_steps {res['train_steps']}")
    check(res["nonfinite_events"] == 0, f"{tag}: a non-finite step")
    if attrs is not None:
        res["span_attrs"] = tr.tracer.spans()[-1].attrs
        check(res["span_attrs"] == attrs, f"{tag}: span attrs {res['span_attrs']}")
    if hasattr(tr, "device_time"):
        dt = tr.device_time()
        check(dt is not None and dt["programs"]["train_step"]["count"] == steps - 1,
              f"{tag}: device_time() {dt}")
        res["device_time"] = {"busy_s": dt["device_busy_s"], "gap_s": dt["host_gap_s"],
                              "host_gap_frac": dt["host_gap_frac"]}
    res["card"] = name_power
    say(f"[{tag} telemetry] {json.dumps(res)}")


def _micro_grads(trainer, state, batch, micro):
    """The single-host Trainer's (loss, grads) of one step at ``micro``
    micro-batches, accumulated as ``Trainer._step`` does."""
    n = batch["input_ids"].shape[0]
    grads, losses = None, []
    for i in range(micro):
        mb = {k: v.reshape(micro, n // micro, *v.shape[1:])[i] for k, v in batch.items()}
        l_i, g = trainer.loss_and_grads(state.params, mb)
        g = {k: x.float() / micro for k, x in g.items()}
        grads = g if grads is None else {k: grads[k] + g[k] for k in grads}
        losses.append(l_i)
    return torch.stack(losses).mean(), grads


def phase_sharded_gpt2(name_power: str, mesh) -> dict:
    """GPT-2-medium at full width through ``as_pipeline_parts`` and
    ``ShardedTrainer`` under 1F1B on the one-rank mesh."""
    cfg = dataclasses.replace(GPT2Config.medium(), num_layers=SHARD_GPT2_LAYERS)
    B, T, L, M = 8, 1024, cfg.num_layers, SHARD_MICRO
    tcfg = TrainConfig(batch_size=B, micro_batches=M, optimizer="adamw",
                       learning_rate=3e-4, dtype="bfloat16", pp_schedule="1f1b")
    r = np.random.default_rng(0)
    ids = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T + 1))).to(DEV)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    loss = lambda logits, b: softmax_cross_entropy(logits, b["labels"])  # noqa: E731

    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    model0 = GPT2(cfg0, device=DEV, seed=0)
    params = dict(model0.named_parameters())
    runs = {}
    for tag, sched, dtype, impl in (("1f1b", "1f1b", "bfloat16", None),
                                    ("gpipe", "gpipe", "bfloat16", None),
                                    ("plain", "1f1b", "bfloat16", "reference"),
                                    ("f32", "1f1b", "float32", "reference")):
        m = model0 if impl is None else GPT2(dataclasses.replace(cfg0, attn_impl=impl),
                                             device=DEV, seed=None)
        tr0 = ShardedTrainer(mesh, dataclasses.replace(tcfg, pp_schedule=sched, dtype=dtype),
                             m.as_pipeline_parts(params), loss)
        st0 = tr0.init_state()
        runs[tag], counts = _flash_counts_of(lambda: tr0.loss_and_grads(st0, batch))
        runs[tag + "_launches"] = counts
        del tr0, st0, m
        _free_cuda()
    # B1/B2 under 1F1B against the plain attention on the same schedule,
    # every leaf at [train]'s thresholds (the f32 plain path decides the
    # leaves at bf16's noise floor)
    kres = _grad_agreement(runs["1f1b"], runs["plain"], runs["f32"])
    kres.update(launches_plain=runs["plain_launches"])
    say(f"[sharded gpt2] first-step 1F1B gradients vs plain attention: {json.dumps(kres)}")
    check(not kres["failed"], f"kernel gradient disagreement: {kres['failed']}")
    check(abs(kres["loss_kernel"] - kres["loss_plain"]) <= TRAIN_LOSS_TOL,
          "loss through the kernels differs from the plain attention's")
    check(runs["plain_launches"] == (0, 0), "the plain run launched B1/B2")
    gres = _grad_agreement(runs["1f1b"], runs["gpipe"], runs["f32"])
    rel = abs(float(runs["1f1b"][0]) - float(runs["gpipe"][0])) / abs(float(runs["gpipe"][0]))
    gres.update(loss_rel_diff=rel, launches_1f1b=runs["1f1b_launches"],
                launches_gpipe=runs["gpipe_launches"],
                wte_cosine=float(torch.nn.functional.cosine_similarity(
                    runs["1f1b"][1]["embed.wte.table"].flatten().double(),
                    runs["gpipe"][1]["embed.wte.table"].flatten().double(), dim=0)))
    say(f"[sharded gpt2] first-step 1F1B vs GPipe loss and gradients: {json.dumps(gres)}")
    check(rel <= 1e-2, "1F1B and GPipe losses differ")
    check(not gres["failed"], f"1F1B gradient disagreement: {gres['failed']}")
    check(runs["1f1b_launches"] == (L * M, L * M) and runs["gpipe_launches"] == (L * M, L * M),
          f"flash launches 1F1B {runs['1f1b_launches']} GPipe {runs['gpipe_launches']}")
    # the seq-1 step [sp2 gpt2] is held against, in host memory
    seq1 = {t: (float(runs[t][0]), {k: v.float().cpu() for k, v in runs[t][1].items()})
            for t in ("1f1b", "f32")}
    del runs, model0, params
    _free_cuda()

    model = GPT2(cfg, device=DEV, seed=0)
    tr = ShardedTrainer(mesh, tcfg, model.as_pipeline_parts(), loss)
    torch.cuda.reset_peak_memory_stats()
    state = tr.init_state()
    steps = SHARD_GPT2_STEPS
    state, losses, secs, (k1, k2) = _sharded_steps(tr, state, batch, steps)
    peak = torch.cuda.max_memory_allocated()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(secs))
    n_params = sum(p.numel() for p in model.parameters())
    # 6 N a token for the weight products (wte counted once: its lookup is
    # free, its tied head product is a full one), causal attention's
    # score and value products 6 L T^2 d a sequence (half of 12)
    flops = 6.0 * n_params * B * T + 6.0 * L * B * T * T * cfg.dim
    res = {
        "model": "GPT-2-medium", "mesh": tr.describe(), "batch": B, "seq": T,
        "steps": steps, "losses": losses, "loss_first5_mean": first,
        "loss_last5_mean": last, "launches_fwd": k1, "launches_bwd": k2,
        "launches_per_step": (k1 / steps, k2 / steps), "expected_per_step": L * M,
        "step_ms_median": step_s * 1e3, "step_ms_min": min(secs) * 1e3,
        "step_ms_max": max(secs) * 1e3, "tokens_per_s": B * T / step_s,
        "flops_per_step": flops, "mfu_formula": "(6 N B T + 6 L B T^2 d) / step_s / 989e12",
        "mfu": flops / step_s / BF16_FLOPS, "peak_allocated_gib": peak / 2**30,
        "card": name_power,
    }
    say(f"[sharded gpt2] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "non-finite sharded GPT-2 loss")
    check(last < first, f"sharded GPT-2 loss did not fall: {first} -> {last}")
    check(k1 == k2 == L * M * steps, f"sharded GPT-2 flash launches {k1}/{k2}")
    prof = _profile_step(tr, state, batch, None)
    prof["card"] = name_power
    say(f"[sharded gpt2] profile: {json.dumps(prof)}")
    bub = tr.measure_bubble(state, batch, repeats=1)
    bub["card"] = name_power
    say(f"[sharded gpt2] measured bubble: {json.dumps(bub)}")
    check(bub["closed_form_bubble_fraction"] == 0.0, "closed-form bubble at S 1 is not 0")
    del model, tr, state
    _free_cuda()
    return {"launches_fwd": k1, "launches_bwd": k2, "seq1": seq1}


def phase_sharded(name_power: str, train_res: dict) -> tuple[dict, dict]:
    """The two sharded legs on one NCCL rank; the group is destroyed
    when they end, failed or not."""
    mesh = make_mesh(MeshConfig())
    say(f"[sharded] mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} backend "
        f"{torch.distributed.get_backend()}")
    try:
        bert = phase_sharded_bert(name_power, mesh, train_res)
        gpt2 = phase_sharded_gpt2(name_power, mesh)
    finally:
        shutdown_distributed()
    return bert, gpt2


def _sp_attention(rank: int, world: int, group) -> dict:
    """[sp attention] on this rank: each SP_CASES case's whole q, k, v,
    do (from a seed, the same on every rank) through the whole-sequence
    B1/B2 (``ops.flash.flash_attention``, the reference), then this
    rank's token shard through the ring (``sp.ring_flash_attention``) and
    Ulysses (``sp.ulysses_attention_local``), forward and backward, each
    with its launches counted from 0 and held to [flash]'s tolerances
    against the reference's slice."""
    from tensorlink_tpu_torch.ops.flash import flash_attention
    from tensorlink_tpu_torch.parallel import sp

    g = torch.Generator().manual_seed(13)
    out = {}
    for name, (B, H, Hkv, T, D, causal, mask) in SP_CASES.items():
        q, k, v, do, kv = (None if x is None else
                           x.transpose(1, 2) if x.dim() == 4 else x
                           for x in _flash_inputs(g, B, H, Hkv, T, D, mask))
        # [B, T, heads, D]: the attention module's layout
        whole = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ro = flash_attention(*whole, kv, causal)
        ro.backward(do)
        ref = [ro.detach()] + [x.grad for x in whole]
        Tl = T // world
        sl = slice(rank * Tl, (rank + 1) * Tl)
        for impl in ("ring", "ulysses"):
            loc = [x[:, sl].detach().clone().requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            with sp.seq_parallel(group):
                if impl == "ring":
                    o = sp.ring_flash_attention(*loc, kv, causal)
                else:
                    o = sp.ulysses_attention_local(
                        *loc, causal=causal,
                        mask=None if kv is None else kv[:, None, None, :])
                o.backward(do[:, sl])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = _counts()
            got = [o.detach()] + [x.grad for x in loc]
            rels = {n: _rel(a, b[:, sl]) for n, a, b in zip(("o", "dq", "dk", "dv"),
                                                           got, ref)}
            errs = {n: float((a.float() - b[:, sl].float()).abs().max())
                    for n, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
            o_ok = bool((((got[0].float() - ref[0][:, sl].float()).abs())
                         <= FLASH_O_ATOL + FLASH_O_RTOL * ref[0][:, sl].float().abs()).all())
            tag = f"sp attention {impl} {name}"
            # a causal ring launches on the blocks not ahead: r + 1 on rank r
            n_ring = rank + 1 if causal else world
            want = ((n_ring, {"own": 0, "delta": n_ring}) if impl == "ring"
                    else (1, {"own": 1, "delta": 0}))
            res = {"rank": rank, "wall_s": wall, "max_abs_err": errs, "rel_frobenius": rels,
                   "launches": {"flash_fwd": c["flash_fwd"],
                                "flash_bwd_by_form": c["flash_bwd_by_form"]},
                   "expected": {"flash_fwd": want[0], "flash_bwd_by_form": want[1]}}
            say(f"[{tag}] {json.dumps(res)}")
            check(o_ok and rels["o"] <= FLASH_O_REL,
                  f"{tag}: rank {rank}'s o against the whole sequence's: {errs}, {rels}")
            check(max(rels[n] for n in ("dq", "dk", "dv")) <= FLASH_GRAD_REL,
                  f"{tag}: rank {rank}'s gradients against the whole sequence's: {rels}")
            check(c["flash_fwd"] == want[0] and c["flash_bwd_by_form"] == want[1],
                  f"{tag}: rank {rank} launched {c}, expected {want}")
            out[(impl, name)] = res
        del q, k, v, do, whole, ro, ref, loc, o, got
        _free_cuda()
    return out


def _sp2_gpt2(rank: int, world: int, mesh, out_dir: str) -> dict:
    """[sp2 gpt2] on this rank: GPT-2-medium with ``attn_impl="ring"``
    (dropout 0, seed 0: [sharded gpt2]'s params) through ``ShardedTrainer``
    under 1F1B on the seq mesh; the first step's loss and gradients (rank
    0 saves them for the parent), then SP2_STEPS steps, the last under
    the profiler, B1 and B2's delta form counted per rank a step."""
    cfg = dataclasses.replace(GPT2Config.medium(), num_layers=SHARD_GPT2_LAYERS,
                              dropout=0.0, attn_impl="ring")
    B, T, L, M = 8, 1024, cfg.num_layers, SHARD_MICRO
    tcfg = TrainConfig(batch_size=B, micro_batches=M, optimizer="adamw",
                       learning_rate=3e-4, dtype="bfloat16", pp_schedule="1f1b")
    r = np.random.default_rng(0)
    ids = torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T + 1))).to(DEV)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    loss = lambda logits, b: softmax_cross_entropy(logits, b["labels"])  # noqa: E731
    model = GPT2(cfg, device=DEV, seed=0)
    tr = ShardedTrainer(mesh, tcfg, model.as_pipeline_parts(), loss, device=DEV)
    state = tr.init_state()
    per_step = L * M * (rank + 1)  # the causal ring's blocks not ahead
    _zero_counts()
    lg, grads = tr.loss_and_grads(state, batch)
    c = _counts()
    check(c["flash_fwd"] == per_step and c["flash_bwd_by_form"] == {"own": 0, "delta": per_step},
          f"sp2 gpt2: rank {rank}'s first step launched {c}, expected B1 and B2's "
          f"delta form {per_step} each")
    if rank == 0:
        torch.save({"loss": float(lg), "grads": {k: v.float().cpu() for k, v in grads.items()}},
                   os.path.join(out_dir, "sp2_grads.pt"))
    del grads
    _free_cuda()
    _zero_counts()
    # SP2_STEPS steps, the last under the profiler
    state, losses, secs, _ = _sharded_steps(tr, state, batch, SP2_STEPS - 1, warm=0)
    prof = _profile_step(tr, state, batch, None)
    losses.append(prof["loss"])
    k1, k2 = flash_attention_fwd_lse.launches, flash_attention_bwd.launches
    by_form = dict(flash_attention_bwd.launches_by_form)
    check(k1 == k2 == by_form["delta"] == per_step * SP2_STEPS,
          f"sp2 gpt2: rank {rank} launched B1 {k1}, B2 {k2} ({by_form}) in "
          f"{SP2_STEPS} steps, expected {per_step} a step")
    check(all(np.isfinite(losses)), "sp2 gpt2: non-finite loss")
    res = {"rank": rank, "mesh": tr.describe(), "first_loss": float(lg), "losses": losses,
           "step_ms": [x * 1e3 for x in secs], "launches_per_step": per_step,
           "launches": {"flash_fwd": k1, "flash_bwd": k2, "flash_bwd_by_form": by_form},
           "profile": {k: prof[k] for k in ("profiled_step_s", "device_busy_s",
                                            "device_busy_share", "kernel_ms_by_group")},
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    del model, tr, state
    _free_cuda()
    return res


def _sp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the [sp *] job: a gloo group of two ranks on cuda:0,
    a seq mesh of CUDA tensors over it; [sp attention], then [sp2 gpt2].
    Rank 0 prints; every gate raises in the rank that fails."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(DistributedConfig(coordinator=f"file://{store}",
                                             num_processes=world, process_id=rank),
                           device="cpu")
    try:
        mesh = make_mesh(MeshConfig(seq=world), device="cuda")
        group = mesh.get_group("seq")
        if rank == 0:
            say(f"[sp] seq group of {world} over {torch.distributed.get_backend(group)} "
                "on cuda:0: ring hops through pinned host buffers, all-to-alls direct")
        res = {"attention": _sp_attention(rank, world, group),
               "gpt2": _sp2_gpt2(rank, world, mesh, out_dir)}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def phase_sp(name_power: str, seq1: dict) -> dict:
    """[sp attention] and [sp2 gpt2]: one job of SP_WORLD spawned ranks
    over gloo on cuda:0 (``_sp_rank``); here, [sp2 gpt2]'s first-step
    loss and every gradient leaf against ``seq1``, [sharded gpt2]'s 1F1B
    step at seq 1 (its f32 plain-attention step deciding the leaves at
    bf16's noise floor, as there). -> the job's launches of B1 and B2 by
    form, summed over ranks."""
    d = tempfile.mkdtemp(prefix="sp-", dir=os.path.join(_build.PKG_DIR, "_build"))
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _sp_rank, args=(SP_WORLD, os.path.join(d, "store"), d), nprocs=SP_WORLD,
        start_method="spawn", join=True)
    job_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(SP_WORLD)]
    sp2 = torch.load(os.path.join(d, "sp2_grads.pt"), weights_only=False)
    shutil.rmtree(d, ignore_errors=True)
    def dev(run):  # the per-leaf cosines on the card
        return run[0], {k: v.to(DEV) for k, v in run[1].items()}

    gres = _grad_agreement(dev((sp2["loss"], sp2["grads"])), dev(seq1["1f1b"]),
                           dev(seq1["f32"]))
    rel = abs(sp2["loss"] - float(seq1["1f1b"][0])) / abs(float(seq1["1f1b"][0]))
    gres.update(loss_rel_diff=rel)
    say(f"[sp2 gpt2] first step at seq 2 (ring) vs seq 1 ([sharded gpt2], 1F1B): "
        f"{json.dumps(gres)}")
    check(rel <= TRAIN_LOSS_TOL, f"sp2 gpt2: loss {sp2['loss']} vs seq 1's")
    check(not gres["failed"], f"sp2 gpt2: gradient disagreement {gres['failed']}")
    g = [r["gpt2"] for r in ranks]
    check(all(np.allclose(x["losses"], g[0]["losses"], rtol=0, atol=0) for x in g),
          "sp2 gpt2: the ranks report different losses")
    res = {"job_s": job_s, "first_loss": g[0]["first_loss"], "losses": g[0]["losses"],
           "step_ms_rank0": g[0]["step_ms"],
           "step_ms_median_rank0": (float(np.median(g[0]["step_ms"])) if g[0]["step_ms"]
                                    else g[0]["profile"]["profiled_step_s"] * 1e3),
           "launches_per_step": [x["launches_per_step"] for x in g],
           "profile_rank0": g[0]["profile"],
           "peak_allocated_gib": [x["peak_allocated_gib"] for x in g],
           "transport": "gloo on one card, ring hops through pinned host buffers",
           "card": name_power}
    say(f"[sp2 gpt2] {json.dumps(res)}")
    del sp2
    fwd = sum(r["gpt2"]["launches"]["flash_fwd"] + r["gpt2"]["launches_per_step"]
              + sum(a["launches"]["flash_fwd"] for a in r["attention"].values())
              for r in ranks)
    own = sum(a["launches"]["flash_bwd_by_form"]["own"]
              for r in ranks for a in r["attention"].values())
    delta = sum(r["gpt2"]["launches"]["flash_bwd_by_form"]["delta"]
                + r["gpt2"]["launches_per_step"]
                + sum(a["launches"]["flash_bwd_by_form"]["delta"]
                      for a in r["attention"].values()) for r in ranks)
    return {"launches_fwd": fwd, "launches_bwd": own + delta, "launches_delta": delta}


PHASE_S: dict[str, float] = {}  # seconds each phase took, in run order


# ----------------------------------------------------- roles that touch tensors
ROLES_BATCH = (8, 512)  # [roles train]: BERT-base activations [8, 512, 768]
ROLES_MICRO = 2
ROLES_STEPS = 3  # 5 before the zoo's legs
ROLES_LR = 0.1
# step 1's loss against the 12 blocks run in one process on the same
# micros: both sides run the same kernels in bf16 at the same shapes
# (the stage cut passes the bf16 activation unchanged) and reduce the
# MSE in f32, so they agree to f32 summation order
ROLES_LOSS_REL = 1e-3
PIPE_REQUESTS = 4  # [pipeserve]: [slice]'s first requests
PIPE_NEW = 32
PIPE_SPANS = ((0, 16), (16, 32))


class _CodecTally:
    """Wraps the wire codec names the role modules call (``pack_arrays``,
    ``unpack_arrays``) to sum their seconds and the bytes they produce
    or read, over every thread of the process."""

    def __init__(self, *modules):
        self.modules = modules
        self.lock = threading.Lock()
        self.seconds = 0.0
        self.bytes = 0
        self._orig = []

    def _wrap(self, fn, packs: bool):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            with self.lock:
                self.seconds += dt
                if packs:
                    self.bytes += len(out)
            return out

        return run

    def __enter__(self):
        for m in self.modules:
            for name, packs in (("pack_arrays", True), ("unpack_arrays", False)):
                if hasattr(m, name):
                    self._orig.append((m, name, getattr(m, name)))
                    setattr(m, name, self._wrap(getattr(m, name), packs))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._orig:
            setattr(m, name, fn)

    def take(self) -> tuple[float, int]:
        with self.lock:
            out = (self.seconds, self.bytes)
            self.seconds, self.bytes = 0.0, 0
        return out


def _roles_fleet(loop: _NodeLoop, n_workers: int):
    """A port validator, ``n_workers`` port workers and a user, started on
    ``loop`` over 127.0.0.1, every device-bound role on the card."""
    def cfg(role):
        return NodeConfig(role=role, host="127.0.0.1", port=0, capability_bench=False)

    async def up():
        val = ValidatorNode(cfg("validator"), registry=InMemoryRegistry(), device=DEV)
        await val.start()
        ws = []
        for _ in range(n_workers):
            w = WorkerNode(cfg("worker"), device=DEV)
            await w.start()
            await w.connect("127.0.0.1", val.port)
            ws.append(w)
        user = UserNode(cfg("user"))
        await user.start()
        vpeer = await user.connect("127.0.0.1", val.port)
        return val, ws, user, vpeer

    return loop.run(up())


def phase_roles_train(name_power: str) -> dict:
    """[roles train]: a port ValidatorNode, two port WorkerNodes and a
    UserNode train BERT-base's 12 post-LN blocks (``Bert(BertConfig.
    base())``'s encoder, bf16 matrices, f32 norms and biases) split by
    ``max_stage_bytes`` into 6 + 6 blocks, one stage a worker: ROLES_STEPS SGD steps
    on [8, 512, 768] bf16 inputs from a seed in 2 micro-batches, an MSE
    loss against a seeded target computed by the user with autograd.
    Gates: step 1's loss equals the 12 blocks run in this process on the
    same micros (ROLES_LOSS_REL); the last step's is below step 1's; B1 runs
    2 x 12 x 2 times a step (each stage's forward and its backward's
    recompute, a layer a micro) and B2 12 x 2; an audit of stage 0
    passes by exact digest (worker and validator both ``torch-cuda``,
    cuBLAS deterministic) while, at the same time, an audit of stage 1,
    whose worker computes with perturbed params but reports the real
    ones, fails; the two audits launch B1 = B2 = 24 (6 layers on each
    side of each). Prints the step wall, the codec's share and the
    bytes shipped a step, and the codec on one micro's activation."""
    from tensorlink_tpu_torch.roles import user as user_mod
    from tensorlink_tpu_torch.roles import worker as worker_mod

    cfg = BertConfig.base()
    bert = Bert(cfg, device=DEV, dtype=torch.float32, seed=0)
    blocks = bert.encoder.blocks()
    seq = RolesSequential(blocks)
    apply_dtype_policy(seq, torch.bfloat16, torch.device(DEV))
    params = {k: v.detach().clone() for k, v in seq.named_parameters()}
    per_block = sum(t.numel() * t.element_size() for k, t in params.items()
                    if k.startswith("0."))
    g = torch.Generator().manual_seed(11)
    B, T = ROLES_BATCH
    x = torch.randn((B, T, cfg.dim), generator=g).to(torch.bfloat16)
    target = torch.randn((B, T, cfg.dim), generator=g) + 1.0
    # the same 12 blocks in this process, on the same micros
    with torch.no_grad():
        ref = [float(F.mse_loss(seq(xm.to(DEV)).float(), tm.to(DEV)))
               for xm, tm in zip(torch.tensor_split(x, ROLES_MICRO),
                                 torch.tensor_split(target, ROLES_MICRO))]
    ref_loss = float(np.mean(ref))
    del bert

    def loss_grad(out, micro):
        o = out.float().requires_grad_(True)
        loss = F.mse_loss(o, torch.tensor_split(target, ROLES_MICRO)[micro])
        (go,) = torch.autograd.grad(loss, o)
        return float(loss.detach()), go.to(out.dtype)

    loop = _NodeLoop()
    val, ws, user, vpeer = _roles_fleet(loop, 2)
    res = {"card": name_power}
    try:
        job = loop.run(user.request_job(
            seq, params, vpeer, max_stage_bytes=6 * per_block + per_block // 2,
            micro_batches=ROLES_MICRO,
            train={"optimizer": "sgd", "learning_rate": ROLES_LR}), timeout=600)
        spans = [len(job.job.stages[i].module_config["__children__"])
                 for i in range(job.job.n_stages)]
        check(spans == [6, 6] and len({st.peer.node_id for st in job.stages}) == 2,
              f"roles train: stages {spans} not 6 + 6 on two workers")
        losses, walls, codec_s, codec_b, launches = [], [], [], [], []
        with _CodecTally(user_mod, worker_mod) as tally:
            for _ in range(ROLES_STEPS):
                _zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(loop.run(job.train_step(x, loss_grad), timeout=600))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                s, b = tally.take()
                codec_s.append(s)
                codec_b.append(b)
                launches.append((flash_attention_fwd_lse.launches,
                                 flash_attention_bwd.launches))
        want = (2 * 12 * ROLES_MICRO, 12 * ROLES_MICRO)
        res.update(losses=losses, in_process_step1_loss=ref_loss,
                   step1_rel=abs(losses[0] - ref_loss) / abs(ref_loss),
                   step_wall_s=walls, codec_s=codec_s,
                   codec_share=[s / w for s, w in zip(codec_s, walls)],
                   bytes_per_step=codec_b, launches_per_step=launches,
                   expected_launches_per_step=want)
        check(res["step1_rel"] <= ROLES_LOSS_REL,
              f"roles train: step 1 loss {losses[0]} vs in-process {ref_loss}")
        check(losses[-1] < losses[0], f"roles train: loss did not fall {losses}")
        check(all(tuple(c) == want for c in launches),
              f"roles train: B1/B2 launches {launches}, expected {want} a step")
        jid = job.job.job_id
        shape = (B // ROLES_MICRO, T, cfg.dim)
        # stage 1's worker computes its proof with perturbed params but
        # reports (and ships) the real ones; both audits run at once
        holder = next(w for w in ws if w.node_id == job.stages[1].peer.node_id)
        runner = holder.stages[(jid, 1)]
        honest = runner.pol
        perturbed = {k: v + 1e-2 if v.dim() == 1 else v for k, v in runner.params.items()}
        runner.pol = lambda p, xx: honest(perturbed, xx)
        _zero_counts()

        async def audits():
            return await asyncio.gather(val.audit_stage(jid, 0, in_shape=shape, seed=5),
                                        val.audit_stage(jid, 1, in_shape=shape, seed=6))

        rec, bad = loop.run(audits(), timeout=600)
        runner.pol = honest
        audit_launches = (flash_attention_fwd_lse.launches, flash_attention_bwd.launches)
        check(rec["passed"] is True, f"roles train: honest audit failed {rec}")
        check(bad["passed"] is False and bad["forward_ok"] is False,
              f"roles train: perturbed audit passed {bad}")
        check(audit_launches == (24, 24),
              f"roles train: audit launches {audit_launches}, expected (24, 24)")
        res.update(audit=rec["passed"], perturbed_audit=bad["passed"],
                   audit_launches=audit_launches)
        loop.run(job.shutdown())
    finally:
        for n in (user, val, *ws):
            loop.run(n.stop())
        loop.close()
    # the codec alone on one micro's activation (the default codec)
    xm = torch.tensor_split(x, ROLES_MICRO)[0]
    t0 = time.perf_counter()
    blob = pack_arrays({"x": xm})
    t1 = time.perf_counter()
    unpack_arrays(blob)
    t2 = time.perf_counter()
    codec = {"raw_bytes": xm.numel() * xm.element_size(), "packed_bytes": len(blob),
             "pack_s": t1 - t0, "unpack_s": t2 - t1, "card": name_power}
    say(f"[roles train codec] {json.dumps(codec)}")
    say(f"[roles train] {json.dumps(res)}")
    _free_cuda()
    return {"launches_fwd": sum(f for f, _ in launches) + audit_launches[0],
            "launches_bwd": sum(b for _, b in launches) + audit_launches[1]}


def _first_departure(model, prompt, out, ref) -> dict | None:
    """Where a stream first departs from [slice]'s tokens: the position
    and the teacher-forced logit margin there (the model's logit of
    [slice]'s token less that of this stream's)."""
    diff = [i for i, (a, b) in enumerate(zip(out, ref)) if int(a) != int(b)]
    if not diff:
        return None
    i = diff[0]
    ids = np.concatenate([prompt, np.asarray(out[:i], prompt.dtype)])
    with torch.no_grad():
        h = model(torch.from_numpy(ids).to(DEV)[None], logits=False)
        row = model.head(h[0, -1]).float()
    return {"position": i, "margin": float(row[int(ref[i])] - row[int(out[i])])}


def phase_pipeserve(name_power: str, model: Llama, prompts, slice_outs) -> dict:
    """[pipeserve]: two port WorkerNodes each attach one ``pipeline_stage``
    of one ``InferenceEngine`` over [slice]'s Llama-3-8B (layers [0, 16)
    and [16, 32): the stages reference the model's tensors, nothing is
    copied), a port ValidatorNode plans, and a UserNode's
    ``RemoteServingClient`` submits [slice]'s first 4 prompts, 32 greedy
    tokens each. Gates: each stream equals [slice]'s tokens or, where it
    departs (other batches, other GEMM shapes: bf16 near-ties), every
    token is within LOGIT_GAP_TOL of the teacher-forced row max, as the
    [tp2 *] legs gate; B3 launches = 16 a stage a decode tick and a
    prefill chunk, B4 = 16 a stage a tick. Prints TTFT (a one-token
    request) and the time a token takes."""
    prompts = prompts[:PIPE_REQUESTS]
    refs = slice_outs[:PIPE_REQUESTS]
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    loop = _NodeLoop()
    val, ws, user, vpeer = _roles_fleet(loop, 2)
    kw = dict(slots=PIPE_REQUESTS, gen=GenerationConfig(max_new_tokens=PIPE_NEW),
              block_size=16, prefill_chunk=128)
    res = {"card": name_power}
    try:
        (lo0, hi0), (lo1, hi1) = PIPE_SPANS
        check(list(PIPE_SPANS) == stage_spans(layer_param_bytes(model), [1.0, 1.0]),
              "pipeserve: the spans are not stage_spans' even cut")
        ws[1].pipeline_stage(eng, sid="p", stage=1, n_stages=2, lo=lo1, hi=hi1, **kw)
        vw = loop.run(ws[0].connect("127.0.0.1", val.port))
        ws[0].pipeline_stage(eng, sid="p", stage=0, n_stages=2, lo=lo0, hi=hi0,
                             route=[{"node_id": ws[1].node_id, "host": "127.0.0.1",
                                     "port": ws[1].port}], validator=vw, **kw)
        own = {k for k, _ in model.named_parameters()}
        shared = all(t is dict(model.named_parameters())[k]
                     for w in ws for k, t in w._pipe_stage.params.items() if k in own)
        check(shared, "pipeserve: a stage copied a weight")
        for w in ws:
            loop.run(val.ping(loop.run(val.connect("127.0.0.1", w.port))))
        client = user.remote_serving(vpeer, pipeline=True, sid="p")
        # TTFT: one request of one token, after a warm-up of the same
        warm = loop.run(client.submit(prompts[0], max_new=1), timeout=300)
        loop.run(client.result(warm), timeout=300)
        t0 = time.perf_counter()
        rid = loop.run(client.submit(prompts[0], max_new=1))
        loop.run(client.result(rid), timeout=300)
        ttft = time.perf_counter() - t0
        coord = ws[0].serving
        ticks0, chunks0 = coord._ticks, ws[0]._pipe_stage._steps["prefill"]
        _zero_counts()
        t0 = time.perf_counter()
        rids = [loop.run(client.submit(p)) for p in prompts]
        outs = [np.asarray(loop.run(client.result(r), timeout=600)) for r in rids]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        by_variant = dict(paged_decode_attention.launches_by_variant)
        ticks = coord._ticks - ticks0
        chunks = ws[0]._pipe_stage._steps["prefill"] - chunks0
        L = model.cfg.num_layers
        want = {"paged": L * (ticks + chunks), "norm": L * ticks}
        res.update(ttft_s=ttft, wall_s=wall, ticks=ticks, prefill_chunks=chunks,
                   ms_per_token=(wall - ttft) / (PIPE_NEW - 1) * 1e3,
                   launches={"paged_decode": c["paged_decode"], "fused_norm": c["fused_norm"],
                             "by_variant": by_variant},
                   expected=want, act_wire_bytes=coord.stats()["pipeline"]["act_wire_bytes"],
                   stage_stats=[w._pipe_stage.stats() for w in ws])
        check(c["paged_decode"] == want["paged"] > 0
              and by_variant == {"general": 0, "decode": L * ticks, "prefill": L * chunks},
              f"pipeserve: paged-decode launches {c['paged_decode']} {by_variant}, "
              f"expected {want['paged']}")
        check(c["fused_norm"] == want["norm"] > 0,
              f"pipeserve: fused-norm launches {c['fused_norm']}, expected {want['norm']}")
        check(c["flash_fwd"] == c["flash_bwd"] == 0, "pipeserve: flash ran")
        check(all(len(o) == PIPE_NEW for o in outs), "pipeserve: a stream is short")
        res["departures"] = [_first_departure(model, p, o, r)
                             for p, o, r in zip(prompts, outs, refs)]
        res["streams_equal_to_slice"] = sum(d is None for d in res["departures"])
        tf = _teacher_forced("pipeserve", model, prompts, outs)
        res["worst_gap"] = tf["worst_gap"]
    finally:
        for n in (user, val, *ws):
            loop.run(n.stop())
        loop.close()
    say(f"[pipeserve] {json.dumps(res)}")
    del eng
    _free_cuda()
    return {"paged": res["launches"]["paged_decode"], "norm": res["launches"]["fused_norm"]}


# ----------------------------------------------- slice 19: the model zoo
# HF-layout checkpoints are written here by a small writer of the
# safetensors format (the package reads the format and writes none) into a
# temporary directory under _build/, and read back by the port's
# ``load_safetensors``.
ST_DTYPES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
HF_LOSS_REL = 1e-4  # [hf bert f32]: step 1's loss, B1/B2 f32 vs plain f32
HF_BERT_STEPS = 3
BERT_F16_LOSS_REL = 1e-3  # [bert f16]: the loss, B1/B2 f16 vs plain f16
# ... and its gradients, by [train]'s rule (``_grad_agreement``) with a
# direct cosine of 0.999 with plain f16 attention's (an error of e of a
# leaf's norm costs about e^2 / 2 of cosine: 0.999 admits 4.5%). Below
# it, a leaf passes only where plain f16 attention is itself off the f32
# gradient (cosine < TRAIN_SIGNAL_COSINE) and the kernels are no farther
# from it than TRAIN_NOISE_RATIO times plain's: plain attention rounds its
# scores, probabilities and dP to f16, which leaves the q and k gradients
# of the deeper layers near f16's noise, where the kernels keep them in f32
BERT_F16_GRAD_COS = 0.999
HF_LLAMA_LAYERS = 2  # [hf llama]: Llama-3-8B's width at 2 of its 32 layers
HF_LLAMA_F16_REQUESTS = 2  # and its f16 sibling's prompts (of [slice]'s)
T5_LENS = (64, 512, 200, 320, 96, 448, 150, 256)  # [t5]: padded sources
T5_NEW = 32
T5_STEPS = 3
VIT_BATCH = 32
VIT_CLASSES = 10
VIT_STEPS = 3
VIT_LOSS_REL = 1e-2  # [vit]: Trainer vs ShardedTrainer first loss (bf16)
INGEST_TOL = 1e-4  # [ingest]: the native forward vs the torch module's
# the zoo legs' 3 training steps on one batch: SGD with the gradient
# clipped to norm 1, so each step moves the weights along the gradient by
# at most its rate (on an H100 80GB HBM3 at 700 W, Adam's first steps on
# random weights at these widths jumped BERT-base's loss 1.19 -> 3.29 ->
# 2.07, and SGD at 0.05 went 1.19 -> 2.11 -> 1.10: a sharp valley, so
# BERT takes 1e-3)
ZOO_SGD_LR = 0.05
HF_BERT_LR = 1e-3


def _write_safetensors(path: str, tensors: dict) -> int:
    """{name: CPU tensor} -> a .safetensors file (8-byte little-endian
    header length, a JSON header padded to 8 bytes, the raw bytes). ->
    the file's size."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for t in tensors.values():
            if t.numel():
                f.write(t.contiguous().view(torch.uint8).numpy().data)
    return 8 + len(h) + off


def _hf_layout(state: dict, pairs) -> dict:
    """A port state dict -> HF names: ``pairs`` of (HF name, port name,
    transform or None); CPU tensors in the state's dtypes."""
    out = {}
    for hf, name, fn in pairs:
        t = state[name].detach()
        out[hf] = (t if fn is None else fn(t)).cpu().contiguous()
    return out


def _T(t):  # our [in, out] -> torch Linear's [out, in]
    return t.T


def _bert_hf_pairs(cfg) -> list:
    pairs = [("embeddings.word_embeddings.weight", "tok_emb.table", None),
             ("embeddings.position_embeddings.weight", "pos_emb.table", None),
             ("embeddings.token_type_embeddings.weight", "type_emb.table", None),
             ("embeddings.LayerNorm.weight", "emb_norm.scale", None),
             ("embeddings.LayerNorm.bias", "emb_norm.bias", None),
             ("pooler.dense.weight", "pooler.w", _T), ("pooler.dense.bias", "pooler.b", None)]
    for i in range(cfg.num_layers):
        hf, p = f"encoder.layer.{i}.", f"encoder.{i}."
        for h, n in (("attention.self.query", "attn.q"), ("attention.self.key", "attn.k"),
                     ("attention.self.value", "attn.v"), ("attention.output.dense", "attn.o"),
                     ("intermediate.dense", "mlp.up"), ("output.dense", "mlp.down")):
            pairs += [(hf + h + ".weight", p + n + ".w", _T), (hf + h + ".bias", p + n + ".b", None)]
        for h, n in (("attention.output.LayerNorm", "norm1"), ("output.LayerNorm", "norm2")):
            pairs += [(hf + h + ".weight", p + n + ".scale", None),
                      (hf + h + ".bias", p + n + ".bias", None)]
    return pairs


def _llama_hf_pairs(cfg) -> list:
    pairs = [("model.embed_tokens.weight", "tok_emb.table", None),
             ("model.norm.weight", "norm_f.scale", None), ("lm_head.weight", "lm_head.w", _T)]
    for i in range(cfg.num_layers):
        hf, p = f"model.layers.{i}.", f"blocks.{i}."
        pairs += [(hf + "input_layernorm.weight", p + "norm1.scale", None),
                  (hf + "post_attention_layernorm.weight", p + "norm2.scale", None)]
        pairs += [(hf + f"self_attn.{n}_proj.weight", p + f"attn.{n}.w", _T) for n in "qkvo"]
        pairs += [(hf + f"mlp.{n}_proj.weight", p + f"mlp.{n}.w", _T)
                  for n in ("up", "gate", "down")]
    return pairs


def _t5_hf_pairs(cfg) -> list:
    """T5 v1.0 (the tied ReLU form T5-small ships)."""
    pairs = [("shared.weight", "shared.table", None),
             ("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
              "enc_rel.w", None),
             ("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
              "dec_rel.w", None),
             ("encoder.final_layer_norm.weight", "enc_norm.scale", None),
             ("decoder.final_layer_norm.weight", "dec_norm.scale", None)]
    for side, tag in (("encoder", "enc"), ("decoder", "dec")):
        for i in range(cfg.num_layers):
            hf, p = f"{side}.block.{i}.layer.", f"{tag}{i}."
            attns = [("0", "SelfAttention", "norm1", "attn")]
            if side == "decoder":
                attns.append(("1", "EncDecAttention", "norm_x", "xattn"))
            for n, kind, norm, attn in attns:
                pairs.append((hf + f"{n}.layer_norm.weight", p + norm + ".scale", None))
                pairs += [(hf + f"{n}.{kind}.{x}.weight", p + f"{attn}.{x}.w", _T)
                          for x in "qkvo"]
            ff = "2" if side == "decoder" else "1"
            pairs += [(hf + f"{ff}.layer_norm.weight", p + "norm2.scale", None),
                      (hf + f"{ff}.DenseReluDense.wi.weight", p + "ff.up.w", _T),
                      (hf + f"{ff}.DenseReluDense.wo.weight", p + "ff.down.w", _T)]
    return pairs


def _vit_hf_pairs(cfg) -> list:
    P, C, D = cfg.patch_size, cfg.channels, cfg.dim

    def conv(w):  # [P*P*C, D] (row, column, channel) -> the conv's [D, C, P, P]
        return w.reshape(P, P, C, D).permute(3, 2, 0, 1)

    pairs = [("embeddings.patch_embeddings.projection.weight", "patch.w", conv),
             ("embeddings.patch_embeddings.projection.bias", "patch.b", None),
             ("embeddings.cls_token", "cls_token", None),
             ("embeddings.position_embeddings", "pos_emb", None),
             ("layernorm.weight", "final_norm.scale", None),
             ("layernorm.bias", "final_norm.bias", None)]
    for i in range(cfg.num_layers):
        hf, p = f"encoder.layer.{i}.", f"encoder.{i}."
        for h, n in (("attention.attention.query", "attn.q"), ("attention.attention.key", "attn.k"),
                     ("attention.attention.value", "attn.v"), ("attention.output.dense", "attn.o"),
                     ("intermediate.dense", "mlp.up"), ("output.dense", "mlp.down")):
            pairs += [(hf + h + ".weight", p + n + ".w", _T), (hf + h + ".bias", p + n + ".b", None)]
        for h, n in (("layernorm_before", "norm1"), ("layernorm_after", "norm2")):
            pairs += [(hf + h + ".weight", p + n + ".scale", None),
                      (hf + h + ".bias", p + n + ".bias", None)]
    return pairs


def _hf_roundtrip(tag: str, src, pairs, to_params) -> tuple[dict, dict]:
    """``src``'s state in HF layout -> a .safetensors file -> the port's
    reader -> ``to_params`` (an ``*_params_from_hf``). Gates the result
    equal to ``src``'s own state (as f32), key for key. -> (params, file
    stats)."""
    state = src.state_dict()
    hf = _hf_layout(state, pairs)
    dtypes = sorted({ST_DTYPES[t.dtype] for t in hf.values()})
    with tempfile.TemporaryDirectory(prefix="hf-", dir=_build.BUILD_DIR) as d:
        path = os.path.join(d, "model.safetensors")
        t0 = time.perf_counter()
        nbytes = _write_safetensors(path, hf)
        t1 = time.perf_counter()
        del hf
        sd = load_safetensors(path)
        t2 = time.perf_counter()
        read_dtypes = sorted({ST_DTYPES[t.dtype] for t in sd.values()})
        params = to_params(sd)
        t3 = time.perf_counter()
        del sd
    check(read_dtypes == dtypes, f"{tag}: the reader changed dtypes {dtypes} -> {read_dtypes}")
    check(sorted(params) == sorted(state)
          and all(params[k].dtype == torch.float32
                  and torch.equal(params[k], state[k].detach().float().cpu())
                  for k in state),
          f"{tag}: the HF file does not map back to the model's own state")
    return params, {"file_bytes": nbytes, "file_dtypes": dtypes, "write_s": t1 - t0,
                    "read_s": t2 - t1, "map_s": t3 - t2,
                    "read_gb_per_s": nbytes / 1e9 / max(t2 - t1, 1e-9)}


def phase_hf_bert_f32(name_power: str) -> dict:
    """[hf bert f32]: BERT-base in f32 from an HF-layout f32 checkpoint (as
    HF ships bert-base) through ``load_safetensors`` and
    ``bert_params_from_hf``, trained 3 steps by ``Trainer(TrainConfig(
    dtype="float32"))`` at 8 x 512, where "auto" attention runs B1 and B2
    in their f32 forms. Gates: the file maps back to the model's state;
    step 1's loss within HF_LOSS_REL of the plain f32 attention's on the
    card (the same params and batch); B1 f32 and B2 f32 12 a step and no
    bf16 launch; the loss falls. Dropout is off, so three steps on one
    batch show the fall without dropout's noise."""
    cfg = dataclasses.replace(BertConfig.base(), dropout=0.0)
    B, T, L = 8, 512, cfg.num_layers
    src = Bert(cfg, device=DEV, seed=19)
    params, io = _hf_roundtrip("hf bert f32", src, _bert_hf_pairs(cfg),
                               lambda sd: bert_params_from_hf(sd, cfg))
    del src
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=0)
    model.bert.load_state_dict(params, strict=True)
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="sgd",
                       learning_rate=HF_BERT_LR, dtype="float32", grad_clip_norm=1.0)
    trainer = Trainer(model, _bert_loss, tcfg, device=DEV)
    state = trainer.init_state()
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    plain = Trainer(BertClassifier(dataclasses.replace(cfg, attn_impl="reference"),
                                   CLASSES, device=DEV, seed=None),
                    _bert_loss, tcfg, device=DEV)
    lp, gp = plain.loss_and_grads(state.params, batch)
    del plain
    lk, gk = trainer.loss_and_grads(state.params, batch)

    def cos(a, b):
        a, b = a.flatten().double(), b.flatten().double()
        return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))

    cosines = [cos(gk[n], gp[n]) for n in gp
               if float(gp[n].norm()) > 0 and not n.endswith("attn.k.b")]
    del gk, gp
    gen = torch.Generator(device=DEV).manual_seed(0)
    _zero_counts()
    state, losses, secs = _timed_steps(trainer, state, batch, gen, HF_BERT_STEPS, warm=1)
    c = _counts()
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    res = {"model": "BERT-base from an HF-layout f32 file", **io, "batch": B, "seq": T,
           "loss_step1_kernel": float(lk), "loss_step1_plain_f32": float(lp),
           "loss_rel_diff": rel, "grad_min_cosine_vs_plain": min(cosines),
           "losses": losses, "step_s_after_first": secs,
           "flash_fwd_by_variant": c["flash_fwd_by_variant"],
           "flash_bwd_by_variant": c["flash_bwd_by_variant"],
           "expected_f32_each": L * HF_BERT_STEPS, "card": name_power}
    say(f"[hf bert f32] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "hf bert f32: non-finite loss")
    check(rel <= HF_LOSS_REL, f"hf bert f32: step-1 loss {float(lk)} vs plain f32 "
          f"{float(lp)} (relative {rel} > {HF_LOSS_REL})")
    check(losses[-1] < losses[0], f"hf bert f32: the loss did not fall: {losses}")
    want = {"bf16": 0, "f32": L * HF_BERT_STEPS, "f16": 0}
    check(c["flash_fwd_by_variant"] == want and c["flash_bwd_by_variant"] == want,
          f"hf bert f32: B1/B2 launches by form {c['flash_fwd_by_variant']} / "
          f"{c['flash_bwd_by_variant']}, expected {want} each")
    del trainer, model, state
    _free_cuda()
    return {"f32_fwd": c["flash_fwd_by_variant"]["f32"],
            "f32_bwd": c["flash_bwd_by_variant"]["f32"]}


def phase_bert_f16(name_power: str) -> dict:
    """[bert f16]: BERT-base (random weights, dropout off) trained one step
    by ``Trainer(TrainConfig(dtype="float16"))`` at 8 x 512, where "auto"
    attention runs B1 and B2 in their f16 forms (fault C8: they had
    none). Gates: B1/B2 launches by form exactly 12 f16 each and nothing
    else; a finite loss within BERT_F16_LOSS_REL of the plain f16
    attention's loss on the same params and batch; each gradient leaf
    held to plain f16 attention's and the plain f32 gradient by
    BERT_F16_GRAD_COS' rule."""
    cfg = dataclasses.replace(BertConfig.base(), dropout=0.0)
    B, T, L = 8, 512, cfg.num_layers
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=20)
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="sgd",
                       learning_rate=HF_BERT_LR, dtype="float16", grad_clip_norm=1.0)
    trainer = Trainer(model, _bert_loss, tcfg, device=DEV)
    state = trainer.init_state()
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    grads = {"kernel": trainer.loss_and_grads(state.params, batch)}
    for tag, dtype in (("plain", "float16"), ("f32", "float32")):
        plain = Trainer(BertClassifier(dataclasses.replace(cfg, attn_impl="reference"),
                                       CLASSES, device=DEV, seed=None),
                        _bert_loss, dataclasses.replace(tcfg, dtype=dtype), device=DEV)
        grads[tag] = plain.loss_and_grads(state.params, batch)
        del plain
    lp = float(grads["plain"][0])
    gres = _grad_agreement(*(grads[t] for t in ("kernel", "plain", "f32")),
                           direct_min=BERT_F16_GRAD_COS)
    del grads
    gen = torch.Generator(device=DEV).manual_seed(0)
    _zero_counts()
    state, losses, secs = _timed_steps(trainer, state, batch, gen, 1, warm=0)
    c = _counts()
    rel = abs(losses[0] - lp) / abs(lp)
    res = {"model": "BERT-base, f16 compute", "batch": B, "seq": T,
           "loss_kernel": losses[0], "loss_plain_f16": lp, "loss_rel_diff": rel,
           "grads_vs_plain_f16_and_f32": gres, "step_s": secs,
           "flash_fwd_by_variant": c["flash_fwd_by_variant"],
           "flash_bwd_by_variant": c["flash_bwd_by_variant"], "card": name_power}
    say(f"[bert f16] {json.dumps(res)}")
    check(bool(np.isfinite(losses[0])), f"bert f16: non-finite loss {losses[0]}")
    check(rel <= BERT_F16_LOSS_REL, f"bert f16: loss {losses[0]} vs plain f16 {lp} "
          f"(relative {rel} > {BERT_F16_LOSS_REL})")
    check(not gres["failed"], f"bert f16: gradient disagreement: {gres['failed']}")
    want = {"bf16": 0, "f32": 0, "f16": L}
    check(c["flash_fwd_by_variant"] == want and c["flash_bwd_by_variant"] == want,
          f"bert f16: B1/B2 launches by form {c['flash_fwd_by_variant']} / "
          f"{c['flash_bwd_by_variant']}, expected {want} each")
    del trainer, model, state
    _free_cuda()
    return {"f16_fwd": c["flash_fwd_by_variant"]["f16"],
            "f16_bwd": c["flash_bwd_by_variant"]["f16"]}


def phase_hf_llama(name_power: str, prompts) -> dict:
    """[hf llama]: Llama-3-8B's full width at HF_LLAMA_LAYERS of its 32
    layers (random bf16 weights) written in HF layout as BF16, as Meta
    ships it, read by the port's reader (BF16 kept) and mapped to f32 by
    ``llama_params_from_hf``, as the reference does; served ([slice]'s
    first 4 prompts, 16 tokens, captured paged engine) beside an engine
    built from the same tensors with no file in between; then an f16
    sibling of the same params serves the first HF_LLAMA_F16_REQUESTS
    prompts. Gates: the file maps back to the model's state; equal
    tokens; B3 and B4 on the path; the f16 tokens within LOGIT_GAP_TOL of
    the f16 model's teacher-forced row max, every f16 paged read on B3's
    tensor-core variants (decode steps on "decode", prefill chunks on
    "prefill", none on "general")."""
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=HF_LLAMA_LAYERS)
    L = cfg.num_layers
    src = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=23)
    params, io = _hf_roundtrip("hf llama", src, _llama_hf_pairs(cfg),
                               lambda sd: llama_params_from_hf(sd, cfg))
    model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=None)
    model.load_state_dict(params, strict=True)
    del params
    prompts = prompts[:MESH_REQUESTS]
    outs = {}
    for tag, m in (("file", model), ("direct", src)):
        eng = InferenceEngine(m, max_len=2048, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV)
        sch, outs[tag], c, by_variant = _serve_short(f"hf llama {tag}", eng, prompts,
                                                     MESH_NEW, True)
        if tag == "file":
            st = sch.stats()
            _check_paged_launches("hf llama", st, c["paged_decode"], c["fused_norm"],
                                  by_variant, L)
            launches = {"paged": c["paged_decode"], "norm": c["fused_norm"]}
        del sch, eng
    equal = all(np.array_equal(a, b) for a, b in zip(outs["file"], outs["direct"]))
    res = {"model": f"Llama-3-8B width, {L} of 32 layers, BF16 HF file", **io,
           "requests": len(prompts), "tokens": sum(len(o) for o in outs["file"]),
           "tokens_equal_to_direct": equal, "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"], **launches, "card": name_power}
    say(f"[hf llama] {json.dumps(res)}")
    check(equal, "hf llama: tokens differ from the engine built without the file")
    del src
    # the f16 sibling (fault C9: B3 had no f16 form): the same params in
    # f16, the first HF_LLAMA_F16_REQUESTS prompts, every paged read on
    # B3's tensor-core variants: each layer's decode steps on "decode",
    # its prefill chunks on "prefill"
    m16 = Llama(cfg, device=DEV, dtype=torch.float16, seed=None)
    m16.load_state_dict(model.state_dict(), strict=True)
    del model
    eng16 = InferenceEngine(m16, max_len=2048, cache_dtype=torch.float16,
                            param_dtype=torch.float16, device=DEV)
    p16 = prompts[:HF_LLAMA_F16_REQUESTS]
    sch, outs16, c16, by16 = _serve_short("hf llama f16", eng16, p16, MESH_NEW, True)
    st16 = sch.stats()
    del sch, eng16
    want16 = {"general": 0, "decode": L * st16["decode_steps"],
              "prefill": L * st16["prefill_chunks"]}
    tf16 = _teacher_forced("hf llama f16", m16, p16, outs16)
    res16 = {"requests": len(p16), "tokens": tf16["tokens"],
             "worst_gap": tf16["worst_gap"], "decode_steps": st16["decode_steps"],
             "prefill_chunks": st16["prefill_chunks"], "paged_by_variant": by16,
             "expected": want16, "card": name_power}
    say(f"[hf llama f16] {json.dumps(res16)}")
    check(by16 == want16 and min(want16["decode"], want16["prefill"]) > 0,
          f"hf llama f16: B3 launches by variant {by16}, expected {want16}")
    del m16
    _free_cuda()
    launches["paged"] += c16["paged_decode"]
    launches["norm"] += c16["fused_norm"]
    launches["paged_f16"] = c16["paged_decode"]
    return launches


def _t5_loss(module, params, batch, rng):
    logits = functional_call(
        module, params, (batch["input_ids"], batch["decoder_input_ids"]),
        {"attention_mask": batch["attention_mask"], "rng": rng, "train": rng is not None},
    )
    return softmax_cross_entropy(logits, batch["labels"])


def phase_t5(name_power: str) -> dict:
    """[t5]: T5-small (``T5Config.small()``, its full size) from an
    HF-layout f32 file through ``t5_params_from_hf``; ``greedy_decode`` of
    8 right-padded sources of 64-512 tokens, T5_NEW tokens each; 3 Trainer
    steps (f32, SGD). Gates: the file maps back to the model's state;
    every token within LOGIT_GAP_TOL of its row max in a teacher-forced
    ``decode()`` of the emitted prefix; the loss falls; no kernel launch
    (T5's attention is the plain path with its bias, as in the
    reference)."""
    cfg = T5Config.small()
    src = T5(cfg, device=DEV, seed=29)
    params, io = _hf_roundtrip("t5", src, _t5_hf_pairs(cfg),
                               lambda sd: t5_params_from_hf(sd, cfg))
    del src
    model = T5(cfg, device=DEV, seed=None)
    model.load_state_dict(params, strict=True)
    del params
    r = np.random.default_rng(31)
    B, S = len(T5_LENS), max(T5_LENS)
    am = (np.arange(S)[None] < np.asarray(T5_LENS)[:, None]).astype(np.int64)
    ids = torch.from_numpy(r.integers(2, cfg.vocab_size, (B, S)) * am).to(DEV)
    am = torch.from_numpy(am).to(DEV)
    _zero_counts()
    t0 = time.perf_counter()
    toks = model.greedy_decode(ids, attention_mask=am, max_new_tokens=T5_NEW)
    decode_s = time.perf_counter() - t0
    c_dec = _counts()
    with torch.no_grad():
        memory = model.encode(ids, attention_mask=am)
        dec = torch.cat([torch.zeros((B, 1), dtype=torch.int64),
                         toks[:, :-1].long()], dim=1).to(DEV)
        logits = model.decode(dec, memory, memory_mask=am).float()
    tok = toks.long().to(DEV)
    gap = logits.max(dim=-1).values - logits.gather(-1, tok[..., None])[..., 0]
    worst = float(gap.max())
    # training: the sources, teacher-forced targets of 64 tokens
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="sgd",
                       learning_rate=ZOO_SGD_LR, dtype="float32", grad_clip_norm=1.0)
    trainer = Trainer(model, _t5_loss, tcfg, device=DEV)
    labels = torch.from_numpy(r.integers(2, cfg.vocab_size, (B, 64))).to(DEV)
    batch = {"input_ids": ids, "attention_mask": am, "labels": labels,
             "decoder_input_ids": torch.cat([torch.zeros_like(labels[:, :1]),
                                             labels[:, :-1]], dim=1)}
    _zero_counts()  # no generator: dropout off, so the fall is not its noise
    _, losses, secs = _timed_steps(trainer, trainer.init_state(), batch, None, T5_STEPS,
                                   warm=1)
    c_train = _counts()
    kernels = {k: v for k, v in {**c_dec, **c_train}.items()
               if k in ("paged_decode", "fused_norm", "flash_fwd", "flash_bwd")}
    res = {"model": "T5-small from an HF-layout f32 file", **io, "sources": list(T5_LENS),
           "new_tokens": T5_NEW, "greedy_decode_s": decode_s,
           "teacher_forced_worst_gap": worst,
           "exact_argmax": int((gap == 0).sum()), "tokens": int(gap.numel()),
           "losses": losses, "step_s_after_first": secs,
           "kernel_launches_decode": {k: c_dec[k] for k in kernels},
           "kernel_launches_train": {k: c_train[k] for k in kernels},
           "card": name_power}
    say(f"[t5] {json.dumps(res)}")
    check(tuple(toks.shape) == (B, T5_NEW), f"t5: tokens {tuple(toks.shape)}")
    check(worst <= LOGIT_GAP_TOL, f"t5: teacher-forced gap {worst} > {LOGIT_GAP_TOL}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"t5: the loss did not fall: {losses}")
    check(all(c_dec[k] == 0 == c_train[k] for k in kernels),
          f"t5: a kernel launched on T5's plain path: {kernels}")
    del trainer, model
    _free_cuda()
    return {}


def _vit_loss(module, params, batch, rng):
    logits = functional_call(module, params, (batch["images"],),
                             {"rng": rng, "train": rng is not None})
    return softmax_cross_entropy(logits, batch["labels"])


def phase_vit(name_power: str) -> dict:
    """[vit]: ViT-B/16 at 224 (``ViTConfig.base_16()``) as a
    ``ViTClassifier`` of VIT_CLASSES classes, its encoder from an
    HF-layout f32 file through ``vit_params_from_hf``; VIT_STEPS Trainer
    steps at batch 32 in bf16, then VIT_STEPS ``ShardedTrainer`` steps
    over ``vit_pipeline_parts`` on one NCCL rank from the same params.
    Gates: the file maps back; the loss falls in both; their first losses
    within VIT_LOSS_REL; B1 = B2 = 0 (197 tokens are off the kernel rule,
    as in the reference)."""
    cfg = ViTConfig.base_16()
    src = ViT(cfg, device=DEV, seed=37)
    params, io = _hf_roundtrip("vit", src, _vit_hf_pairs(cfg),
                               lambda sd: vit_params_from_hf(sd, cfg))
    del src
    clf = ViTClassifier(cfg, VIT_CLASSES, device=DEV, seed=0)
    clf.vit.load_state_dict(params, strict=True)
    del params
    init = {k: v.detach().clone() for k, v in clf.named_parameters()}
    g = torch.Generator(device=DEV).manual_seed(41)
    batch = {"images": torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size,
                                    cfg.channels), generator=g, device=DEV)
             .to(torch.bfloat16),
             "labels": torch.randint(0, VIT_CLASSES, (VIT_BATCH,), generator=g, device=DEV)}
    tcfg = TrainConfig(batch_size=VIT_BATCH, micro_batches=1, optimizer="sgd",
                       learning_rate=ZOO_SGD_LR, dtype="bfloat16", grad_clip_norm=1.0)
    trainer = Trainer(clf, _vit_loss, tcfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    _zero_counts()
    _, losses, secs = _timed_steps(trainer, trainer.init_state(), batch, gen, VIT_STEPS,
                                   warm=1)
    c = _counts()
    del trainer
    mesh = make_mesh(MeshConfig())
    try:
        parts = vit_pipeline_parts(clf.vit, init, num_classes_head=VIT_CLASSES)
        tr = ShardedTrainer(mesh, tcfg, parts,
                            lambda logits, b: softmax_cross_entropy(logits, b["labels"]))
        _, sh_losses, sh_secs, k_sh = _sharded_steps(tr, tr.init_state(), batch,
                                                     VIT_STEPS, warm=1)
        del tr, parts
    finally:
        shutdown_distributed()
    rel = abs(sh_losses[0] - losses[0]) / abs(losses[0])
    res = {"model": "ViT-B/16 classifier, encoder from an HF-layout f32 file", **io,
           "batch": VIT_BATCH, "tokens": cfg.num_patches + 1,
           "trainer_losses": losses, "trainer_step_s_after_first": secs,
           "sharded_losses": sh_losses, "sharded_step_s_after_first": sh_secs,
           "first_loss_rel_diff": rel,
           "flash_launches_trainer": [c["flash_fwd"], c["flash_bwd"]],
           "flash_launches_sharded": list(k_sh), "card": name_power}
    say(f"[vit] {json.dumps(res)}")
    check(all(np.isfinite(losses + sh_losses)), "vit: non-finite loss")
    check(losses[-1] < losses[0] and sh_losses[-1] < sh_losses[0],
          f"vit: the loss did not fall: {losses} / {sh_losses}")
    check(rel <= VIT_LOSS_REL, f"vit: first losses {losses[0]} / {sh_losses[0]} "
          f"(relative {rel} > {VIT_LOSS_REL})")
    check(c["flash_fwd"] == c["flash_bwd"] == 0 and k_sh == (0, 0),
          "vit: B1/B2 launched at 197 tokens")
    del clf, init, batch
    _free_cuda()
    return {}


def phase_ingest(name_power: str) -> dict:
    """[ingest]: an ``nn.TransformerEncoder`` at BERT-base's widths (768,
    12 heads, 3072, ``batch_first``, 2 layers, a final LayerNorm) with a
    ``Linear`` head, in f32, through ``from_torch`` onto the card. Gate:
    the native forward at 8 x 512 within INGEST_TOL of the torch module's
    own forward, with no kernel launched (the reference's ingested
    attention is the plain path)."""
    import torch.nn as tn

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(43)
        layer = tn.TransformerEncoderLayer(768, 12, 3072, dropout=0.1, batch_first=True)
        tm = tn.Sequential(tn.TransformerEncoder(layer, 2, norm=tn.LayerNorm(768),
                                                 enable_nested_tensor=False),
                           tn.Linear(768, 10))
    tm = tm.to(DEV).eval()
    native_model, params = from_torch(tm, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(47)
    x = torch.randn((8, 512, 768), generator=g, device=DEV)
    _zero_counts()
    with torch.no_grad():
        out = native_model(x)
        ref = tm(x)
    torch.cuda.synchronize()
    c = _counts()
    err = float((out - ref).abs().max())
    res = {"layers": len(native_model), "params": sum(p.numel() for p in params.values()),
           "shape": [8, 512, 768], "max_abs_err": err, "ref_max_abs": float(ref.abs().max()),
           "flash_fwd": c["flash_fwd"], "card": name_power}
    say(f"[ingest] {json.dumps(res)}")
    check(bool(torch.isfinite(out).all()) and err <= INGEST_TOL,
          f"ingest: native forward {err} from the torch module's (> {INGEST_TOL})")
    check(c["flash_fwd"] == 0, "ingest: a kernel ran on the ingested plain path")
    del tm, native_model, params, x, out, ref
    _free_cuda()
    return {}


def _diag_check(loop: "_NodeLoop", node: Node, sch, name_power: str) -> None:
    """[diag]: ``diag.scrape_cluster`` against the [node slice] node's
    status port (the tldiag path an operator runs): its cluster-table row
    healthy and showing its KV pool, the scraped /kv the engine's
    ``kv_stats``."""
    target = f"127.0.0.1:{node._http.bound_port}"
    bundle = loop.run(tldiag.scrape_cluster([target], timeout=30.0))
    rows = tldiag.cluster_table(bundle)
    kv = bundle["nodes"][0]["routes"]["/kv"]
    row = rows[0]
    res = {"target": target, "healthy": row["healthy"], "flags": row["flags"],
           "kv_pool_pct": row["kv_pool_pct"], "kv_status": kv.get("status"),
           "kv_total_chains": (kv.get("body") or {}).get("total_chains"),
           "card": name_power}
    say(f"[diag] {json.dumps(res)}")
    for ln in tldiag.render_table(rows).splitlines():
        say(f"[diag]   {ln}")
    check(row["healthy"] is True
          and not {"DEAD", "UNHEALTHY"} & set(row["flags"]), f"diag: the node's row {row}")
    check(row["kv_pool_pct"] is not None, "diag: the row shows no KV pool")
    check(kv.get("status") == 200 and kv["body"]["pool"] == sch.kv_stats()["pool"],
          "diag: the scraped /kv is not the engine's kv_stats")


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)


def _phase_line() -> None:
    say(f"[phase seconds] {json.dumps(PHASE_S)}")


def main() -> int:
    try:
        return _main()
    except BaseException:
        _phase_line()  # where the time went up to the failure
        raise


def _main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, name_power = timed("device", phase_device)
    # the kernel-build cache: a fresh directory every run, so the builds
    # below are cold and [compile cache] reads a warm load beside them
    build_root = os.path.join(_build.PKG_DIR, "_build")
    os.makedirs(build_root, exist_ok=True)
    os.environ[compile_cache.ENV_VAR] = tempfile.mkdtemp(prefix="compile-cache-",
                                                         dir=build_root)
    compile_cache.enable_compile_cache()
    build = timed("build", phase_build)
    timed("compile cache", phase_compile_cache, name_power, build)
    timed("sampler", phase_sampler)
    flush = L2Flush()
    floor_ms = timed("floor", phase_floor, flush)
    paged = timed("paged", phase_paged, flush)
    norm = timed("norm", phase_norm, flush, floor_ms)
    flash = timed("flash", phase_flash, flush)
    sp_kernel = timed("sp kernel", phase_sp_kernel, flush)
    cap = timed("capability", phase_capability, name_power)
    model = Llama(LlamaConfig.llama3_8b(), device=DEV, dtype=torch.bfloat16,
                  seed=0)
    launches = timed("slice", phase_slice, name_power, model, cap)
    prompts, slice_outs = launches["prompts"], launches["outs"]
    pipe = timed("pipeserve", phase_pipeserve, name_power, model, prompts, slice_outs)
    roles = timed("roles train", phase_roles_train, name_power)
    mesh = timed("mesh paged", phase_mesh_paged, name_power, model, prompts)
    disagg = timed("disagg", phase_disagg, name_power, model, prompts, slice_outs, cap)
    disagg8 = timed("disagg int8", phase_disagg_int8, name_power, model, prompts,
                    slice_outs, disagg["float_blob_bytes"])
    static = timed("static", phase_static, name_power, model)
    spec = timed("spec paged", phase_spec_paged, name_power, model)
    over = timed("overload", phase_overload, name_power, model)
    int8 = timed("int8", phase_int8, name_power, model, prompts, slice_outs,
                 launches["prof"], cap)
    fused = timed("fused qkv", phase_fused, name_power, model, prompts, slice_outs, cap)
    pair = timed("autopair", phase_autopair, name_power, model, int8["int8_dense_bytes"])
    timed("autotune", phase_autotune, name_power, model, pair["persistable"])
    chaos_k = timed("chaos", phase_chaos, name_power, model, over)
    heal = timed("self-heal", phase_self_heal, name_power, model, prompts, slice_outs)
    asyn = timed("async", phase_async, name_power, model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    hf_llama = timed("hf llama", phase_hf_llama, name_power, prompts)
    tp2 = timed("tp2", phase_tp2, name_power, prompts)
    mixtral = timed("mixtral", phase_mixtral, name_power, cap, tp2["ep2_paged"])
    contiguous = timed("contiguous", phase_contiguous, name_power)
    gc.collect()
    torch.cuda.empty_cache()
    timed("spec contiguous", phase_spec_contiguous, name_power)
    gc.collect()
    torch.cuda.empty_cache()
    rolling = timed("rolling", phase_rolling, name_power)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = timed("train", phase_train, name_power)
    gc.collect()
    torch.cuda.empty_cache()
    lora = timed("lora", phase_lora, name_power)
    ckpt = timed("checkpoint", phase_checkpoint, name_power)
    sh_bert, sh_gpt2 = timed("sharded", phase_sharded, name_power, train)
    gc.collect()
    torch.cuda.empty_cache()
    sp_job = timed("sp", phase_sp, name_power, sh_gpt2.pop("seq1"))
    hf_bert = timed("hf bert f32", phase_hf_bert_f32, name_power)
    bert16 = timed("bert f16", phase_bert_f16, name_power)
    timed("vit", phase_vit, name_power)
    timed("t5", phase_t5, name_power)
    timed("ingest", phase_ingest, name_power)
    norm_paths = {"paged serving": launches["launches_norm"],
                  "mesh paged": mesh["norm"], "tp2 (both ranks, 5 legs)": tp2["norm"],
                  "static": static["launches_norm"],
                  "contiguous": contiguous["launches_norm"],
                  "rolling": rolling["launches_norm"],
                  "spec paged (draft steps)": spec["norm"],
                  "disagg decode leg": disagg["norm"],
                  "disagg int8 decode leg": disagg8["norm"],
                  "int8 weights": int8["norm"], "fused qkv": fused["norm"],
                  "autopair bursts": pair["norm"], "chaos (2 overload runs)": chaos_k["norm"],
                  "self-heal": heal["norm"], "async": asyn["norm"],
                  "mixtral paged": mixtral["norm"], "mixtral static": mixtral["static_norm"],
                  "ep2 mixtral paged (both ranks)": tp2["ep2_launches"]["norm"],
                  "pipeserve (both stages)": pipe["norm"], "hf llama": hf_llama["norm"]}
    paged_paths = {"paged serving": launches["launches_paged"],
                   "mesh paged": mesh["paged"], "tp2 paged and disagg (both ranks)": tp2["paged"],
                   "spec paged (verify passes, prefill chunks)": spec["paged"],
                   "disagg (both legs)": disagg["paged"],
                   "disagg int8 (both legs)": disagg8["paged"],
                   "int8 weights": int8["paged"], "fused qkv": fused["paged"],
                   "chaos (2 overload runs)": chaos_k["paged"],
                   "self-heal": heal["paged"], "async": asyn["paged"],
                   "mixtral paged": mixtral["paged"],
                   "ep2 mixtral paged (both ranks)": tp2["ep2_launches"]["paged"],
                   "pipeserve (both stages)": pipe["paged"], "hf llama": hf_llama["paged"]}
    say(f"[launches] fused_residual_norm by path: {json.dumps(norm_paths)}")
    say(f"[launches] paged_decode_attention by path: {json.dumps(paged_paths)}")
    flash_paths = {"train": (train["launches_fwd"], train["launches_bwd"]),
                   "lora": (lora["launches_fwd"], lora["launches_bwd"]),
                   "checkpoint": (ckpt["launches_fwd"], ckpt["launches_bwd"]),
                   "sharded bert": (sh_bert["launches_fwd"], sh_bert["launches_bwd"]),
                   "sharded gpt2": (sh_gpt2["launches_fwd"], sh_gpt2["launches_bwd"]),
                   "sp attention + sp2 gpt2 (both ranks)": (sp_job["launches_fwd"],
                                                            sp_job["launches_bwd"]),
                   "ep2 mixtral train (both ranks)": tp2["ep2_launches"]["flash"],
                   "roles train (steps and audits)": (roles["launches_fwd"],
                                                      roles["launches_bwd"])}
    say(f"[launches] flash_attention fwd, bwd by path: {json.dumps(flash_paths)}")
    say(f"[launches] flash_attention f32 form fwd, bwd: "
        f"{json.dumps({'hf bert f32': (hf_bert['f32_fwd'], hf_bert['f32_bwd'])})}")
    say(f"[launches] flash_attention f16 form fwd, bwd: "
        f"{json.dumps({'bert f16': (bert16['f16_fwd'], bert16['f16_bwd'])})}")
    kernels = [
        {
            "name": "paged_decode_attention", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/paged_decode.cu",
            "replaces": "tensorlink_tpu/ops/pallas/paged_decode.py:285",
            "launches": sum(paged_paths.values()),
            **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        },
        {
            # B3's f16 form (f16 q over f16 pools on the tensor-core
            # variants): the decode steps' form; launches: [hf llama f16]
            "name": "paged_decode_attention (f16 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/paged_decode.cu",
            "replaces": "tensorlink_tpu/ops/pallas/paged_decode.py:285",
            "launches": hf_llama["paged_f16"],
            **{k: paged["f16"]["f16_mask"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "fused_residual_norm", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/decode_glue.cu",
            "replaces": "tensorlink_tpu/ops/pallas/decode_glue.py:90",
            "launches": sum(norm_paths.values()),
            **{k: norm[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_fwd_lse (bf16 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:247",
            "launches": sum(f for f, _ in flash_paths.values()),
            **{k: flash["fwd"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_bwd (bf16 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:470",
            "launches": sum(b for _, b in flash_paths.values()),
            **{k: flash["bwd"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_fwd_lse (f32 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention_f32.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:247",
            "launches": hf_bert["f32_fwd"],
            **{k: flash["fwd_f32"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_bwd (f32 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention_f32.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:470",
            "launches": hf_bert["f32_bwd"],
            **{k: flash["bwd_f32"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_fwd_lse (f16 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:247",
            "launches": bert16["f16_fwd"],
            **{k: flash["fwd_f16"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_bwd (f16 form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:470",
            "launches": bert16["f16_bwd"],
            **{k: flash["bwd_f16"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                "bound_ms", "bound_by", "library_ms")},
        },
        {
            # the ring's backward: B2 given the whole row's delta, at one
            # rank's block of Llama-3-8B's attention; library: flash SDPA's
            # forward and backward at the whole sequence
            "name": "flash_attention_bwd (delta form)", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:470",
            "launches": sp_job["launches_delta"],
            **{k: sp_kernel[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")},
        },
    ]
    _phase_line()
    say(smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
