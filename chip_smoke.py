#!/usr/bin/env python3
"""Drive llamafile_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

1. Set-up: the card's name and power limit, torch/CUDA/nvcc versions, and a
   parallel build of every CUDA kernel from llamafile_tpu_torch/csrc/.
2. Each kernel at the shapes of the llama3-8b main paths (Q4_K decode and
   prefill, Q8_0 and Q6_K decode, long-prompt prefill, the serving step at
   8 rows: qmm_txn at M = 8 and paged_attention over bf16 and int8 pages;
   qmm_txn_m1 at the decode step's qkv, o, down (K = 14336) and lm head;
   qmm_txn at its 11 shapes and qmm_txn_g at its four; these, the fused
   FFN, the routed q4b GEMVs and qmm_int8 each with a second launch on the
   same inputs held bit for bit, qmm_txn also with a control whose lo and
   hi scale rows are swapped;
   flash_decode_write at pos 700 / s_eff 1024, pos 1900 / s_eff 2048 and
   phase 4's pos 64 / s_eff 256, two launches on the same inputs bitwise
   equal; the three decode kernels also at head groups of 3 and 16 (24 and
   128 query heads over 8 KV heads), bf16 and int8, and at head_dim 256:
   Gemma-2-9B's 16 query heads over 8 KV heads and Gemma-2B's 8 over 1;
   flash_decode_write and flash_decode (bf16 and int8) at B = 8, the dense
   row mode's step (DENSE_POS: a position a row over a 2048-position
   cache streamed to s_limit 1024, one row parked at the trash slot 2047),
   each against its plain version with the written rows equal (each row's
   pos alone written); the three decode kernels over f16 and f32 caches
   and pages (flash_decode_write at pos 700 and 1900, at B = 8 and at D =
   256; flash_decode at s_eff 2048 and 1024 and at D = 256;
   paged_attention at 8 rows of 1024 and at D = 256), each timed beside
   sdpa on the same dtype;
   gemma2's options at Gemma-2-9B's decode shapes over a cache of 8192
   positions, at pos 700 and 6000: flash_decode_write with the window of
   4096 and the softcap of 50, flash_decode (bf16 and int8) with the
   softcap and with the softcap and the window, each against its plain
   version, two launches bitwise equal, timed beside the same call without
   the options and beside the bytes of the rows visible; gemma3's window
   of 1024 on flash_decode_write at Gemma-3-27B's 32 query heads over 16
   KV heads (D = 128) over a cache of 4096, at pos 700 and 3000; the
   products of Gemma-3-27B (K = 5376 and 21504, an odd count of 256-blocks)
   and Gemma-7B: qmm_txn_m1 at qkv, o, gate|up and down, qmm_txn at the
   24-token prefill's M = 32 (and Gemma-7B's at the 4-slot server's M =
   4), qmm_dequant at their prefill buckets (1024 and 512) and at
   Gemma-7B's Q6_K head for 4 rows, qmm_q8_m1 at their Q6_K heads;
   flash_prefill at T = 1024 also at 32 over 16 heads (D 128) and 16 over
   16 (D 256), paged_attention also at 16 over 16 (D 256); the products
   of Qwen3-32B (qkv N 10240, o K 8192, gate|up N 51200, down K 25600) and
   Qwen2.5-7B (qkv N 4608, o, the concatenated gate|up N 37888, down K
   18944) on qmm_txn_m1 and on qmm_txn at M = 32 and 4, Qwen3-32B's at M =
   1024 on qmm_dequant and its fused FFN (d_ff 25600) on qmm_moe_m1, the
   Q6_K heads of vocab 151936 and 152064 on qmm_q8_m1 and Qwen3-32B's at M
   = 4 on qmm_dequant, with the vocab's last column tile held through
   qmatmul (vocab_tail_check), llama3-8b's four products at M = 4096 (64
   embedding texts of bucket 64) on qmm_dequant, flash_prefill at 64 over
   8 and 28 over 4 heads (T = 1024) and at B = 8 (T = 512) and 64 (T =
   128), and the decode kernels at G = 8 (64 over 8) and 7 (28 over 4);
   the window-only option cases beside sdpa with a boolean window mask;
   the unrolled prefill's qmm_planes; flash_decode and paged_attention
   over bf16 and int8 (one launch of thread-block clusters, a group of up
   to 16 heads from one K/V read; a larger group's label gives the
   wrapper's chunk count); flash_prefill (wgmma) at T = 512, 1024, 2048; the
   MoE kernels at Mixtral-8x7B width: the routed fused FFN and the routed
   q4b and q8b GEMVs at a decode step's 2 slots, qmm_txn_g at 16 and 512
   slots, qmm_planes_g at 2048, each with a control whose expert ids are
   swapped; the int8 prefill GEMM qmm_i8p at the four products at M =
   1024, 512 and 128 and gate|up at M = 300, on layer 1 of a stack (and at
   gate|up M = 1024 on unrolled layers), bitwise equal to its plain version,
   with a control whose block scales are swapped, beside qmm_dequant at the
   same shape; the q4b
   flavours' kernels: qmm_int8 at M = 8 on qkv, o, gate|up, down (layers
   i > 0 of a stack) and the unstacked lm head, and gate|up and down at
   M = 32, with a control whose lo and hi scale rows are swapped, beside
   qmm_txn at the same shape; qmm_planes on layer 1 of a stack, gate|up at
   M = 1024 and 8; qmm_dequant at q8b g 8 (IQ1_M layers) at llama3-8b's
   four products at M = 32 and 1024; qmm_dequant on one-hot rows, x = I at
   K = 1024, whose outputs must equal dequant_bf16 exactly for q4b, q8b
   g32, g16 and g8),
   held against its plain PyTorch version on the same inputs (the
   tolerances of the CPU and card tests) and timed on the device: a run of launches cycling over
   enough layers of weights to spill the 50 MB L2 (as decode does) is
   captured in a CUDA graph and replayed between CUDA events, median of 25
   replays (5 for a plain version), so the host's dispatch cost is left
   out. Timed: the kernel, its
   plain version, one PyTorch library call computing the same function where
   there is one (for qmm_i8p, torch._int_mm on the same codes without the
   per-block scales), and the bound (bytes over the card's memory rate, or
   operations over its peak rate, whichever is larger).
3. At two layers of llama3-8b width, first the sampling state and the
   grammar path (stateful_sampling_check, grammar_path_check):
   Engine.generate with penalties, with mirostat v2 over penalties and
   with mirostat v1, each draw's Gumbel noise from one CPU generator, and
   the CPU's plain chain rerun on the card's logits, carrying its own
   penalty window and mu: the same token at every step, mu within 1e-5;
   the server's grammar path over a 128256-piece tokenizer, 12 greedy
   tokens, the host masks and the device mask equal to the CPU's, and the
   plain model on the CPU over the same tokens: logits within 2e-2, the
   same greedy choice under the mask. Then whole paths, card (kernels) against the
   same model on the CPU (plain versions): Q4_K with a 32-token prompt and a
   decode step, Q4_K with a 300-token prompt (bucket 512) and a decode
   step, Q8_0 with a 24-token prompt (bucket 32) and a decode step, and
   the paged decode (forward_paged_decode) of 4 rows admitted at prompts of
   24, 64, 200 and 300 tokens, 1 step; the Q4_K_M recipe at two layers
   (layer 1 Q6_K V and down, unrolled) with a 300-token prompt and a decode
   step; Q4_K with a dense int8 KV cache, 32-token prompt, 1 step; Q4_K
   with the int8 prefill companions (int8_prefill_params), 300-token prompt
   and a step, each qmm_i8p call rerun on its own int8 codes and scales;
   Q4_K over an f16 and an f32 KV cache (--kv-dtype), 32-token prompt, a
   step (flash_decode_write's f16 and f32 instances);
   TinyLlama's widths at two layers (head_dim 64) with a max_seq_len of
   1000: the Engine's prefill and 2 decode steps on a bf16 cache, then on the
   card Engine.generate and 3 requests through the batcher, every decode
   attention on the einsum or gather route with no decode kernel launch,
   and the 3-row paged decode card against CPU; Llama-3.2-3B's widths at
   two layers (a head group of 3): the Engine's prefill and a decode step
   over its bf16 cache (300-token prompt) and its int8 cache (40 tokens),
   then on the card Engine.generate and 4 requests through the batcher,
   every decode attention a kernel launch, and the 4-row paged decode card
   against CPU; the same checks at head_dim 256 (gemma-2b-widths-2l:
   Gemma-2B's widths in the llama layout, 8 query heads over 1 KV head, two
   layers; 1 decode step, the paged decode of 2 rows), where
   flash_decode_write, flash_decode and paged_attention run at D = 256;
   gemma2 at Gemma-2-9B's widths (gemma-2-9b-2l), Q4_K stacked over a bf16
   cache and by the Q4_K_M recipe unrolled over an int8 cache, 24- and
   4200-token prompts and 4 decode steps each (the window biting at the
   second), the kernels against the plain versions on the card
   (plain_kernels), where flash_decode_write and flash_decode run with the
   window and softcap on a model's path; gemma at Gemma-7B's widths
   (gemma-7b-2l: 16 over 16 heads at D = 256), Q4_K stacked over a bf16
   cache, 24- and 300-token prompts (flash_prefill on both layers at the
   second), then the HTTP server at 4 slots with launches exact and the
   shortest and longest prompts' requests against themselves served alone;
   gemma3 at Gemma-3-27B's widths (gemma-3-27b-6l: layer 5 global), Q4_K
   stacked over a bf16 cache and by the Q4_K_M recipe unrolled over an int8
   cache, 24-, 600- and 1100-token prompts (bucket 1024: every layer's
   prefill on flash_prefill, the windowed ones on the second rope table;
   bucket 2048: the windowed layers' prefill on the einsum, layer 5's on
   flash_prefill) and 2 decode steps each, past the window of 1024 at
   1100; qwen2 at Qwen2.5-7B's widths (qwen2.5-7b-2l: q/k/v biases, 28
   over 4 heads) and qwen3 at Qwen3-32B's (qwen3-32b-2l: q/k norms, 64 over
   8 heads, the fused FFN), Q4_K stacked over a bf16 cache and Q4_K_M
   unrolled over an int8 cache, 24- and 300-token prompts and 2 decode
   steps each against the plain versions on the card, then the HTTP server
   at 4 slots over the stacked engine (the paged decode with the biases
   and with the q/k norms), launches exact, the shortest and longest
   prompts' requests against themselves served alone; the LayerNorm
   families at two layers, unrolled (their layers never stack), a bf16
   cache, 2 decode steps a prompt, against the plain versions on the card:
   Pythia-6.9B's widths (pythia-6.9b-2l: a fused qkv with its bias, rope on
   32 of 128 dims, the parallel residual with an FFN norm) and Phi-2's
   (phi-2-2l: head_dim 80, every attention on the einsum route, counted; a
   shared norm, the head's bias) in Q4_K at 24- and 300-token prompts
   (bucket 512: qmm_planes, the bias term added in f32 before one rounding
   to bf16; flash_prefill at D = 128), Falcon-7B's (falcon-7b-2l: 71 query
   heads over 1 KV head of 64; K = 4544: every product on the dequant
   GEMM) in Q8_0 at 24 and 300 (flash_prefill at G = 71 and D = 64, decode
   on the einsum); then Pythia-6.9B's 300-token prefill, each q4b
   product's kernel and plain version within 1e-2 of the exact product,
   where the reference's order of roundings parts by more
   (planes_exact_check, ROADMAP C.11); two
   layers at Mixtral-8x7B width (mixtral-8x7b-2l): Q4_K stacked (24-token
   prompt: qmm_txn_g; a decode step on the routed fused FFN), the Q4_K_M
   recipe unrolled (300-token prompt: layer 0's qmm_planes_g, layer 1's
   dense expert loop (Q6_K down); a decode step: the routed GEMVs), and
   the paged decode at 4 rows (the fused FFN) and 8 rows (qmm_txn_g), one
   step each (the stacked and unrolled ones against the plain versions on
   the card, plain_kernels; the paged ones against the CPU); the
   routers held on the card's own inputs and their choices compared row by
   row (a row routed otherwise on the two sides is reported, its logits not
   held), and one decode step's MoE FFN calls run under
   torch.cuda.set_sync_debug_mode("error"); then under the q4b flavours
   (LLAMAFILE_TPU_Q4B, qmatmul.Q4B_KERNEL set for both sides): Q4_K with
   the 32-token prompt and a decode step under int8 and under planes, and
   the 300-token prompt and a step under int8 (qmm_int8, and the stacked
   planes kernel at bucket 512, as under planes), Q8_0 under int8 (24-token
   prompt, 1 step, decode on the dequant GEMM), the 4-row paged decode
   under int8 (1 step), and Mixtral Q4_K stacked under int8 (24-token
   prompt, 1 step on _routed_fallback, its calls counted). Each
   is traced op by op: for each step, the first product, quantization or
   attention call where card and CPU part, and the largest parting; every
   product is rerun through its plain version on the card's own inputs and
   must agree within its phase-2 limit, and so must every int8-cache
   decode attention. Those reruns run on the card (plain_rerun), on the
   card's own inputs and weights.
4. The main paths at full width through Engine.generate, each with every
   launch count set to 0 just before it and read just after, and checked
   exactly:
   4. make_synthetic_llama("llama3-8b", Q4_K, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate, time to
      first token and the weight-read bound;
   4b. the same engine, a 1000-token prompt (bucket 1024): time to first
      token through the dequant GEMM and the flash prefill;
   4d. phase 4's weights with a dense int8 KV cache: 64 tokens, decode
      attention on flash_decode (32 launches a step);
   4f. phase 4's engine under LLAMAFILE_TPU_Q4B=int8, then =planes: 32
      tokens (cut from 64 for phase 15) from the 24-token prompt (129
      qmm_int8 or qmm_planes launches a step: 4 a layer and the head; no
      fused FFN), the 1000-token prompt's TTFT (the stacked planes kernel,
      128 launches); under int8 also the
      HTTP server at 4 slots, 4 greedy requests of SERVE_NEW tokens,
      those of the shortest and longest prompt against themselves served
      alone (ALONE_LENGTHS; a 4-row step padded to 8 on qmm_int8);
   4e. phase 4's model built under LLAMAFILE_TPU_I8P=1 (phase 4's engine
      dropped first): 64 tokens from the 24-token prompt (no companion
      read), then the 1000-token prompt's TTFT with 128 qmm_i8p launches
      (4 fused products x 32 layers); the companions' bytes, peak memory;
   4c. make_synthetic_llama("llama3-8b", Q8_0, fused, 32 layers): greedy
      generate of 64 tokens from a 24-token prompt; decode rate against its
      weight-read bound, and time to first token.
5. Serving at full width: the port's HTTP Server (8 slots, paged bf16 KV)
   over phase 4's Q4_K engine, in process on 127.0.0.1; 8 client threads
   send 16 requests (prompts of 24, 128, 500 and 1000 tokens, 64 new
   tokens, 12 greedy and 4 sampled, half streamed, 2 through the chat
   endpoint). Wall time, output tok/s, TTFT by prompt length, the fused
   decode step at 8 rows against its bound, peak memory; exact launches
   from the batcher's own tallies; three requests served again one at a
   time by a fresh batcher (greedy at the shortest and longest prompt, one
   sampled) must give the same token ids. Then, over the same server, the
   embeddings (embedding_phase): 128 /v1/embeddings requests of 50 tokens
   from 16 client threads, then 8 of 500 tokens (bucket 512, flash_prefill
   at B > 1), each window counted alone with launches exact (the
   EmbedBatcher's thread and the batcher's share the launch counters);
   req/s, p50 latency, the batches formed; vectors within 1e-3 of the same
   ids embedded alone and of the plain versions on the card. Then the web
   UI's routes on the same server, started with --db: a chat made, a
   message added and read back through /db/*, and / serving the port's
   copy of the web UI (db_webui_check).
6. llama3-8b by llama.cpp's Q4_K_M recipe (testing.make_q4_k_m_llama) at
   PHASE6_LAYERS = 4 of its 32 layers (2 of them with Q6_K V and down,
   Q6_K head), unrolled, through
   Engine.generate (64 tokens from a 24-token prompt, then the 1000-token
   prompt's TTFT on qmm_planes) and the HTTP server at 4 slots (4 greedy
   requests of SERVE_NEW tokens, those of the shortest and longest
   prompt against themselves served alone), launches exact.
7. mixtral-8x7b-8l (Mixtral-8x7B's widths, top-2 of 8 experts, 8 layers):
   7a Q4_K stacked through Engine.generate (64 tokens from a 24-token
   prompt; the 1000-token prompt's TTFT), 7b the same by the Q4_K_M recipe
   (unrolled), 7c the HTTP server at 8 slots over 7a's engine, 8 greedy
   requests (prompts of 24, 128, 500 and 1000 tokens, two each, SERVE_NEW
   new tokens), the four of the shortest and longest prompt against
   themselves served alone;
   launches exact, the decode rate against the
   routed weight-read bound (models.synthetic.decode_read_bytes).
8. llama3.2-3b (Llama-3.2-3B's widths, PHASE8_LAYERS = 4 of its 28 layers,
   a head group of 3), Q4_K
   stacked: Engine.generate of 32 tokens from the 24-token prompt, launches
   exact, the decode rate against its weight-read bound; the HTTP server at
   4 slots, 4 greedy requests of SERVE_NEW tokens, those of the
   shortest and longest prompt against themselves served alone; no decode
   attention call on the einsum
   or gather route.
9. gemma-2-9b (Gemma-2-9B's widths, PHASE9_LAYERS = 6 of its 42 layers,
   the gemma2 branches), Q4_K
   stacked with a Q6_K head: Engine.generate of 64 tokens from the
   24-token prompt, launches exact (no fused FFN; flash_decode_write with
   the window on the even layers and the softcap on all), the decode rate
   against its weight-read bound; the 1000-token prompt's TTFT, median of
   3.
10. gemma-3-27b (Gemma-3-27B's widths, PHASE10_LAYERS = 8 of its 62
   layers, the gemma3 branches),
   Q4_K stacked with a Q6_K head: as phase 9, the 1000-token prompt's
   prefill launching flash_prefill on every layer (bucket 1024, the
   window's width).
11. qwen3-32b (Qwen3-32B's widths, PHASE11_LAYERS = 4 of its 64 layers,
   q/k norms, the fused FFN),
   Q4_K stacked with a Q6_K head (vocab 151936): Engine.generate of 64
   tokens from the 24-token prompt, launches exact, the decode rate
   against its weight-read bound, the 1000-token prompt's TTFT (median of
   3); the HTTP server at 4 slots, 4 greedy requests of SERVE_NEW
   tokens, launches exact (the
   requests alone are held by phase 3's qwen3-32b-2l check).
12. qwen2.5-7b (Qwen2.5-7B's widths, PHASE12_LAYERS = 4 of its 28 layers,
   q/k/v biases, G = 7, the
   FFN unfused): decode rate and TTFT as phase 11.
13. Phase 4's engine with a tokenizer of 128256 pieces (256 single-byte
   ones, "<t>" for the others, one EOG piece) under an HTTP server with 8
   slots and --state-dir: a GBNF request (eight items) and a json_schema
   request, each alone with launches exact and the mask's ms a token, then
   together beside 4 plain greedy requests, each text its own alone; a
   300-token request's row saved (np.savez against np.savez_compressed
   timed on 4 of its layers), erased and restored, the prompt again
   reusing 299 tokens or more with the tokens of the reuse without the
   restore; two more fresh 300-token prompts and two more restores (the
   rows holding the prompt erased first), each reusing as the first: the
   median TTFT after a restore below the median fresh one; Engine.generate of 64
   tokens with mirostat v2 and penalties, launches as phase 4's; a
   300-token prompt_cache twice, the second feeding one token as a decode
   step.
14. Phase 4's engine under the batcher's dense row mode
   (Batcher(paged=False), 8 rows of a bf16 row-batched cache): phase 5's
   16 prompts with DENSE_NEW = 24 new tokens each, submitted at once,
   output tok/s, launches exact
   (flash_decode_write once a layer a fused step), the same three
   requests as phase 5 served again alone on a fresh dense batcher with
   the same ids, the dense fused 8-row step (Engine.fused_decode) against
   (weights + 8 x attn_len x KV_BYTES_PER_TOKEN) / HBM; then a two-turn
   REPL session in process (cli.chat_loop over a ChatSession): each
   turn's TTFT and reused tokens, turn 2's first-token logits within 2e-2
   of a fresh prefill of its whole prompt with the same top-1.
15. The KV dtypes, the route knobs, the other formats and the load:
   15a phase 4's weights (not reloaded) under Engine.generate of KV_NEW
   tokens on an f16 and on an f32 dense cache, launches exact, every
   decode step again from the same cache against the plain decode
   attention on the card (kv_plain_check: within 2e-2 of the largest
   logit, the same top-1; the first step also against the plain versions
   of every kernel, the products too; phase 3's f16 and f32 checks hold
   the whole path card against CPU at 2 layers); 15b the HTTP server at 4 slots on an f16
   paged pool (serve_four: the shortest and longest prompts' requests
   served again alone); 15c each route knob off in turn (LLAMAFILE_TPU_STACK, _ILGU,
   _FLASH_DECODE, _PRENORM) at 2 layers of llama3-8b width, launches and
   decode routes exact, then whole_path_check card against CPU plain;
   15d a Q2_K file written by the port's writer at llama3-8b widths (1
   layer, PHASE15_VOCAB pieces) loaded, generated from with exact
   launches and held card against the plain versions on the card; 15f the
   same with IQ1_M layers (q8b g 8 with a bias: qmm_dequant at every layer
   product, prefill and decode) and an IQ2_XS head (qmm_q8_m1); 15e a
   4-layer llama3-8b Q4_K file of the full vocabulary by the port's
   writer, load_engine on every CPU with the native repacker (asserted to
   have repacked every Q4_K matrix) timed by piece, extrapolated to 32
   layers, then one Q4_K matrix through the native repacker and the numpy
   path, byte-compared, their times side by side.
16. The LayerNorm families at full width, cut in depth (ln_phase): 16
   starcoder2-7b (StarCoder2-7B's widths, PHASE16_LAYERS = 4 of its 32
   layers: 36 query heads over 4 KV heads, G = 9, the gateless GELU FFN,
   biases on every norm and projection), Q4_K unrolled with a Q6_K head:
   Engine.generate of 64 tokens from the 24-token prompt, launches exact
   (4 qmm_txn_m1 a layer a step, never the fused FFN), the decode rate
   against its weight-read bound, the 1000-token prompt's TTFT (median of
   3, qmm_planes on every product), the HTTP server at 4 slots (4 greedy
   requests, launches exact, the shortest and longest prompts' against
   themselves served alone; then the fused 4-row step at the served rows'
   lengths against its bound); 16b command-r-v01 (Command-R v01's widths,
   PHASE16_CR_LAYERS = 2 of its 40: 64 over 64 heads, SwiGLU at d_ff
   22528, a shared norm, vocab 256000 and its 1.7 GB Q6_K head,
   logit_scale) through Engine.generate, launches exact.
   Phases run in the order 4, 4b, 4d, 5, 4f, 13, 14, 15a-d, 15f, 15e, 4e, 4c, 6, 7, 8, 9, 10,
   11, 12, 16. No profiler session runs in this run: the profiles run apart,

       python3 chip_smoke.py --profiles

   (profile_run: the kernels built, phase 4's engine, its decode step and
   4f's int8 one, the fused and dense 8-row steps timed first; then a
   2-step decode chunk of each under torch.profiler (the device's busy
   share of a step) and under cProfile (host time by function), one
   1000-token prefill (device time by kernel), the fused and dense 8-row
   chunks (busy share), and a batcher admission of a fresh 300-token
   prompt against the same prompt's reused one (admission_profile: host
   time by piece and function, device busy; the one-token slice as a
   decode step against its old bucket-16 einsum route)).

Every phase header (and each phase-3 check's) prints the seconds since the
start and those the previous one took; {"phase_seconds": ...} sums them up
before the launches line.

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the lines before it hold every kernel's
launches summed over the counted runs of phases 4 to 16 ({"launches": ...},
with qmm_planes' launches on a stacked layer's view apart as
"qmm_planes_stacked"), the kernel table (one JSON object with an entry a
kernel: the numbers of its first shape, the main path's heaviest, every
measured shape under "shapes", and those launches; qmm_planes' entry also
"stacked_launches") and the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import cProfile
import functools
import gc
import json
import os
import pstats
import re
import socket
import statistics
import subprocess
import sys
import threading
import time

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores
SAMPLES = 25
FLASH_ROW_TOL = 1.5e-2
PAGED_ROW_TOL = 1e-5              # of each (row, head)'s largest output
# On the serving path's own inputs the synthetic weights give attention
# scores of std 1e3 to 1e5, so f32 sums in another order move a score by
# about 1e-2: the kernel and its plain version part by up to 2.3e-4 of a
# row's max there (H100 readings), and the limit keeps room over that. Near
# one-hot softmax also hides the faulty controls there (a key made visible
# or a page dropped carries no weight): phase 2 holds those.
PAGED_PATH_TOL = 1e-3
# The float KV dtypes (--kv-dtype): (torch dtype, flash_decode_write's limit
# against its plain version, the peak rate of its P.V operands). f16 rounds
# q and p as bf16 does, three mantissa bits finer; f32 rounds nothing, and
# its kernels run on the CUDA cores in f32 (only the order of sums differs)
KV_FLOATS = {"bf16": (lambda t: t.bfloat16, 2e-2, 989e12),
             "f16": (lambda t: t.float16, 2e-2, 989e12),
             "f32": (lambda t: t.float32, 1e-4, 67e12)}
PLANES_TOL = 1e-3                 # f32 out, as the dequant GEMM
PLANES_BF16_TOL = 2 ** -7         # bf16 out: one bf16 step of the largest
DECODE_BF16_ROW_TOL = 2e-2        # p rounded to bf16 against another max
DECODE_INT8_ROW_TOL = 1e-5        # all f32 on the same values
# qmm_i8p repeats its plain version's roundings in the same order (exact
# int32 block dots, the f32 block updates in K order): 1e-6 of the largest
I8P_TOL = 1e-6
KV_BYTES_PER_TOKEN = 32 * 8 * 128 * 2 * 2    # llama3-8b bf16 K and V, 32 layers


T0 = time.time()


def log(*a):
    print(*a, flush=True)


PHASE_TIMES = []                  # (header, seconds since the start)


def phase(msg):
    """A phase header, with the seconds since the script started and those
    the previous header's phase took."""
    now = time.time() - T0
    took = f", previous {now - PHASE_TIMES[-1][1]:.1f} s" if PHASE_TIMES else ""
    PHASE_TIMES.append((msg.strip(), now))
    log(f"{msg} [{now:.1f} s{took}]")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, op_rate: float = INT8_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, n_cycle: int, samples: int = SAMPLES) -> float:
    """Device time of one call. n_cycle calls fn(0..n_cycle-1) are captured
    into one CUDA graph, so the host's dispatch cost is left out; the result
    is the median over `samples` replays, timed between two CUDA events,
    divided by n_cycle."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: first launches, allocations
        for i in range(n_cycle):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_cycle):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n_cycle)
    del graph
    return statistics.median(out)


PLAIN_SAMPLES = 5               # replays timed for a plain version (a yardstick)


def plain_time_ms(torch, fn, n_cycle: int) -> float:
    """time_ms of a kernel's plain version, the median of PLAIN_SAMPLES
    replays: the plain versions take 10-100x their kernels, and their times
    are a yardstick beside the kernel's, not a measurement of the port."""
    return time_ms(torch, fn, n_cycle, PLAIN_SAMPLES)


def q4b_bytes(qs, sc, b):
    return sum(t[0].numel() * t.element_size() for t in (qs, sc, b))


def check_repeat(name, again, got):
    """A second launch on the same inputs must give the same bits (the
    split-K combine sums in a fixed order)."""
    if not again.equal(got):
        raise AssertionError(f"{name}: a second launch on the same inputs differs in "
                             f"{(again != got).sum().item()} elements")
    log(f"  {name}: a second launch gives the same bits")


def check_close(name, got, want, rel):
    from llamafile_tpu_torch.testing import rel_err
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {name}: max_abs_err {err:.6g} (max |ref| {want.float().abs().max().item():.6g}, "
        f"tol {rel} x max)")
    if not rel_err(got, want) <= rel:
        raise AssertionError(f"{name}: kernel and plain version disagree: "
                             f"{err} > {rel} x max |ref|")
    return err


@contextlib.contextmanager
def q4b_flavour(name):
    """The port's q4b kernel flavour (qmatmul.Q4B_KERNEL, which
    LLAMAFILE_TPU_Q4B sets at import) set to `name` inside the block."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    old, Q.Q4B_KERNEL = Q.Q4B_KERNEL, name
    try:
        yield
    finally:
        Q.Q4B_KERNEL = old


def flavour_note() -> str:
    """The q4b flavour in force, for a label ("" for the default txn)."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    return "" if Q.q4b_flavour() == "txn" else f", LLAMAFILE_TPU_Q4B={Q.Q4B_KERNEL}"


# The products of Gemma-3-27B and Gemma-7B by (label, storage N,
# K, layers cycled so that the replays spill the L2)
GEMMA_PRODUCTS = (("Gemma-3-27B qkv", 8192, 5376, 4), ("Gemma-3-27B o (N 5376)", 6144, 4096, 6),
                  ("Gemma-3-27B gate_up", 43008, 5376, 2),
                  ("Gemma-3-27B down (N 5376)", 6144, 21504, 2),
                  ("Gemma-7B qkv", 12288, 3072, 4), ("Gemma-7B o (N 3072)", 4096, 4096, 8),
                  ("Gemma-7B gate_up", 49152, 3072, 2),
                  ("Gemma-7B down (N 3072)", 4096, 24576, 2))


# The products of Qwen3-32B and Qwen2.5-7B by (label, storage N, K, layers
# cycled): Qwen3-32B's qkv (N 10240, K 5120), o (N 5120 in 6144, K 8192:
# H * D is not d), interleaved gate|up (N 51200) and down (K 25600);
# Qwen2.5-7B's qkv (N 4608 in 6144, K 3584), o, concatenated gate|up (N
# 37888 in 38912: d_ff 18944 is not a multiple of 1024, so never fused)
# and down (K 18944)
QWEN_PRODUCTS = (("Qwen3-32B qkv", 10240, 5120, 4), ("Qwen3-32B o (N 5120)", 6144, 8192, 4),
                 ("Qwen3-32B gate_up", 51200, 5120, 2),
                 ("Qwen3-32B down (N 5120)", 6144, 25600, 2),
                 ("Qwen2.5-7B qkv (N 4608)", 6144, 3584, 8),
                 ("Qwen2.5-7B o (N 3584)", 4096, 3584, 12),
                 ("Qwen2.5-7B gate_up (N 37888)", 38912, 3584, 2),
                 ("Qwen2.5-7B down (N 3584)", 4096, 18944, 3))


# The products of the LayerNorm families' phase 16 decode (label, storage
# N, K, layers cycled): StarCoder2-7B's fused qkv (N 5632, K 4608: 18
# superblocks), its gateless up and down (K 18432), Command-R v01's
# interleaved gate|up (N 45056, K 8192); and Falcon-7B's Q8_0 shapes
# (K 4544 = 71 x 64: the dequant GEMM at every M, its head at M = 1 too)
LN_PRODUCTS = (("StarCoder2-7B qkv (N 5632)", 6144, 4608, 6),
               ("StarCoder2-7B up", 18432, 4608, 2),
               ("StarCoder2-7B down (N 4608)", 6144, 18432, 2),
               ("Command-R gate_up", 45056, 8192, 1))
FALCON_Q8 = ((512, "Falcon-7B up (N 18176)", 18432, 4544, 2),
             (1, "Falcon-7B lm_head Q8_0 (N 65024)", 65536, 4544, 1))


def kernel_phases(torch, dev, gen):
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops.repack import q4b_codes
    from llamafile_tpu_torch.testing import (planes_fault, rand_q4b, rand_q8b, rel_err,
                                             txn_scale_swap)
    rows = {}

    def dequant_bf16(qs, sc, b):
        k = qs.shape[-2] * 2
        w = q4b_codes(qs).float().reshape(qs.shape[0], k // 32, 32, -1)
        w = w * sc.float()[:, :, None] + b.float()[:, :, None]
        return w.reshape(qs.shape[0], k, -1).to(torch.bfloat16)

    def entry(name, src, replaces, shape, err, ms, plain, lib, nbytes, ops,
              op_rate=INT8_OPS_PER_S):
        bms, by = bound_ms(nbytes, ops, op_rate)
        meas = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib)
        if name not in rows:     # one entry a kernel: its first shape heads it
            rows[name] = dict(name=name, route="cuda", source=src,
                              replaces=replaces, launches=None, **meas, shapes=[])
        rows[name]["shapes"].append(meas)
        log(f"  {name} [{shape}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib if lib is None else round(lib, 4)} ms, bound "
            f"{bms:.4f} ms ({by}), {bms / ms:.1%} of bound")

    # --- qmm_txn_m1: the decode GEMVs (qkv, o, lm head; down is the fused
    # FFN's phase B on the same body, timed here alone); then
    # Gemma-3-27B's and Gemma-7B's four, gate|up too (a GELU FFN is never
    # fused): K = 5376 is 21 superblocks and 21504 is 84, an odd count of
    # 256-blocks above 4096; n is the storage width (o and down store 5376
    # and 3072 columns padded to 6144 and 4096) ------------------------------
    for label, n, k, layers in (("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12),
                                ("down", 4096, 14336, 3), ("lm_head", 129024, 4096, 1),
                                *GEMMA_PRODUCTS, *QWEN_PRODUCTS, *LN_PRODUCTS):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x, nrm, 1e-5)
        got = Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_m1_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_txn_m1/{label}", got, want, 1e-5)
        check_repeat(f"qmm_txn_m1/{label}", Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0]), got)
        ms = time_ms(torch, lambda i: Q.qmm_txn_m1(xq, sx, qs[i], sc[i], b[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_txn_m1_plain(xq, sx, qs[i], sc[i], b[i]),
                        layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_txn_m1", "llamafile_tpu_torch/csrc/qmm_txn_m1.cu",
              "llamafile_tpu/ops/qmatmul.py:457", f"{label} M=1 N={n} K={k}",
              err, ms, plain, lib, q4b_bytes(qs, sc, b) + k + k // 8 + 4 * n,
              2 * n * k)
        del qs, sc, b

    # --- qmm_txn: prefill products of a 32- and a 16-token bucket ---------
    # (the main path's 24-token prompt runs all four at M = 32), and the
    # serving step's products at M = 8 rows, the unstacked lm head too;
    # then phase 8's Llama-3.2-3B products (storage N padded to 2048): its
    # 24-token prefill at M = 32 and its 4-slot server's rows at M = 4;
    # then the gemma products (K = 5376 and 21504 at Gemma-3-27B's widths):
    # phase 3's and phase 10's 24-token prefills at M = 32, and phase 3's
    # 4-slot Gemma-7B server's rows at M = 4
    for m, label, n, k, layers in ((32, "gate_up", 28672, 4096, 2),
                                   (32, "down", 4096, 14336, 3),
                                   (32, "qkv", 6144, 4096, 8),
                                   (32, "o", 4096, 4096, 12),
                                   (16, "gate_up", 28672, 4096, 2),
                                   (16, "down", 4096, 14336, 3),
                                   (8, "qkv", 6144, 4096, 8),
                                   (8, "o", 4096, 4096, 12),
                                   (8, "gate_up", 28672, 4096, 2),
                                   (8, "down", 4096, 14336, 3),
                                   (8, "lm_head", 129024, 4096, 1),
                                   (32, "3b_qkv", 5120, 3072, 6),
                                   (32, "3b_o", 4096, 3072, 8),
                                   (32, "3b_gate_up", 16384, 3072, 2),
                                   (32, "3b_down", 4096, 8192, 3),
                                   (4, "3b_qkv", 5120, 3072, 6),
                                   (4, "3b_o", 4096, 3072, 8),
                                   (4, "3b_gate_up", 16384, 3072, 2),
                                   (4, "3b_down", 4096, 8192, 3),
                                   (4, "3b_lm_head", 129024, 3072, 1),
                                   *((32, label, n, k, layers)
                                     for label, n, k, layers in GEMMA_PRODUCTS),
                                   *((4, label, n, k, layers)
                                     for label, n, k, layers in GEMMA_PRODUCTS
                                     if label.startswith("Gemma-7B")),
                                   # Qwen's at phase 11's and phase 3's 24-token
                                   # prefills (M = 32) and 4-slot servers (M = 4)
                                   *((m, label, n, k, layers) for m in (32, 4)
                                     for label, n, k, layers in QWEN_PRODUCTS),
                                   # StarCoder2-7B's up at phase 16's 4-slot
                                   # server's rows
                                   (4, *LN_PRODUCTS[1])):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        got = Q.qmm_txn(xq, sx, qs[0], sc[0], b[0])
        want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b[0])
        torch.cuda.synchronize()
        what = f"qmm_txn/{label}/M={m}"
        err = check_close(what, got, want, 1e-5)
        check_repeat(what, Q.qmm_txn(xq, sx, qs[0], sc[0], b[0]), got)
        ctl = rel_err(txn_scale_swap(xq, sx, qs[0], sc[0], b[0]), want)
        log(f"  {what}: swapped-scale-rows control {ctl:.6g} (must exceed 1e-5)")
        if not ctl > 1e-5:
            raise AssertionError(f"{what}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_txn(xq, sx, qs[i], sc[i], b[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_txn_plain(xq, sx, qs[i], sc[i], b[i]), layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_txn", "llamafile_tpu_torch/csrc/qmm_txn.cu",
              "llamafile_tpu/ops/qmatmul.py:276", f"{label} M={m} N={n} K={k}"
              + (" (unstacked)" if label.endswith("lm_head") else ""),
              err, ms, plain, lib,
              q4b_bytes(qs, sc, b) + m * (k + k // 8) + 4 * m * n, 2 * m * n * k)
        del qs, sc, b

    # --- qmm_dequant: the prefill GEMM (q4b M > 32, q8b M >= 2) ----------
    # the 1000-token prompt of phase 4b runs all four q4b shapes at M = 1024,
    # the Q8_0 24-token prompt of phase 4c all four q8b shapes at M = 32
    for kind, m, label, n, k, layers in (
            ("q4b", 1024, "gate_up", 28672, 4096, 2),
            ("q4b", 1024, "down", 4096, 14336, 3),
            ("q4b", 1024, "qkv", 6144, 4096, 8),
            ("q4b", 1024, "o", 4096, 4096, 12),
            ("q4b", 512, "gate_up", 28672, 4096, 2),
            ("q4b", 512, "down", 4096, 14336, 3),
            ("q4b", 512, "qkv", 6144, 4096, 8),
            ("q4b", 512, "o", 4096, 4096, 12),
            ("q4b", 2048, "gate_up", 28672, 4096, 2),
            ("q4b", 2048, "down", 4096, 14336, 3),
            ("q4b", 2048, "qkv", 6144, 4096, 8),
            ("q4b", 2048, "o", 4096, 4096, 12),
            ("q8b", 32, "gate_up", 28672, 4096, 2),
            ("q8b", 32, "down", 4096, 14336, 2),
            ("q8b", 32, "qkv", 6144, 4096, 8),
            ("q8b", 32, "o", 4096, 4096, 12),
            ("q8b", 512, "gate_up", 28672, 4096, 2),
            ("q8b", 512, "down", 4096, 14336, 2),
            # the gemma products at phase 10's bucket (Gemma-3-27B) and at
            # phase 3's 300-token prompt's (Gemma-7B)
            *(("q4b", 1024 if label.startswith("Gemma-3") else 512, label, n, k, layers)
              for label, n, k, layers in GEMMA_PRODUCTS),
            # the Q6_K head of phase 3's 4-slot Gemma-7B server at M = 4
            ("q8b", 4, "Gemma-7B lm_head Q6_K", 256000, 3072, 1),
            # Qwen3-32B's products at phase 11's 1000-token prompt's bucket
            # (M = 1024), its Q6_K head at its 4-slot server's rows (M = 4;
            # N 151936 in 153600), and llama3-8b's four at phase 5's
            # embedding batches of 64 texts of 50 tokens (64 x 64 rows)
            *(("q4b", 1024, label, n, k, layers)
              for label, n, k, layers in QWEN_PRODUCTS if label.startswith("Qwen3")),
            ("q8b", 4, "Qwen3-32B lm_head Q6_K (N 151936)", 153600, 5120, 1),
            ("q4b", 4096, "embed 64x64 gate_up", 28672, 4096, 2),
            ("q4b", 4096, "embed 64x64 down", 4096, 14336, 2),
            ("q4b", 4096, "embed 64x64 qkv", 6144, 4096, 4),
            ("q4b", 4096, "embed 64x64 o", 4096, 4096, 4),
            # q8b g 8 (IQ1_M layers): llama3-8b's four at phase 15f's
            # prompt bucket (M = 32) and at a 1000-token prompt's (1024)
            *(("q8b", m, f"IQ1_M g8 {label}", n, k, layers) for m in (32, 1024)
              for label, n, k, layers in (("gate_up", 28672, 4096, 2),
                                          ("down", 4096, 14336, 2),
                                          ("qkv", 6144, 4096, 8), ("o", 4096, 4096, 12))),
            # Falcon-7B's Q8_0 up at phase 3's 300-token prompt (bucket
            # 512) and its head at a decode step (M = 1: K = 4544 fails
            # qmm_q8_m1's K % 256)
            *(("q8b", *shape) for shape in FALCON_Q8)):
        if kind == "q4b":
            qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        else:
            g = 16 if "Q6_K" in label else 8 if "g8" in label else 32
            qs, sc, _ = rand_q8b(gen, layers, n, k, g, dev)
        wbytes = qs[0].numel() + sc[0].numel() * 2
        # bf16 activations, so the wrapper's cast is not timed with the kernel
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = Q.qmm_dequant(x, qs[0], sc[0])
        want = Q.qmm_dequant_plain(x, qs[0], sc[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_dequant/{kind}/{label}/M={m}", got, want, 1e-3)
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_dequant(x, qs[i], sc[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_dequant_plain(x, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        lib = time_ms(torch, lambda i: torch.matmul(x, w[i]), layers)
        del w
        entry("qmm_dequant", "llamafile_tpu_torch/csrc/qmm_dequant.cu",
              "llamafile_tpu/ops/qmatmul.py:1761", f"{kind} {label} M={m} N={n} K={k}",
              err, ms, plain, lib, wbytes + 2 * m * k + 4 * m * n, 2 * m * n * k,
              BF16_FLOP_PER_S)
        del qs, sc
        torch.cuda.empty_cache()

    vocab_tail_check(torch, dev, gen)

    # --- the dequantized weight tile, bit for bit: with x = I (K = 1024
    # one-hot rows) each output sum has one nonzero term, so y[k, :] must
    # equal dequant_bf16's row k (values compared: the f32 sum turns a -0
    # product into +0)
    for kind in ("q4b", "q8b g32", "q8b g16", "q8b g8"):
        k, n = 1024, 1040
        qs, sc, _ = (rand_q4b(gen, 1, n, k, dev) if kind == "q4b"
                     else rand_q8b(gen, 1, n, k, int(kind.split("g")[-1]), dev))
        got = Q.qmm_dequant(torch.eye(k, device=dev), qs[0], sc[0])
        n_bad = int((got != Q.dequant_bf16(qs[0], sc[0]).float()).sum())
        log(f"  qmm_dequant/{kind} one-hot x = I, K={k} N={n}: {n_bad} of {got.numel()} "
            "outputs differ from dequant_bf16")
        if n_bad:
            raise AssertionError(f"qmm_dequant {kind}: the dequantized tile is not "
                                 "dequant_bf16's, bit for bit")
        del qs, sc, got

    # --- qmm_planes: the unrolled (Q4_K_M) prefill GEMM, unstacked q4b ---
    # phase 6's 1000-token prompt runs all four at M = 1024 (bf16 out);
    # M = 128 is a 128-token bucket (f32 out). Then the stacked form (row
    # 12) on layer 1 of a stack: gate|up at M = 1024 (the stacked prefill
    # under the int8 and planes flavours) and M = 8 (the planes flavour's
    # decode step). The control swaps each superblock's lo and hi scale rows.
    for m, label, n, k, layers, li in ((1024, "gate_up", 28672, 4096, 2, 0),
                                       (1024, "down", 4096, 14336, 3, 0),
                                       (1024, "qkv", 6144, 4096, 8, 0),
                                       (1024, "o", 4096, 4096, 12, 0),
                                       (128, "qkv", 6144, 4096, 8, 0),
                                       # phase 16's 1000-token prompt: StarCoder2-7B's down
                                       (1024, *LN_PRODUCTS[2], 0),
                                       (1024, "gate_up", 28672, 4096, 2, 1),
                                       (8, "gate_up", 28672, 4096, 2, 1)):
        qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = Q.qmm_planes(x, qs[li], sc[li])
        want = Q.qmm_planes_plain(x, qs[li], sc[li])
        torch.cuda.synchronize()
        tol = PLANES_TOL if m < 256 else PLANES_BF16_TOL
        where = (f", layer {li} of {layers} (stacked: _qmm_kernel_planes_l, qmatmul.py:1631)"
                 if li else "")
        err = check_close(f"qmm_planes/{label}/M={m}{where} ({got.dtype})", got, want, tol)
        ctl = rel_err(planes_fault(x, qs[li], sc[li]), want)
        log(f"  qmm_planes/{label}/M={m}: swapped-scale-rows control {ctl:.6g} (must exceed {tol})")
        if not ctl > tol:
            raise AssertionError(f"qmm_planes {label}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_planes(x, qs[i], sc[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_planes_plain(x, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        lib = time_ms(torch, lambda i: torch.matmul(x, w[i]), layers)
        del w
        entry("qmm_planes", "llamafile_tpu_torch/csrc/qmm_planes.cu",
              "llamafile_tpu/ops/qmatmul.py:117", f"{label} M={m} N={n} K={k}{where}",
              err, ms, plain, lib,
              qs[0].numel() + sc[0].numel() * 2 + 2 * m * k + (2 if m >= 256 else 4) * m * n,
              2 * m * n * k, BF16_FLOP_PER_S)
        del qs, sc
        torch.cuda.empty_cache()

    # --- qmm_q8_m1: the Q8_0 decode GEMVs and the Q6_K lm head -----------
    for label, g, n, k, layers in (("qkv Q8_0", 32, 6144, 4096, 8),
                                   ("o Q8_0", 32, 4096, 4096, 12),
                                   ("gate_up Q8_0", 32, 28672, 4096, 2),
                                   ("down Q8_0", 32, 4096, 14336, 2),
                                   ("lm_head Q8_0", 32, 129024, 4096, 1),
                                   ("lm_head Q6_K", 16, 129024, 4096, 1),
                                   ("Gemma-3-27B lm_head Q6_K", 16, 262144, 5376, 1),
                                   ("Gemma-7B lm_head Q6_K", 16, 256000, 3072, 1),
                                   ("Qwen3-32B lm_head Q6_K (N 151936)", 16, 153600, 5120, 1),
                                   ("Qwen2.5-7B lm_head Q6_K (N 152064)", 16, 153600, 3584, 1),
                                   ("StarCoder2-7B lm_head Q6_K", 16, 49152, 4608, 1),
                                   ("Command-R lm_head Q6_K", 16, 256000, 8192, 1)):
        qs, sc, _ = rand_q8b(gen, layers, n, k, g, dev)
        x = torch.randn((1, k), generator=gen, device=dev)
        nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x, nrm, 1e-5)
        got = Q.qmm_q8_m1(xq, sx, qs[0], sc[0])
        want = Q.qmm_q8_m1_plain(xq, sx, qs[0], sc[0])
        torch.cuda.synchronize()
        err = check_close(f"qmm_q8_m1/{label}", got, want, 1e-5)
        ms = time_ms(torch, lambda i: Q.qmm_q8_m1(xq, sx, qs[i], sc[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_q8_m1_plain(xq, sx, qs[i], sc[i]), layers)
        w = torch.stack([Q.dequant_bf16(qs[i], sc[i]) for i in range(layers)])
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        entry("qmm_q8_m1", "llamafile_tpu_torch/csrc/qmm_q8_m1.cu",
              "llamafile_tpu/ops/qmatmul.py:684", f"{label} M=1 N={n} K={k}", err, ms,
              plain, lib, qs[0].numel() + sc[0].numel() * 2 + k + k // 8 + 4 * n,
              2 * n * k)
        del qs, sc
        torch.cuda.empty_cache()

    # --- flash_prefill: causal prefill attention over the fresh prompt ----
    # llama3-8b's 32 over 8 heads, then Gemma-3-27B's 32 over 16
    # at D = 128 and Gemma-7B's 16 over 16 at D = 256 (a group of 1) at its
    # 1000-token prompt's bucket
    for hq, hkv, hd, t, sets, model in ((32, 8, 128, 1024, 2, ""), (32, 8, 128, 512, 4, ""),
                                        (32, 8, 128, 2048, 2, ""),
                                        (32, 16, 128, 1024, 2, "Gemma-3-27B "),
                                        (16, 16, 256, 1024, 2, "Gemma-7B "),
                                        (64, 8, 128, 1024, 2, "Qwen3-32B "),
                                        (28, 4, 128, 1024, 2, "Qwen2.5-7B "),
                                        (36, 4, 128, 1024, 2, "StarCoder2-7B "),
                                        (71, 1, 64, 512, 4, "Falcon-7B ")):
        prefill_phase(torch, dev, gen, entry, hq, hkv, hd, t, sets, model)
    # B > 1: phase 5's embedding batches of 500-token texts (8 rows of
    # bucket 512) at llama3-8b's heads, and B = 64 at T = 128
    for b, t in ((8, 512), (64, 128)):
        prefill_phase(torch, dev, gen, entry, 32, 8, 128, t, 2, f"B={b} ", b=b)

    # --- qmm_moe_m1: the fused decode FFN, layer as expert: llama3-8b's,
    # then Qwen3-32B's (d_ff 25600 = 25 x 1024) ----------------------------
    for d, dff, layers in ((4096, 14336, 2), (5120, 25600, 2)):
        moe_m1_phase(torch, dev, gen, entry, d, dff, layers)

    # --- flash_decode_write: decode attention + KV-row write --------------
    # one launch of B * Hkv * head_chunks(G) clusters of FDW_CLUSTER blocks;
    # llama3-8b's group of 4 (32 query heads over 8 KV heads), then the
    # groups of 3 (Llama-3.2-3B, one chunk with masked columns) and 16 (two
    # chunks, each reading the K/V rows) at pos 700, then head_dim 256
    # (DECODE_GROUPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for hq, hkv, hd, cases in DECODE_GROUPS["flash_decode_write"]:
        fdw_phase(torch, dev, gen, entry, sdpa, hq, cases, hkv, hd)

    # --- flash_decode: decode attention over one layer of a dense cache ---
    # bf16 flat [L, B, S, Hkv*D] (the qt contract, flash_decode_stacked) and
    # int8 [L, B, S, Hkv, D] codes with f32 scales (phase 4d's cache), 32
    # layers so the replays spill the L2; pos near the end of s_eff; one
    # launch of thread-block clusters, a group of up to 16 heads from one
    # K/V read. The controls: one masked key made visible,
    # and the second half of the visible keys dropped.
    for hq, hkv, hd, cases in DECODE_GROUPS["flash_decode"]:
        for int8, s_eff in cases:
            flash_decode_phase(torch, dev, gen, entry, sdpa, hq, int8, s_eff, hkv, hd)
    # --- both at B = 8, the batcher's dense row mode: a position a row, one
    # row parked at the trash slot S - 1, past s_limit
    batched_decode_phase(torch, dev, gen, entry, sdpa)
    # --- gemma2's window and softcap options of both decode kernels, then
    # gemma3's window on flash_decode_write at Gemma-3-27B's decode shapes
    gemma_option_phase(torch, dev, gen, entry)
    gemma_option_phase(torch, dev, gen, entry, "Gemma-3-27B", **GEMMA3_OPTIONS)

    # --- paged_attention: the serving decode attention, 8 rows ------------
    for hq, hkv, hd, cases in DECODE_GROUPS["paged_attention"]:
        for label, lengths, int8 in cases:
            paged_phase(torch, dev, gen, entry, sdpa, hq, label, lengths, int8, hkv, hd)
    # --- the f16 and f32 caches (--kv-dtype f16|f32) of the three decode
    # kernels at the main path's shapes: llama3-8b's group of 4
    # (flash_decode_write at pos 700 and 1900 and at B = 8, flash_decode at
    # s_eff 2048 and 1024, paged_attention at 8 rows of 1024), and one
    # head_dim-256 shape each (Gemma-2-9B's 16 over 8)
    for kv in ("f16", "f32"):
        fdw_phase(torch, dev, gen, entry, sdpa, 32, ((700, 1024), (1900, 2048)), 8, 128, kv)
        fdw_phase(torch, dev, gen, entry, sdpa, 16, ((700, 1024),), 8, 256, kv)
        batched_decode_phase(torch, dev, gen, entry, sdpa, kv=kv)
        for hq, hd, s_eff in ((32, 128, 2048), (32, 128, 1024), (16, 256, 2048)):
            flash_decode_phase(torch, dev, gen, entry, sdpa, hq, False, s_eff, 8, hd, kv)
        for hq, hd in ((32, 128), (16, 256)):
            paged_phase(torch, dev, gen, entry, sdpa, hq, f"{kv}, every length 1024",
                        [1024] * 8, False, 8, hd, kv)
    i8p_kernel_phase(torch, dev, gen, entry)
    moe_kernel_phases(torch, dev, gen, entry, dequant_bf16)
    int8_kernel_phase(torch, dev, gen, entry, dequant_bf16)
    return list(rows.values())


# the prompt lengths of the served requests (phases 5, 6, 7c and 8), and
# those whose requests are served again alone, the shortest and the longest
SERVE_LENGTHS = (24, 128, 500, 1000)
ALONE_LENGTHS = (24, 1000)

# Phase 2's decode attention shapes by (query heads, KV heads, head dim):
# llama3-8b's 32 over 8 at D = 128 (a group of 4) first, as in earlier runs,
# then 24 over 8 (a group of 3: the shapes of phase 8's decode too) and 128
# over 8 (16: two head chunks of flash_decode_write, one of flash_decode and
# paged_attention), bf16 and int8; then head_dim 256: Gemma-2-9B's 16 over
# 8 (a group of 2) and Gemma-2B's 8 over 1 (8: phase 3's head_dim-256 model),
# and for paged_attention Gemma-7B's 16 over 16 (1)
DECODE_GROUPS = {
    # (pos, s_eff): pos 700 heads the entry (the shape of earlier runs); pos
    # 64 / s_eff 256 is phase 4's decode (64 tokens after a 24-token prompt),
    # pos 40 / s_eff 256 at 24 heads phase 8's (32 tokens after the same prompt)
    "flash_decode_write": [(32, 8, 128, ((700, 1024), (1900, 2048), (64, 256))),
                           (24, 8, 128, ((700, 1024), (40, 256))),
                           (128, 8, 128, ((700, 1024),)),
                           (16, 8, 256, ((700, 1024), (1900, 2048))),
                           (8, 1, 256, ((700, 1024),)),
                           # Qwen3-32B's 64 over 8 (G = 8), Qwen2.5-7B's 28
                           # over 4 (G = 7), and their phase 11/12 decode
                           (64, 8, 128, ((700, 1024), (64, 256))),
                           (28, 4, 128, ((700, 1024), (64, 256))),
                           # StarCoder2-7B's 36 over 4 (G = 9: two chunks,
                           # 8 heads and 1) at phase 16's decode
                           (36, 4, 128, ((64, 256),))],
    # (int8, s_eff)
    "flash_decode": [(32, 8, 128, ((False, 1024), (False, 2048), (True, 1024), (True, 2048))),
                     (24, 8, 128, ((False, 2048), (True, 2048))),
                     (128, 8, 128, ((False, 2048), (True, 2048))),
                     (16, 8, 256, ((False, 2048), (True, 2048))),
                     (8, 1, 256, ((False, 2048), (True, 2048))),
                     (64, 8, 128, ((True, 2048),)),
                     (28, 4, 128, ((True, 2048),))],
    # (label, lengths, int8): 8 rows, and at 24 heads also the 4 rows of
    # phase 8's server (serve_four's prompts, 32 tokens into their answers)
    "paged_attention": [
        (32, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                      ("bf16, lengths 1..2048", [1, 63, 64, 65, 700, 1024, 1500, 2048], False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (24, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True),
                      ("bf16, phase 8's 4 served rows", [n + 32 for n in SERVE_LENGTHS],
                       False))),
        (128, 8, 128, (("bf16, every length 1024", [1024] * 8, False),
                       ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (16, 8, 256, (("bf16, every length 1024", [1024] * 8, False),
                      ("int8 + f32 scales, every length 1024", [1024] * 8, True))),
        (8, 1, 256, (("bf16, every length 1024", [1024] * 8, False),)),
        # Gemma-7B's 16 over 16 (a group of 1) at D = 256
        (16, 16, 256, (("bf16, every length 1024", [1024] * 8, False),)),
        # Qwen3-32B's 64 over 8 and Qwen2.5-7B's 28 over 4
        (64, 8, 128, (("bf16, every length 1024", [1024] * 8, False),)),
        (28, 4, 128, (("bf16, every length 1024", [1024] * 8, False),)),
        # StarCoder2-7B's 36 over 4 (G = 9) at phase 16's 4 served rows
        (36, 4, 128, (("bf16, phase 16's 4 served rows", [n + 32 for n in SERVE_LENGTHS],
                       False),))],
}


def group_note(hq: int, hkv: int, most: int = 8) -> str:
    """The head group of a decode shape and the K/V reads of its chunks
    (chunks of up to `most` heads: attention.head_chunks)."""
    from llamafile_tpu_torch.ops.attention import head_chunks
    g = hq // hkv
    nc = head_chunks(g, most)
    return f"G={g}" + (f" in {nc} chunks, each reading the K/V rows" if nc > 1
                       else ", one K/V read" if g > 8 else "")


def paged_work(lengths, hq, hkv, hd, int8, elem=2):
    """(bytes, operations, op rate) of paged_attention's bound: each visible
    K/V row read once (elem bytes an element; int8: its f32 scale too), q
    read and the output written in f32; the f32 flops of scores and P.V on
    the CUDA cores."""
    kv_bytes = sum(lengths) * hkv * hd * 2 * (1 + 4 / hd if int8 else elem)
    return (kv_bytes + 2 * len(lengths) * hq * hd * 4, 4 * sum(lengths) * hq * hd,
            F32_FLOP_PER_S)


def paged_yardstick(torch, q, kp, vp, ks, vs, lens, tables, nl):
    """The library yardstick of paged_attention, fn(i) on layer i of nl:
    sdpa over K/V gathered to dense [R, Hkv, S, D] beforehand, in the pages'
    dtype (bf16 for an int8 pool, dequantized; the gather and the dequant not
    timed) with a length mask; the G query heads of a KV head ride as G
    queries."""
    r, hq, hd = q.shape
    hkv, _, ps, _ = kp.shape[1:]
    maxp = tables.shape[1]
    t = tables.long()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = torch.bfloat16 if ks is not None else kp.dtype

    def dense(pages, scales, i):
        x = pages[i][:, t]                                 # [Hkv, R, MAXP, ps, D]
        if scales is not None:
            x = x.float() * scales[i][:, t]
        return x.permute(1, 0, 2, 3, 4).reshape(r, hkv, maxp * ps, hd).to(dt)
    kd = [dense(kp, ks, i) for i in range(nl)]
    vd = [dense(vp, vs, i) for i in range(nl)]
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < lens[:, None].long())[:, None, None]
    qg = q.to(dt).reshape(r, hkv, hq // hkv, hd)
    return lambda i: sdpa(qg, kd[i], vd[i], attn_mask=mask, scale=1.0)


def moe_m1_phase(torch, dev, gen, entry, d, dff, layers):
    """Phase 2 for qmm_moe_m1, the fused decode FFN of stacked layers (the
    layer id as the expert id) at d and d_ff, over `layers` layers cycled:
    against its plain version, a second launch bitwise, timed."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b
    gq, gs, gb = rand_q4b(gen, layers, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, layers, d, dff, dev)
    x = torch.randn((1, d), generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x, 1 + 0.1 * torch.randn(d, generator=gen, device=dev), 1e-5)
    ids = torch.arange(layers, dtype=torch.int32, device=dev)   # the layer id as expert
    one = torch.ones(1, device=dev)
    args = lambda i: (xq, sx, gq, gs, gb, dq, ds, db, ids[i:i + 1], None, one)
    what = "qmm_moe_m1" if (d, dff) == (4096, 14336) else f"qmm_moe_m1/d={d} d_ff={dff}"
    got = Q.qmm_moe_m1(*args(0))
    want = Q.qmm_moe_m1_plain(*args(0))
    torch.cuda.synchronize()
    err = check_close(what, got, want, 2e-3)
    check_repeat(what, Q.qmm_moe_m1(*args(0)), got)
    ms = time_ms(torch, lambda i: Q.qmm_moe_m1(*args(i)), layers)
    plain = plain_time_ms(torch, lambda i: Q.qmm_moe_m1_plain(*args(i)), layers)
    entry("qmm_moe_m1", "llamafile_tpu_torch/csrc/qmm_moe_m1.cu",
          "llamafile_tpu/ops/qmatmul.py:1037", f"ffn M=1 d={d} d_ff={dff}",
          err, ms, plain, None,
          q4b_bytes(gq, gs, gb) + q4b_bytes(dq, ds, db) + d + d // 8 + 4 * d,
          2 * (2 * dff * d + d * dff))
    del gq, gs, gb, dq, ds, db
    torch.cuda.empty_cache()


def vocab_tail_check(torch, dev, gen, n=151936, k=5120):
    """Qwen3-32B's Q6_K head (vocab 151936, not a multiple of 256, stored in
    153600 columns) through qmatmul as the model calls it: at M = 1 on
    qmm_q8_m1 and at M = 4 on qmm_dequant, the logits the sampler sees are
    [M, 151936], and the last column tile (the 128 columns below 151936)
    and the whole output agree with the plain versions on the card."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops.repack import QTensor
    from llamafile_tpu_torch.testing import rand_q8b
    ns = -(-n // 2048) * 2048
    qs, sc, _ = rand_q8b(gen, 1, ns, k, 16, dev)
    head = QTensor("q8b", (n, k), 16, qs[0], sc[0], None)
    nrm = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    for m, kernel, tol in ((1, "qmm_q8_m1", 1e-5), (4, "qmm_dequant", 1e-3)):
        x = torch.randn((m, k), generator=gen, device=dev)
        before = launch_counts()[kernel]
        got = Q.qmatmul(x, head, prenorm=(nrm, 1e-6))
        launched = launch_counts()[kernel] - before
        with plain_kernels():
            want = Q.qmatmul(x, head, prenorm=(nrm, 1e-6))
        torch.cuda.synchronize()
        what = f"{kernel}/Qwen3-32B head M={m} N={n} (stored {ns})"
        if tuple(got.shape) != (m, n) or launched != 1:
            raise AssertionError(f"{what}: logits {tuple(got.shape)}, {launched} launches")
        check_close(f"{what}, last tile [{n - 128}, {n})", got[:, n - 128:], want[:, n - 128:],
                    tol)
        check_close(f"{what}, every column", got, want, tol)
    del qs, sc, head


def prefill_work(t, hq, hkv, hd, b=1):
    """(bytes, operations, op rate) of flash_prefill's bound over b rows: q,
    k, v read and the output written once in bf16; the causal products'
    bf16 flops."""
    return (b * (t * (hq + 2 * hkv) + t * hq) * hd * 2, b * 2 * hq * hd * t * (t + 1),
            BF16_FLOP_PER_S)


def prefill_phase(torch, dev, gen, entry, hq, hkv, hd, t, sets, model="", b=1):
    """Phase 2 for flash_prefill over b rows at hq query heads over hkv KV
    heads of head dim hd and T = t, over `sets` sets of inputs cycled: row by row against
    its plain version (two bf16 steps of an output, as in
    tests/test_torch_cuda.py; the control drops each query's diagonal key
    tile and must fail that), timed beside its plain version and sdpa."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import flash_prefill_tile_fault, row_rel_err
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # bf16 inputs, so the wrapper's casts are not timed with the kernel
    qkv = [[torch.randn((b, t, h, hd), generator=gen, device=dev).to(torch.bfloat16)
            for h in (hq, hkv, hkv)] for _ in range(sets)]
    scale = hd ** -0.5
    what = f"flash_prefill/{model}Hq={hq} Hkv={hkv} D={hd} T={t}"
    got = A.flash_prefill(*qkv[0], scale)
    want = A.flash_prefill_plain(*qkv[0], scale)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    row = row_rel_err(got, want)
    fault = row_rel_err(flash_prefill_tile_fault(*qkv[0], scale), want)
    log(f"  {what}: max_abs_err {err:.6g}; per row {row:.6g} of the row's max (tol "
        f"{FLASH_ROW_TOL}); diagonal-tile fault control {fault:.6g}")
    if not row <= FLASH_ROW_TOL < fault:
        raise AssertionError(f"{what}: row error {row}, control {fault}")
    if not torch.equal(A.flash_prefill(*qkv[0], scale), got):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    ms = time_ms(torch, lambda i: A.flash_prefill(*qkv[i], scale), sets)
    plain = plain_time_ms(torch, lambda i: A.flash_prefill_plain(*qkv[i], scale), sets)
    heads = [[a.transpose(1, 2) for a in trio] for trio in qkv]
    lib = time_ms(torch, lambda i: sdpa(*heads[i], is_causal=True, scale=scale,
                                        enable_gqa=True), sets)
    check_close(f"{what} vs sdpa (yardstick sanity)", got,
                sdpa(*heads[0], is_causal=True, scale=scale, enable_gqa=True).transpose(1, 2),
                2e-2)
    entry("flash_prefill", "llamafile_tpu_torch/csrc/flash_prefill.cu",
          "llamafile_tpu/ops/attention.py:57", f"{model}Hq={hq} Hkv={hkv} D={hd} T={t}",
          err, ms, plain, lib, *prefill_work(t, hq, hkv, hd, b))    # bf16 values out
    del qkv, heads, got, want
    torch.cuda.empty_cache()


def fdw_phase(torch, dev, gen, entry, sdpa, hq, cases, hkv=8, hd=128, kv="bf16"):
    """Phase 2 for flash_decode_write at hq query heads over hkv KV heads of
    head dim hd over a cache of dtype kv (KV_FLOATS), at each (pos, s_eff)
    of cases: against its plain version within its tolerance and with the
    written rows equal, two launches bitwise equal, timed beside its plain
    version and sdpa on the same dtype."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import FDW_CLUSTER, FDW_WARPS
    nl, s_len = 32, 2048
    scale = hd ** -0.5
    dt, tol = KV_FLOATS[kv][0](torch), KV_FLOATS[kv][1]
    k3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(dt)
    v3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev)).to(dt)
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    kn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    vn = torch.randn((1, hkv, hd), generator=gen, device=dev)
    chunks = A.head_chunks(hq // hkv)
    log(f"  flash_decode_write {group_note(hq, hkv)} {kv}: clusters of {FDW_CLUSTER} blocks, "
        f"{hkv * chunks * FDW_CLUSTER} blocks of "
        f"{32 * (2 if kv == 'f32' and hd == 256 else FDW_WARPS)} threads at B=1 Hkv={hkv}")
    for pos, s_eff in cases:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        k3b, v3b = k3.clone(), v3.clone()
        got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 5, p, scale, hkv, s_limit=s_eff)
        want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 5, p, scale, hkv, s_eff)
        torch.cuda.synchronize()
        err = check_close(f"flash_decode_write/{kv} pos={pos}", got, want, tol)
        if not (torch.equal(k3, k3b) and torch.equal(v3, v3b)):
            raise AssertionError("flash_decode_write: the written cache rows differ")
        again = A.flash_decode_write_stacked(q, k3b, v3b, kn, vn, 5, p, scale, hkv,
                                             s_limit=s_eff)
        if not (torch.equal(again, got) and torch.equal(k3, k3b) and torch.equal(v3, v3b)):
            raise AssertionError("flash_decode_write: two launches on the same inputs differ")
        log(f"  flash_decode_write/pos={pos}: two launches bitwise equal")
        del k3b, v3b, again
        run = lambda i: A.flash_decode_write_stacked(q, k3, v3, kn, vn, i, p, scale, hkv,
                                                     s_limit=s_eff)
        ms = time_ms(torch, run, nl)
        plain = plain_time_ms(torch, lambda i: A.flash_decode_write_plain(
            q, k3, v3, kn, vn, i, p, scale, hkv, s_eff), nl)
        qs4 = q.to(dt).reshape(1, hq, 1, hd)
        kvs = lambda t, i: t[i, :, :pos + 1].reshape(1, pos + 1, hkv, hd).transpose(1, 2)
        lib = time_ms(torch, lambda i: sdpa(qs4, kvs(k3, i), kvs(v3, i), scale=scale,
                                            enable_gqa=True), nl)
        sdpa_out = sdpa(qs4, kvs(k3, 5), kvs(v3, 5), scale=scale, enable_gqa=True)
        check_close("flash_decode_write vs sdpa (yardstick sanity)",
                    got.reshape(1, hq, 1, hd), sdpa_out, 2e-2)
        log(f"  flash_decode_write/{kv} pos={pos}: kernel / sdpa {ms / lib:.3f}")
        row, eb = hkv * hd, k3.element_size()
        entry("flash_decode_write", "llamafile_tpu_torch/csrc/flash_decode_write.cu",
              "llamafile_tpu/ops/attention.py:217",
              f"{kv} cache Hq={hq} Hkv={hkv} D={hd} s_eff={s_eff} pos={pos} "
              f"cluster={FDW_CLUSTER}"
              + ("" if chunks == 1 else f" ({group_note(hq, hkv)}: the kernel reads "
                 f"{chunks}x the bound's K/V bytes)"), err, ms,
              plain, lib, 2 * pos * row * eb + 2 * row * eb + (2 * hq * hd + 2 * row) * 4,
              4 * pos * hq * hd, KV_FLOATS[kv][2])
    del k3, v3
    torch.cuda.empty_cache()


def flash_decode_phase(torch, dev, gen, entry, sdpa, hq, int8, s_eff, hkv=8, hd=128,
                       kv="bf16"):
    """Phase 2 for flash_decode at hq query heads over hkv KV heads of head
    dim hd, over a flat cache of dtype kv (KV_FLOATS) or an int8 cache of
    s_eff positions, pos near its end: row by row against its plain
    version, the controls (one masked key made visible, the second half of
    the visible keys dropped) outside the tolerance, two launches bitwise
    equal, timed beside its plain version and sdpa. One launch of B * Hkv
    * head_chunks(G, FD_CHUNK_HEADS) clusters, every K/V row read once a
    chunk."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    nl = 32
    scale = hd ** -0.5
    g = hq // hkv
    pos = s_eff - 5
    label = (f"{'int8 + f32 scales' if int8 else kv + ' flat'}, s_eff={s_eff} pos={pos}"
             + ("" if g <= 8 else f", {group_note(hq, hkv, A.FD_CHUNK_HEADS)}"))
    q = torch.randn((1, hq, hd), generator=gen, device=dev)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    if int8:
        kc, vc = (torch.randint(-127, 128, (nl, 1, s_eff, hkv, hd), generator=gen,
                                device=dev, dtype=torch.int8) for _ in range(2))
        ksc, vsc = (torch.empty((nl, 1, s_eff, hkv), device=dev).uniform_(
            2e-3, 2e-2, generator=gen) for _ in range(2))
        run = lambda i, pp=p: A.flash_decode(q, kc[i], vc[i], pp, scale,
                                             k_scale=ksc[i], v_scale=vsc[i])
        plain_fn = lambda i, pp=p: A.flash_decode_plain(q, kc[i], vc[i], pp, scale,
                                                        k_scale=ksc[i], v_scale=vsc[i])
        kv_bytes = 2 * (pos + 1) * hkv * (hd + 4)
        tol = DECODE_INT8_ROW_TOL
    else:
        dt = KV_FLOATS[kv][0](torch)
        kc, vc = ((torch.randn((nl, 1, s_eff, hkv * hd), generator=gen, device=dev)
                   ).to(dt) for _ in range(2))
        run = lambda i, pp=p: A.flash_decode_stacked(q, kc, vc, i, pp, scale, hkv)
        plain_fn = lambda i, pp=p: A.flash_decode_stacked_plain(
            q, kc, vc, i, pp, scale, hkv, s_eff)
        kv_bytes = 2 * (pos + 1) * hkv * hd * kc.element_size()
        tol = DECODE_INT8_ROW_TOL if kv == "f32" else DECODE_BF16_ROW_TOL
    got, want = run(5), plain_fn(5)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row = row_rel_err(got, want)
    ctl = [row_rel_err(plain_fn(5, p + 1), want), row_rel_err(plain_fn(5, p // 2), want)]
    # bf16, f16: one key moves less than p's rounding
    held = ctl if int8 or kv == "f32" else ctl[1:]
    log(f"  flash_decode/{label}: max_abs_err {err:.6g}; per row {row:.6g} of the "
        f"row's max (tol {tol}); controls (one masked key visible, half the keys "
        f"dropped) {ctl[0]:.6g}, {ctl[1]:.6g}")
    if not row <= tol < min(held):
        raise AssertionError(f"flash_decode {label}: row error {row}, controls {ctl}")
    if not torch.equal(got, run(5)):
        raise AssertionError("flash_decode: two runs on the same inputs differ")
    ms = time_ms(torch, run, nl)
    plain = plain_time_ms(torch, plain_fn, nl)
    # the library yardstick: sdpa over the visible K/V, dequantized to
    # f32 (int8) or kept bf16 beforehand (not timed)
    def dense(c, s, i):
        x = c[i, 0, :pos + 1].reshape(pos + 1, hkv, hd)
        x = x.float() * s[i, 0, :pos + 1][..., None] if s is not None else x
        return x.transpose(0, 1)[None]                     # [1, Hkv, S, D]
    kd = [dense(kc, ksc if int8 else None, i) for i in range(nl)]
    vd = [dense(vc, vsc if int8 else None, i) for i in range(nl)]
    qd = (q if int8 else q.to(kc.dtype)).reshape(1, hq, 1, hd)
    lib_fn = lambda i: sdpa(qd, kd[i], vd[i], scale=scale, enable_gqa=True)
    lib = time_ms(torch, lib_fn, nl)
    check_close(f"flash_decode/{label} vs sdpa (yardstick sanity)",
                got.reshape(1, hq, 1, hd), lib_fn(5), 2e-2)
    entry("flash_decode", "llamafile_tpu_torch/csrc/flash_decode.cu",
          "llamafile_tpu/ops/attention.py:117",
          f"B=1 Hq={hq} Hkv={hkv} D={hd} {label} (library: sdpa on K/V "
          "dequantized beforehand)", err, ms, plain, lib,
          kv_bytes + 2 * hq * hd * 4 + 4, 4 * (pos + 1) * hq * hd,
          F32_FLOP_PER_S if int8 else KV_FLOATS[kv][2])
    del kc, vc, kd, vd, got, want
    if int8:
        del ksc, vsc
    torch.cuda.empty_cache()


# The dense row mode's fused step at 8 rows of llama3-8b (32 query heads
# over 8 KV heads, D 128): a 2048-position cache streamed to s_limit 1024
# (an attn_bucket), each row at its own position, the last row parked at
# the trash slot S - 1 = 2047, past s_limit (it reads every streamed key)
DENSE_POS = (23, 150, 333, 511, 640, 777, 1000, 2047)
DENSE_S, DENSE_S_LIMIT = 2048, 1024


def batched_decode_phase(torch, dev, gen, entry, sdpa, nl=8, kv="bf16"):
    """Phase 2 at B = 8 (DENSE_POS): flash_decode_write (each row's new K/V
    written at its pos, the parked row's at S - 1 only) and flash_decode
    over the bf16 flat and the int8 cache, each against its plain version
    within 2e-2 (int8: DECODE_INT8_ROW_TOL) with the written rows equal,
    two launches bitwise equal, timed beside the plain version and sdpa
    with a key mask a row. nl layers cycled. kv "f16" or "f32": only
    flash_decode_write, over a cache of that dtype (KV_FLOATS)."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    hq, hkv, hd, b = 32, 8, 128, len(DENSE_POS)
    s_len, s_eff, row = DENSE_S, DENSE_S_LIMIT, hkv * hd
    scale = hd ** -0.5
    p = torch.tensor(DENSE_POS, dtype=torch.int32, device=dev)
    shape = (f"{kv} cache B={b} Hq={hq} Hkv={hkv} D={hd} S={s_len} s_limit={s_eff} "
             f"pos={list(DENSE_POS)}")
    q = torch.randn((b, hq, hd), generator=gen, device=dev)
    kn = torch.randn((b, hkv, hd), generator=gen, device=dev)
    vn = torch.randn((b, hkv, hd), generator=gen, device=dev)
    dt = KV_FLOATS[kv][0](torch)
    k3, v3 = ((torch.randn((nl, b, s_len, row), generator=gen, device=dev)
               ).to(dt) for _ in range(2))
    k0, v0 = k3.clone(), v3.clone()
    k3b, v3b = k3.clone(), v3.clone()
    got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 5, p, scale, hkv, s_limit=s_eff)
    want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 5, p, scale, hkv, s_eff)
    torch.cuda.synchronize()
    err = check_close(f"flash_decode_write/{kv} B=8", got, want, KV_FLOATS[kv][1])
    if not (torch.equal(k3, k3b) and torch.equal(v3, v3b)):
        raise AssertionError("flash_decode_write B=8: the written cache rows differ")
    changed = (k3 != k0).any(-1).nonzero().tolist()
    if sorted(changed) != sorted([5, r, x] for r, x in enumerate(DENSE_POS)):
        raise AssertionError(f"flash_decode_write B=8 wrote rows {changed}")
    again = A.flash_decode_write_stacked(q, k3b, v3b, kn, vn, 5, p, scale, hkv,
                                         s_limit=s_eff)
    if not (torch.equal(again, got) and torch.equal(k3, k3b)):
        raise AssertionError("flash_decode_write B=8: two launches differ")
    log(f"  flash_decode_write/B=8: rows written at each pos only (the parked row at "
        f"{s_len - 1}); two launches bitwise equal")
    del k0, v0, k3b, v3b, again
    seen = [min(x, s_eff) for x in DENSE_POS]       # cache rows each row reads
    mask = (torch.arange(s_eff, device=dev)[None, :]
            <= torch.tensor([min(x, s_eff - 1) for x in DENSE_POS], device=dev)[:, None])
    mask = mask[:, None, None, :]
    kvs = lambda t, i: t[i, :, :s_eff].reshape(b, s_eff, hkv, hd).transpose(1, 2)
    qs4 = q.to(dt)[:, :, None, :]
    lib = time_ms(torch, lambda i: sdpa(qs4, kvs(k3, i), kvs(v3, i), attn_mask=mask,
                                        scale=scale, enable_gqa=True), nl)
    run = lambda i: A.flash_decode_write_stacked(q, k3, v3, kn, vn, i, p, scale, hkv,
                                                 s_limit=s_eff)
    ms = time_ms(torch, run, nl)
    plain = plain_time_ms(torch, lambda i: A.flash_decode_write_plain(
        q, k3, v3, kn, vn, i, p, scale, hkv, s_eff), nl)
    entry("flash_decode_write", "llamafile_tpu_torch/csrc/flash_decode_write.cu",
          "llamafile_tpu/ops/attention.py:217", shape + " (the dense row mode's step; "
          "library: sdpa with a key mask a row)", err, ms, plain, lib,
          sum(seen) * 2 * row * k3.element_size()
          + b * (2 * row * k3.element_size() + (2 * hq * hd + 2 * row) * 4),
          4 * sum(seen) * hq * hd, KV_FLOATS[kv][2])
    if kv != "bf16":
        del k3, v3
        torch.cuda.empty_cache()
        return
    # flash_decode: the bf16 flat cache (flash_decode_stacked) and int8
    # codes with f32 scales, a layer's first s_limit positions in place
    p_fd = p.clone()
    for int8 in (False, True):
        if int8:
            del k3, v3
            kc, vc = (torch.randint(-127, 128, (nl, b, s_len, hkv, hd), generator=gen,
                                    device=dev, dtype=torch.int8) for _ in range(2))
            ksc, vsc = (torch.empty((nl, b, s_len, hkv), device=dev).uniform_(
                2e-3, 2e-2, generator=gen) for _ in range(2))
            sl = lambda a, i: a[i, :, :s_eff]
            fd = lambda i: A.flash_decode(q, sl(kc, i), sl(vc, i), p_fd, scale,
                                          k_scale=sl(ksc, i), v_scale=sl(vsc, i))
            fd_plain = lambda i: A.flash_decode_plain(q, sl(kc, i), sl(vc, i), p_fd, scale,
                                                      k_scale=sl(ksc, i), v_scale=sl(vsc, i))
            # the library yardstick's K/V dequantized beforehand (not timed)
            dq = lambda c, sc_: [(c[i, :, :s_eff].float() * sc_[i, :, :s_eff][..., None]
                                  ).transpose(1, 2) for i in range(nl)]
            kd, vd = dq(kc, ksc), dq(vc, vsc)
            lib_fn = lambda i: sdpa(q[:, :, None, :], kd[i], vd[i], attn_mask=mask_fd,
                                    scale=scale, enable_gqa=True)
            kv_bytes = sum(seen_fd) * 2 * hkv * (hd + 4)
            tol, label = DECODE_INT8_ROW_TOL, "int8 + f32 scales"
        else:
            kc, vc = k3, v3
            fd = lambda i: A.flash_decode_stacked(q, kc, vc, i, p_fd, scale, hkv, s_eff)
            fd_plain = lambda i: A.flash_decode_stacked_plain(q, kc, vc, i, p_fd, scale,
                                                              hkv, s_eff)
            lib_fn = lambda i: sdpa(qs4, kvs(kc, i), kvs(vc, i), attn_mask=mask_fd,
                                    scale=scale, enable_gqa=True)
            seen_fd = [min(x + 1, s_eff) for x in DENSE_POS]
            mask_fd = (torch.arange(s_eff, device=dev)[None, :]
                       <= p_fd.long()[:, None])[:, None, None, :]
            kv_bytes = sum(seen_fd) * 2 * row * 2
            tol, label = DECODE_BF16_ROW_TOL, "bf16 flat (flash_decode_stacked)"
        got, want = fd(5), fd_plain(5)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rerr = row_rel_err(got, want)
        log(f"  flash_decode/B=8 {label}: max_abs_err {err:.6g}; per row {rerr:.6g} of "
            f"the row's max (tol {tol})")
        if not rerr <= tol:
            raise AssertionError(f"flash_decode B=8 {label}: row error {rerr}")
        if not torch.equal(got, fd(5)):
            raise AssertionError(f"flash_decode B=8 {label}: two launches differ")
        ms = time_ms(torch, fd, nl)
        plain = plain_time_ms(torch, fd_plain, nl)
        lib = time_ms(torch, lib_fn, nl)
        entry("flash_decode", "llamafile_tpu_torch/csrc/flash_decode.cu",
              "llamafile_tpu/ops/attention.py:117", f"{shape} {label} ("
              + ("the dense row mode's int8 step; " if int8 else "")
              + "library: sdpa with a key mask a row"
              + (", K/V dequantized beforehand)" if int8 else ")"), err, ms, plain, lib,
              kv_bytes + b * (2 * hq * hd * 4 + 4), 4 * sum(seen_fd) * hq * hd,
              F32_FLOP_PER_S)
        del got, want
    del kc, vc, ksc, vsc, kd, vd
    torch.cuda.empty_cache()


# gemma2's decode options at Gemma-2-9B's decode shapes (16 query heads over
# 8 KV heads of head_dim 256, a cache of 8192 positions): the 4096 window of
# its even layers and the softcap of 50 at pos 700 (the window does not
# bite) and pos 6000 (it does)
GEMMA_HEADS = (16, 8, 256)
GEMMA_S = 8192
GEMMA_POS = (700, 6000)
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0


# gemma3's window at Gemma-3-27B's decode shapes (32 query heads over 16 KV
# heads of head_dim 128, a group of 2; window 1024, no softcap) over a cache
# of 4096 positions, at pos 700 (the window does not bite) and 3000 (it
# does): flash_decode_write alone, the kernel of its bf16 decode
GEMMA3_OPTIONS = dict(heads=(32, 16, 128), s_len=4096, positions=(700, 3000), win=1024,
                      cap=0.0, decode=False)


def gemma_option_cases(torch, dev, gen, nl=8, heads=GEMMA_HEADS, s_len=GEMMA_S,
                       positions=GEMMA_POS, win=GEMMA_WINDOW, cap=GEMMA_SOFTCAP,
                       decode=True):
    """A gemma model's decode options at `heads` (query heads, KV heads,
    head dim) over nl layers of an s_len cache (the replays spill the L2),
    at each of `positions`: flash_decode_write with the window and the
    softcap, then (decode) flash_decode (bf16 flat, then int8 with f32
    scales) with the softcap, and with the softcap and the window. The
    defaults are gemma2's at Gemma-2-9B's shapes (cap 0: no softcap;
    decode False: flash_decode_write alone). Yields (kernel, label,
    run(i, opts), plain(i, opts), tol, error fn, (bytes, ops, op rate),
    library(i) or None) a case: run(i, True) is the call on layer i with its
    options, run(i, False) the same call without any, plain the plain
    version of each, library one sdpa call with a boolean window mask over
    the rows 0..pos where the case has a window and no softcap (no single
    library call caps the scores); the bound counts the rows visible (those and
    the new token for flash_decode_write), each read once. q is scaled so
    that the scores reach tens, as Gemma-2's do, where the softcap of 50
    bends them."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import rel_err, row_rel_err
    hq, hkv, hd = heads
    scale = hd ** -0.5
    q = torch.randn((1, hq, hd), generator=gen, device=dev) * 4
    k3, v3 = (torch.randn((nl, 1, s_len, hkv * hd), generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
    kn, vn = (torch.randn((1, hkv, hd), generator=gen, device=dev) for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qb = q.to(torch.bfloat16)[:, :, None]                             # [1, Hq, 1, D]
    for pos in positions:
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        rows = min(pos - 1, win - 1) + 1                 # the cache rows and the new token
        lib = None
        if not cap:
            mask = (torch.arange(pos + 1, device=dev) > pos - win)[None, None, None]
            kv = lambda t, i, pos=pos: t[i, :, :pos + 1].reshape(
                1, pos + 1, hkv, hd).transpose(1, 2)
            lib = lambda i, mask=mask, kv=kv: sdpa(qb, kv(k3, i), kv(v3, i), attn_mask=mask,
                                                   scale=scale, enable_gqa=True)
        yield ("flash_decode_write", f"pos={pos} s_eff={s_len} window={win}"
               + (f" softcap={cap}" if cap else ""),
               lambda i, o, p=p: A.flash_decode_write_stacked(
                   q, k3, v3, kn, vn, i, p, scale, hkv, win_l=win if o else None,
                   softcap=cap if o else 0.0),
               lambda i, o, p=p: A.flash_decode_write_plain(
                   q, k3.clone(), v3.clone(), kn, vn, i, p, scale, hkv, s_len,
                   win if o else None, cap if o else 0.0),
               2e-2, rel_err, (rows * hkv * hd * 4 + (2 * hq * hd + 2 * hkv * hd) * 4,
                               4 * rows * hq * hd, BF16_FLOP_PER_S), lib)
    if not decode:
        return
    kc8, vc8 = (torch.randint(-127, 128, (nl, 1, s_len, hkv, hd), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
    ks8, vs8 = (torch.empty((nl, 1, s_len, hkv), device=dev).uniform_(2e-3, 2e-2,
                                                                      generator=gen)
                for _ in range(2))
    for int8 in (False, True):
        for pos in positions:
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            for w in (0, win):
                if int8:
                    run = lambda i, o, p=p, w=w: A.flash_decode(
                        q, kc8[i], vc8[i], p, scale, w if o else 0, cap if o else 0.0,
                        k_scale=ks8[i], v_scale=vs8[i])
                    plain = lambda i, o, p=p, w=w: A.flash_decode_plain(
                        q, kc8[i], vc8[i], p, scale, w if o else 0, cap if o else 0.0,
                        k_scale=ks8[i], v_scale=vs8[i])
                else:
                    run = lambda i, o, p=p, w=w: A.flash_decode_stacked(
                        q, k3, v3, i, p, scale, hkv, win_l=(w or None) if o else None,
                        softcap=cap if o else 0.0)
                    plain = lambda i, o, p=p, w=w: A.flash_decode_stacked_plain(
                        q, k3, v3, i, p, scale, hkv, s_len, (w or None) if o else None,
                        cap if o else 0.0)
                rows = min(pos + 1, w) if w else pos + 1
                per_row = 1 + 4 / hd if int8 else 2
                yield ("flash_decode", f"{'int8 + f32 scales' if int8 else 'bf16 flat'} "
                       f"pos={pos} s_eff={s_len}" + (f" softcap={cap}" if cap else "")
                       + (f" window={w}" if w else ""),
                       run, plain, DECODE_INT8_ROW_TOL if int8 else DECODE_BF16_ROW_TOL,
                       row_rel_err, (rows * hkv * hd * 2 * per_row + 2 * hq * hd * 4 + 4,
                                     4 * rows * hq * hd,
                                     F32_FLOP_PER_S if int8 else BF16_FLOP_PER_S), None)


def gemma_option_phase(torch, dev, gen, entry, model="Gemma-2-9B", **spec):
    """Phase 2 for the window and softcap options of flash_decode_write and
    flash_decode (gemma_option_cases, at `model`'s shapes and options in
    spec): each against its plain version on
    the same inputs, two launches bitwise equal (the rows written with the
    options are held by tests/test_torch_cuda.py), timed beside its plain
    version and the same call without
    the options. The bound is the bytes of the rows visible over the memory
    rate; the library time is sdpa's with a boolean window mask where the
    case has a window alone, none under a softcap (no single library call
    caps the scores)."""
    hq, hkv, hd = spec.get("heads", GEMMA_HEADS)
    nl = 8
    for kernel, label, run, plain, tol, err_fn, work, lib in gemma_option_cases(
            torch, dev, gen, nl, **spec):
        name = f"{kernel}/{model} Hq={hq} Hkv={hkv} D={hd} {label}"
        got = run(5, True)
        torch.cuda.synchronize()
        err = err_fn(got, plain(5, True))
        log(f"  {name}: error {err:.6g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel and plain version disagree: {err}")
        if not torch.equal(run(5, True), got):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        log(f"  {name}: two launches bitwise equal")
        ms = time_ms(torch, lambda i: run(i, True), nl)
        bare = time_ms(torch, lambda i: run(i, False), nl)
        plain_ms = plain_time_ms(torch, lambda i: plain(i, True), nl)
        lib_ms = None if lib is None else time_ms(torch, lib, nl)
        log(f"  {name}: kernel {ms:.4f} ms, the same call without the options {bare:.4f} ms")
        entry(kernel, f"llamafile_tpu_torch/csrc/{kernel}.cu",
              "llamafile_tpu/ops/attention.py:" + ("217" if kernel == "flash_decode_write"
                                                   else "117"),
              f"B=1 Hq={hq} Hkv={hkv} D={hd} {label} ({model}; without the options "
              f"{bare:.4f} ms)", err, ms, plain_ms, lib_ms, *work)
    torch.cuda.empty_cache()


def paged_phase(torch, dev, gen, entry, sdpa, hq, label, lengths, int8, hkv=8, hd=128,
                kv="bf16"):
    """Phase 2 for paged_attention at hq query heads over hkv KV heads of
    head dim hd, a row
    for each of `lengths` over a pool of 32 layers (so the replays over layers spill
    the L2 as the fused step does), tables shuffled over the pool's pages:
    row by row against its plain version, the controls (one masked key made
    visible, each row's last page dropped) outside the tolerance, timed
    beside its plain version and sdpa."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import paged_case, paged_controls, row_rel_err
    nl, r, ps, maxp = 32, len(lengths), 64, 2048 // 64
    label = label + ("" if hq // hkv <= 8 else f", {group_note(hq, hkv, A.PA_CHUNK_HEADS)}")
    q, kp, vp, ks, vs, lens, tables = paged_case(
        gen, lengths, hq, hkv, hd, ps, maxp, n_layers=nl, int8=int8, device=dev,
        dtype=KV_FLOATS[kv][0](torch))
    sc = (lambda t, i: None) if ks is None else (lambda t, i: t[i])
    lay = lambda i: (q, kp[i], vp[i], lens, tables, sc(ks, i), sc(vs, i))
    got = A.paged_attention(*lay(5))
    want = A.paged_attention_plain(*lay(5))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row = row_rel_err(got, want)
    ctl = [row_rel_err(c, want) for c in paged_controls(
        q, kp[5], vp[5], sc(ks, 5), sc(vs, 5), lens, tables, ps)]
    log(f"  paged_attention/{label}: max_abs_err {err:.6g}; per (row, head) "
        f"{row:.6g} of its max (tol {PAGED_ROW_TOL}); controls (one masked key "
        f"visible, last page dropped) {ctl[0]:.6g}, {ctl[1]:.6g}")
    if not row <= PAGED_ROW_TOL < min(ctl):
        raise AssertionError(f"paged_attention {label}: row error {row}, "
                             f"controls {ctl}")
    if not torch.equal(got, A.paged_attention(*lay(5))):
        raise AssertionError("paged_attention: two runs on the same inputs differ")
    ms = time_ms(torch, lambda i: A.paged_attention(*lay(i)), nl)
    plain = plain_time_ms(torch, lambda i: A.paged_attention_plain(*lay(i)), nl)
    lib_fn = paged_yardstick(torch, q, kp, vp, ks, vs, lens, tables, nl)
    lib = time_ms(torch, lib_fn, nl)
    check_close(f"paged_attention/{label} vs sdpa (yardstick sanity)",
                got.reshape(r, hkv, hq // hkv, hd), lib_fn(5), 2e-2)
    entry("paged_attention", "llamafile_tpu_torch/csrc/paged_attention.cu",
          "llamafile_tpu/runtime/paged.py:277",
          f"R={r} Hq={hq} Hkv={hkv} D={hd} ps={ps} {label} (library: sdpa on "
          "K/V gathered beforehand, gather not timed)", err, ms, plain, lib,
          *paged_work(lengths, hq, hkv, hd, int8, kp.element_size()))
    del q, kp, vp, ks, vs, lib_fn, got, want
    torch.cuda.empty_cache()


def i8p_kernel_phase(torch, dev, gen, entry):
    """Phase 2 for the int8 prefill GEMM: llama3-8b's four products at M =
    1024 (a 1000-token prompt's bucket), gate|up at a ragged M = 300 (a
    300-row admission slice), then the four at M = 512 and 128 (the buckets
    of 257-512 and 33-128 tokens), each on layer 1 of a stack (the stacked
    form, row 16, by pointer), bitwise equal to its plain version, with a
    control (two blocks' weight scales swapped) that must fail I8P_TOL.
    Timed beside it: the plain version, the library yardstick torch._int_mm
    on the same codes without the per-block scales (which the port never
    calls), and qmm_dequant, the prefill GEMM without companions, at the
    same shape; at gate|up M = 1024 also the kernel on unrolled layers (one
    allocation each, row 15)."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import i8p_fault, rand_i8p, rand_q4b, rel_err
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, n, k, layers, ms_ in (("gate_up", 28672, 4096, 2, (1024, 300, 512, 128)),
                                     ("down", 4096, 14336, 3, (1024, 512, 128)),
                                     ("qkv", 6144, 4096, 8, (1024, 512, 128)),
                                     ("o", 4096, 4096, 12, (1024, 512, 128))):
        w8, sw = rand_i8p(gen, layers, n, k, dev)
        qs, sc, _ = rand_q4b(gen, layers, n, k, dev)
        for m in ms_:
            xq, sxa = Q.i8p_prep(torch.randn((m, k), generator=gen, device=dev))
            got = Q.qmm_i8p(xq, sxa, w8[1], sw[1])
            want = Q.qmm_i8p_plain(xq, sxa, w8[1], sw[1])
            torch.cuda.synchronize()
            bn = Q.i8p_tile_n(m, n, sms)
            what = f"qmm_i8p/{label}/M={m} (layer 1 of {layers}, n tile {bn})"
            err = check_close(what, got, want, I8P_TOL)
            ctl = rel_err(i8p_fault(xq, sxa, w8[1], sw[1]), want)
            same = torch.equal(got, want)
            log(f"  {what}: swapped-block-scales control {ctl:.6g} (must exceed {I8P_TOL}); "
                f"bitwise equal to the plain version: {same}")
            if not same:
                raise AssertionError(f"qmm_i8p {label} M={m}: not bitwise equal to the plain "
                                     "version")
            if not ctl > I8P_TOL:
                raise AssertionError(f"qmm_i8p {label}: the faulty control passes")
            del got, want
            ms = time_ms(torch, lambda i: Q.qmm_i8p(xq, sxa, w8[i], sw[i]), layers)
            plain = plain_time_ms(torch, lambda i: Q.qmm_i8p_plain(xq, sxa, w8[i], sw[i]), layers)
            wt = [w8[i].t() for i in range(layers)]             # [K, N] views
            lib = time_ms(torch, lambda i: torch._int_mm(xq, wt[i]), layers)
            del wt
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            dq = time_ms(torch, lambda i: Q.qmm_dequant(xb, qs[i], sc[i]), layers)
            del xb
            log(f"  qmm_i8p/{label}/M={m}: qmm_dequant at the same shape {dq:.4f} ms "
                f"({dq / ms:.2f}x the int8 kernel's time)")
            nbytes = (n * k + (k // 256) * n * 4 + m * k + m * (k // 256) * 4 + 4 * m * n)
            if label == "gate_up" and m == 1024:
                # row 15: the same kernel on unrolled layers, one allocation each
                wu = [(w8[i].clone(), sw[i].clone()) for i in range(layers)]
                got_u = Q.qmm_i8p(xq, sxa, *wu[1])
                want_u = Q.qmm_i8p_plain(xq, sxa, *wu[1])
                torch.cuda.synchronize()
                err_u = check_close(f"qmm_i8p/{label}/M={m} (unrolled layer 1)", got_u,
                                    want_u, I8P_TOL)
                if not torch.equal(got_u, want_u):
                    raise AssertionError(f"qmm_i8p {label} M={m} unrolled: not bitwise equal "
                                         "to the plain version")
                log(f"  qmm_i8p/{label}/M={m} (unrolled layer 1): bitwise equal to the plain "
                    "version")
                del got_u, want_u
                un = time_ms(torch, lambda i: Q.qmm_i8p(xq, sxa, *wu[i]), layers)
                del wu
                entry("qmm_i8p", "llamafile_tpu_torch/csrc/qmm_i8p.cu",
                      "llamafile_tpu/ops/qmatmul.py:1808",
                      f"{label} M={m} N={n} K={k}, unrolled layers (n tile {bn}; library: "
                      f"torch._int_mm without the per-block scales; qmm_dequant {dq:.4f} ms)",
                      err_u, un, plain, lib, nbytes, 2 * m * n * k)
            entry("qmm_i8p", "llamafile_tpu_torch/csrc/qmm_i8p.cu",
                  "llamafile_tpu/ops/qmatmul.py:1904",
                  f"{label} M={m} N={n} K={k}, layer i of a stack of {layers} (n tile {bn}; "
                  f"library: torch._int_mm without the per-block scales; qmm_dequant "
                  f"{dq:.4f} ms)", err, ms, plain, lib, nbytes, 2 * m * n * k)
            del xq, sxa
        del w8, sw, qs, sc
        torch.cuda.empty_cache()


def int8_kernel_phase(torch, dev, gen, entry, dequant_bf16):
    """Phase 2 for the int8 flavour's q4b product: qmm_int8
    (rows 13-14) at M = 8 (a decode step, padded as qmatmul pads it) on layer
    i > 0 of a stack: gate|up, down, qkv, o, and the unstacked lm head; then
    gate|up and down at M = 32 (a 24-token prompt's bucket). Each against
    its plain version within 1e-5, a second launch bitwise equal, with a
    control (each superblock's lo and hi scale rows swapped) that must fail
    it, and timed beside its plain
    version, qmm_txn's library yardstick (torch.matmul on the weight
    dequantized to bf16 beforehand) and qmm_txn at the same shape; the
    bound is qs + scales + the activation codes and scales + y (the kernel
    reads no bias). Row 12, the planes kernel on a stacked layer, is
    measured with qmm_planes in kernel_phases."""
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import q4b_scale_swap, rand_q4b, rel_err
    for m, label, n, k, layers in ((8, "gate_up", 28672, 4096, 2),
                                   (8, "down", 4096, 14336, 3),
                                   (8, "qkv", 6144, 4096, 8),
                                   (8, "o", 4096, 4096, 12),
                                   (8, "lm_head", 129024, 4096, 1),
                                   (32, "gate_up", 28672, 4096, 2),
                                   (32, "down", 4096, 14336, 3)):
        qs, sc, b = rand_q4b(gen, layers, n, k, dev)
        li = layers - 1
        x = torch.randn((m, k), generator=gen, device=dev)
        xq, sx = Q.quantize_activations_g32(x)
        got = Q.qmm_int8(xq, sx, qs[li], sc[li])
        want = Q.qmm_int8_plain(xq, sx, qs[li], sc[li])
        torch.cuda.synchronize()
        where = f"layer {li} of {layers}" if layers > 1 else "unstacked"
        what = f"qmm_int8/{label}/M={m} ({where})"
        err = check_close(what, got, want, 1e-5)
        check_repeat(what, Q.qmm_int8(xq, sx, qs[li], sc[li]), got)
        ctl = rel_err(q4b_scale_swap(xq, sx, qs[li], sc[li]), want)
        log(f"  {what}: swapped-scale-rows control {ctl:.6g} (must exceed 1e-5)")
        if not ctl > 1e-5:
            raise AssertionError(f"qmm_int8 {label}: the faulty control passes")
        del got, want
        ms = time_ms(torch, lambda i: Q.qmm_int8(xq, sx, qs[i], sc[i]), layers)
        plain = plain_time_ms(torch, lambda i: Q.qmm_int8_plain(xq, sx, qs[i], sc[i]), layers)
        txn = time_ms(torch, lambda i: Q.qmm_txn(xq, sx, qs[i], sc[i], b[i]), layers)
        w = dequant_bf16(qs, sc, b)
        xb = x.to(torch.bfloat16)
        lib = time_ms(torch, lambda i: torch.matmul(xb, w[i]), layers)
        del w
        log(f"  {what}: qmm_txn at the same shape {txn:.4f} ms ({txn / ms:.2f}x the int8 "
            "kernel's time)")
        entry("qmm_int8", "llamafile_tpu_torch/csrc/qmm_int8.cu",
              "llamafile_tpu/ops/qmatmul.py:224",
              f"{label} M={m} N={n} K={k}, {where} (qmm_txn {txn:.4f} ms)", err, ms, plain,
              lib, qs[0].numel() + sc[0].numel() * 2 + m * (k + k // 8) + 4 * m * n,
              2 * m * n * k)
        del qs, sc, b
        torch.cuda.empty_cache()


MOE_E, MOE_D, MOE_DFF = 8, 4096, 14336      # Mixtral-8x7B: top-2 of 8 experts
SWAP_CONTROL_MIN = 0.1     # a control with expert ids swapped must part this far


def swap_control(name, bad, want):
    from llamafile_tpu_torch.testing import rel_err
    ctl = rel_err(bad, want)
    log(f"  {name}: swapped-expert-ids control {ctl:.6g} (must exceed {SWAP_CONTROL_MIN})")
    if not ctl > SWAP_CONTROL_MIN:
        raise AssertionError(f"{name}: the control with swapped expert ids passes")


def moe_slots(torch, n_tok, seed):
    """Top-2 expert ids of n_tok tokens, distinct within a token: int64 [2 n_tok]."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(MOE_E, generator=g)[:2]
                        for _ in range(n_tok)]).reshape(-1)


def moe_kernel_phases(torch, dev, gen, entry, dequant_bf16):
    """Phase 2 for the MoE kernels at Mixtral-8x7B width (d 4096, d_ff 14336,
    8 experts): the routed fused FFN and the routed GEMVs at a decode step's
    2 slots, the grouped products at 8 serving rows (16 slots, tm 8), a
    256-token prompt (512 slots, tm 32) and a 1024-token prompt (2048 slots,
    tm 128), each against its plain version, with a control whose expert ids
    are swapped. Library: torch.bmm on the routed (or each tile's) experts
    dequantized to bf16 beforehand; none for the fused FFN."""
    from llamafile_tpu_torch.models.llama import group_layout
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rand_q4b, rand_q8b
    E, d, dff = MOE_E, MOE_D, MOE_DFF
    gq, gs, gb = rand_q4b(gen, E, 2 * dff, d, dev)      # gate|up stacks (interleaved width)
    dq, ds, db = rand_q4b(gen, E, d, dff, dev)
    d8, d8s, _ = rand_q8b(gen, E, d, dff, 16, dev)      # Q4_K_M's Q6_K down stacks
    gu_e, dn_e = q4b_bytes(gq, gs, gb), q4b_bytes(dq, ds, db)
    d8_e = d8[0].numel() + d8s[0].numel() * 2
    pairs = [torch.tensor(p, dtype=torch.int32, device=dev) for p in ((0, 1), (2, 3), (4, 5),
                                                                     (6, 7))]
    ti = torch.zeros(2, dtype=torch.int32, device=dev)
    x1 = torch.randn((1, d), generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x1, 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
                                        1e-5)

    # --- qmm_moe_m1, routed: one launch pair for the decode step's 2 slots
    topw = torch.tensor([0.6, 0.4], device=dev)
    margs = lambda ei: (xq, sx, gq, gs, gb, dq, ds, db, ei, ti, topw)
    got, want = Q.qmm_moe_m1(*margs(pairs[0])), Q.qmm_moe_m1_plain(*margs(pairs[0]))
    torch.cuda.synchronize()
    err = check_close("qmm_moe_m1/routed S=2", got, want, 2e-3)
    check_repeat("qmm_moe_m1/routed S=2", Q.qmm_moe_m1(*margs(pairs[0])), got)
    swap_control("qmm_moe_m1/routed S=2", Q.qmm_moe_m1_plain(*margs(pairs[0].flip(0))), want)
    ms = time_ms(torch, lambda i: Q.qmm_moe_m1(*margs(pairs[i])), 4)
    plain = plain_time_ms(torch, lambda i: Q.qmm_moe_m1_plain(*margs(pairs[i])), 4)
    entry("qmm_moe_m1", "llamafile_tpu_torch/csrc/qmm_moe_m1.cu",
          "llamafile_tpu/ops/qmatmul.py:1037",
          f"routed ffn S=2 of E={E} d={d} d_ff={dff} (2 distinct experts)", err, ms, plain,
          None, 2 * (gu_e + dn_e) + d + d // 8 + 4 * 2 * d, 2 * 2 * (2 * dff * d + d * dff))

    # --- the routed GEMVs: gate|up and down of a decode step's 2 slots ----
    def dq_all(qs, sc, b):
        return torch.stack([dequant_bf16(qs[e:e + 1], sc[e:e + 1], b[e:e + 1])[0]
                            if b is not None else Q.dequant_bf16(qs[e], sc[e])
                            for e in range(E)])
    for name, label, (qs, sc, b), k, ebytes in (
            ("qmm_txn_m1_r", "gate_up", (gq, gs, gb), d, gu_e),
            ("qmm_txn_m1_r", "down", (dq, ds, db), dff, dn_e),
            ("qmm_q8_m1_r", "down Q6_K", (d8, d8s, None), dff, d8_e)):
        fn, plain_fn = getattr(Q, name), getattr(Q, name + "_plain")
        n = qs.shape[-1]
        x = torch.randn((1, k), generator=gen, device=dev)
        rq, rs = Q.quantize_activations_g32(x)
        got, want = fn(rq, rs, qs, sc, b, pairs[0], ti), plain_fn(rq, rs, qs, sc, b, pairs[0], ti)
        torch.cuda.synchronize()
        err = check_close(f"{name}/{label} S=2", got, want, 1e-5)
        check_repeat(f"{name}/{label} S=2", fn(rq, rs, qs, sc, b, pairs[0], ti), got)
        swap_control(f"{name}/{label} S=2", plain_fn(rq, rs, qs, sc, b, pairs[0].flip(0), ti),
                     want)
        ms = time_ms(torch, lambda i: fn(rq, rs, qs, sc, b, pairs[i], ti), 4)
        plain = plain_time_ms(torch, lambda i: plain_fn(rq, rs, qs, sc, b, pairs[i], ti), 4)
        w_all = dq_all(qs, sc, b)
        w2 = [w_all.index_select(0, pr) for pr in pairs]
        xb = x.to(torch.bfloat16).expand(2, 1, k).contiguous()
        lib = time_ms(torch, lambda i: torch.bmm(xb, w2[i]), 4)
        del w_all, w2
        entry(name, "llamafile_tpu_torch/csrc/qmm_routed.cu",
              "llamafile_tpu/ops/qmatmul.py:" + ("867" if name == "qmm_txn_m1_r" else "948"),
              f"{label} S=2 of E={E} N={n} K={k} (library: bmm on the 2 experts "
              "dequantized beforehand)", err, ms, plain, lib,
              2 * ebytes + k + k // 8 + 4 * 2 * n, 2 * 2 * n * k)
        torch.cuda.empty_cache()

    # --- the grouped products: serving at 8 rows, prompts of 256 and 1024 --
    for name, n_tok, tm in (("qmm_txn_g", 8, 8), ("qmm_txn_g", 256, 32),
                            ("qmm_planes_g", 1024, 128)):
        gid = moe_slots(torch, n_tok, n_tok).to(dev)
        order, pos, te, n_tiles = group_layout(gid, E, tm)
        te = te.to(torch.int32)
        n_exp = int(te.unique().numel())
        swapped = te.clone()
        j = int((te != te[0]).nonzero()[0, 0])          # the first tile of another expert
        swapped[0], swapped[j] = te[j], te[0]
        for label, (qs, sc, b), k, ebytes in (("gate_up", (gq, gs, gb), d, gu_e),
                                             ("down", (dq, ds, db), dff, dn_e)):
            n = qs.shape[-1]
            x = torch.zeros((n_tiles * tm, k), device=dev).index_copy_(
                0, pos, torch.randn((gid.shape[0], k), generator=gen, device=dev))
            if name == "qmm_txn_g":
                rq, rs = Q.quantize_activations_g32(x)
                run = lambda t: Q.qmm_txn_g(rq, rs, qs, sc, b, t, tm)
                plain_fn = lambda t: Q.qmm_txn_g_plain(rq, rs, qs, sc, b, t, tm)
                tol, rate, out_b = 1e-5, INT8_OPS_PER_S, 4
            else:
                run = lambda t: Q.qmm_planes_g(x, qs, sc, b, t)
                plain_fn = lambda t: Q.qmm_planes_g_plain(x, qs, sc, b, t)
                tol, rate, out_b = PLANES_BF16_TOL, BF16_FLOP_PER_S, 2
            got, want = run(te), plain_fn(te)
            torch.cuda.synchronize()
            what = f"{name}/{label} S={gid.shape[0]} tm={tm} ({n_tiles} tiles)"
            err = check_close(what, got, want, tol)
            if name == "qmm_txn_g":
                check_repeat(what, run(te), got)
            swap_control(what, plain_fn(swapped), want)
            del got, want
            ms = time_ms(torch, lambda i: run(te), 1)
            plain = plain_time_ms(torch, lambda i: plain_fn(te), 1)
            wt = dq_all(qs, sc, b).index_select(0, te.long())      # each tile's expert
            xt = x.to(torch.bfloat16).reshape(n_tiles, tm, k)
            lib = time_ms(torch, lambda i: torch.bmm(xt, wt), 1)
            del wt, xt
            entry(name, f"llamafile_tpu_torch/csrc/{name}.cu",
                  "llamafile_tpu/ops/qmatmul.py:" + ("1373" if name == "qmm_txn_g" else "1432"),
                  f"{label} S={gid.shape[0]} tm={tm} {n_tiles} tiles of {n_exp} experts "
                  f"N={n} K={k} (library: bmm on each tile's expert dequantized beforehand)",
                  err, ms, plain, lib,
                  n_exp * ebytes + n_tiles * tm * (k + k // 8 if tm <= 32 else 2 * k)
                  + out_b * n_tiles * tm * n, 2 * n_tiles * tm * n * k, rate)
            torch.cuda.empty_cache()
    del gq, gs, gb, dq, ds, db, d8, d8s
    torch.cuda.empty_cache()


def _to(params, dev):
    """A copy of params on dev, stacked (one LlamaLayer) or unrolled (a list)."""
    import dataclasses
    from llamafile_tpu_torch.models.llama import LlamaParams
    mv = lambda v: (None if v is None else {k: q.to(dev) for k, q in v.items()}
                    if isinstance(v, dict) else v.to(dev))
    layer_to = lambda l: dataclasses.replace(l, **{
        f.name: mv(getattr(l, f.name)) for f in dataclasses.fields(l)})
    layers = ([layer_to(l) for l in params.layers] if isinstance(params.layers, list)
              else layer_to(params.layers))
    return LlamaParams(params.tok_embd.to(dev), layers, params.out_norm.to(dev),
                       params.output.to(dev))


@contextlib.contextmanager
def op_trace(rec):
    """While open, every product (qmatmul, qmatmul_moe and the MoE's routed
    and grouped products), activation
    quantization (its int8 codes) and attention call of the forward appends
    (label, output on the CPU, inputs) to the list rec[-1], in call order.
    Inputs are kept for the prefill, int8-cache decode and paged attention
    (on the CPU: the positional arguments, then a dict of the keyword ones)
    and for the products (x on the CPU, the other arguments as they are), so
    that each can be rerun on the other side's inputs; an int8 prefill
    product is kept twice, as qmatmul's call and as qmm_i8p's (its codes
    and scales). An activation quantization keeps its codes and scales as
    its inputs entry, for the rerun of the product it feeds. Nothing inside the
    fused FFN is kept: its plain version quantizes its hidden activations
    in torch, the kernel inside itself."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.runtime import paged as PG
    saved, inside = [], [0]

    def wrap(mod, name, label, opaque=False, keep_inputs=False):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def traced(*a, **kw):
            inside[0] += opaque
            try:
                out = fn(*a, **kw)
            finally:
                inside[0] -= opaque
            if not inside[0]:
                cpu = lambda t: t.cpu() if hasattr(t, "cpu") else t
                ins = ({"x": a[0].cpu(), "args": a[1:], "kw": kw} if keep_inputs == "call"
                       else tuple(t.cpu() for t in out) if keep_inputs == "out"
                       else [cpu(t) for t in a] + [{k: cpu(t) for k, t in kw.items()}]
                       if keep_inputs else None)
                rec[-1].append((label(*a, **kw), (out[0] if isinstance(out, tuple) else out).cpu(),
                                ins))
            return out
        if hasattr(fn, "launches"):
            # a kernel wrapper counts itself under its module name, which is
            # now `traced`: the count lives here until it is restored
            traced.launches = fn.launches
        setattr(mod, name, traced)
    wrap(LM, "qmatmul", lambda x, qt, li=None, *_, **_kw: f"product N={qt.shape[0]}"
         + ("" if li is None else f" layer {li}"), keep_inputs="call")
    wrap(LM, "qmatmul_moe", lambda x, gu, dn, ids, *_, **kw: f"fused ffn S={ids.shape[0]}",
         True, keep_inputs="call")
    wrap(LM, "qmatmul_routed", lambda x, qt, ids, *_, **kw:
         f"routed product N={qt.shape[0]} S={ids.shape[0]}", keep_inputs="call")
    wrap(LM, "qmatmul_grouped", lambda x, qt, te, *_, **kw:
         f"grouped product N={qt.shape[0]} rows={x.shape[0]} tm={kw['tm']}", keep_inputs="call")
    wrap(Q, "quantize_activations_g32",
         lambda x, *_, **_kw: f"codes M={x.shape[0]} K={x.shape[1]}", keep_inputs="out")
    wrap(Q, "i8p_prep", lambda x, *_, **_kw: f"i8p codes M={x.shape[0]} K={x.shape[1]}")
    wrap(Q, "qmm_i8p", lambda xq, sxa, w8, sw: f"i8p product M={xq.shape[0]} N={w8.shape[0]}",
         keep_inputs="call")
    wrap(LM, "flash_prefill", lambda *_, **_kw: "prefill attention", keep_inputs=True)
    wrap(LM, "flash_decode_write_stacked", lambda *a, **_kw: f"L{a[5]} decode attention")
    wrap(LM, "flash_decode", lambda *a, **kw: "int8 decode attention", keep_inputs=True)
    wrap(PG, "paged_attend", lambda *a, **kw: "paged attention", keep_inputs=True)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            if hasattr(fn, "launches"):
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)


def trace_report(steps_card, steps_cpu):
    """One line a forward call: where card and CPU first part, and how far.
    A quantization's int8 codes are compared code by code; every other
    output by max |diff| / max |CPU value|. Every product of the card is
    also rerun through its plain version on the card (plain_rerun,
    grouped_plain), on the card's own input (its activation codes and
    scales too, where the product made them) and weights, where phase 2
    holds the same comparison. Returns (lines, {route: the
    largest parting of a product from its plain version on the same
    inputs}) for the int8-activation GEMVs, qmm_txn and qmm_int8 ("int8"),
    the dequant GEMM and _routed_fallback ("dequant"), the two-plane GEMM
    ("planes"), the fused FFN ("ffn") and the int8 prefill ("i8p", held on
    the card's own int8 codes and scales: an activation code can flip
    between the two sides' RMSNorms): a fault in a product kernel shows
    there, whatever parted before it."""
    import torch
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.testing import rel_err
    lines, same = [], {"int8": 0.0, "dequant": 0.0, "planes": 0.0, "ffn": 0.0,
                       "planes_g": 0.0, "i8p": 0.0}
    for i, (card, cpu) in enumerate(zip(steps_card, steps_cpu)):
        n_q = flips = q_flipped = 0
        first, worst = None, (0.0, "")
        for j, ((lab, a, ia), (lab_b, b, ib)) in enumerate(zip(card, cpu)):
            assert lab == lab_b, (lab, lab_b)
            if isinstance(ia, dict) and lab.startswith("i8p product"):
                # the card's codes, scales and weights, on the card
                dev = ia["args"][0].device
                same["i8p"] = max(same["i8p"], rel_err(a, Q.qmm_i8p_plain(
                    ia["x"].to(dev), *ia["args"]).cpu()))
            elif isinstance(ia, dict):           # a product: rerun plain on the card's x
                fn = (LM.qmatmul_moe if "fused ffn" in lab else LM.qmatmul_routed
                      if lab.startswith("routed") else LM.qmatmul_grouped
                      if lab.startswith("grouped") else LM.qmatmul)
                # the weights from the CPU's copy; expert ids, rows and routing
                # weights (tensors) from the card's call, as it routed
                pick = lambda c, h: c.cpu() if isinstance(c, torch.Tensor) else h
                args = [pick(c, h) for c, h in zip(ia["args"], ib["args"])]
                kw = {k: pick(ia["kw"][k], v) for k, v in ib["kw"].items()}
                # the product's own activation codes and scales, where it made
                # them (the call just before it): the host's RMSNorm and
                # rsqrt part from the card's by an ulp of a scale
                codes = card[j - 1][2] if j and card[j - 1][0].startswith("codes") else None
                # where the card's inputs equal the CPU's bit for bit, the
                # CPU's output is the plain version on them
                # (the other side's tensors may lie on the card: plain_kernels)
                same_in = torch.equal(ia["x"], ib["x"]) and all(
                    torch.equal(c, h.cpu()) for c, h in zip(args + list(kw.values()),
                                                            ib["args"] + tuple(ib["kw"].values()))
                    if isinstance(h, torch.Tensor)) and (codes is None or all(
                        torch.equal(c, h) for c, h in zip(codes, cpu[j - 1][2])))
                qt, m = ib["args"][0], ia["x"].shape[0]
                if "fused ffn" in lab:
                    route = "ffn"
                elif lab.startswith("routed"):     # the routed GEMVs, or _routed_fallback
                    route = ("int8" if qt.kind == "q8b" or (qt.kind == "q4b" and
                                                            Q.q4b_flavour() == "txn")
                             else "dequant")
                elif lab.startswith("grouped"):
                    route = "int8" if kw["tm"] <= 32 else "planes_g"
                else:                              # qmatmul's kernel under the flavour
                    li = ib["args"][1] if len(ib["args"]) > 1 else ib["kw"].get("li")
                    route = PRODUCT_CHECK.get(Q.product_route(qt, m, ia["x"].shape[1], li))
                if route:
                    want = (b if same_in else grouped_plain(Q, ia, codes)
                            if lab.startswith("grouped") else plain_rerun(Q, fn, ia, codes))
                    same[route] = max(same[route], rel_err(a, want))
            if not a.dtype.is_floating_point:
                n_q += 1
                nf = int((a != b).sum())
                if nf:
                    q_flipped += 1
                    flips += nf
                    step = int((a.int() - b.int()).abs().max())
                    if first is None:
                        first = f"call {j} {lab}: {nf} codes differ, by up to {step}"
                continue
            e = rel_err(a, b)
            worst = max(worst, (e, f"call {j} {lab}"))
            if first is None and e > 1e-4:
                first = f"call {j} {lab}: {e:.3g}"
        lines.append(f"step {i}: {len(card)} calls; codes differ in {q_flipped} of {n_q} "
                     f"quantizations ({flips} codes); first parting (codes, or > 1e-4): "
                     f"{first}; largest {worst[0]:.3g} at {worst[1]}")
    return lines, same


def plain_rerun(Q, fn, ia, codes):
    """The plain version of product call ia (fn: qmatmul, qmatmul_moe or
    qmatmul_routed) on the card, on the card's own x, activation codes and
    scales (codes, where it made them), weights and routing (plain_kernels);
    returned on the CPU. On the CPU these plain versions expand every
    weight to f32 a call: PR 15's cProfile put q4b_plain at 16.0 s of the
    32-token check's 20.4."""
    dev = ia["args"][0].qs.device
    x = ia["x"].to(dev)
    cc = None if codes is None else tuple(c.to(dev) for c in codes)
    with plain_kernels():
        return with_codes(Q, cc, lambda: fn(x, *ia["args"], **ia["kw"])).cpu()


@contextlib.contextmanager
def plain_kernels(products: bool = True):
    """While open, every kernel wrapper of the model path runs its plain
    version on whatever device its tensors lie (on the card too): the
    qmatmul kernels (unless products is False), and the decode and prefill
    attention kernels as models.llama calls them (their non-kernel routes
    unchanged). Nothing is launched and no launch is counted. The
    reference of phase 3's gemma checks, of every product's rerun
    (plain_rerun), and with products False of phase 15a's decode
    attention."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import qmatmul as Q
    orig_fdw, orig_fd, orig_fp = (LM.flash_decode_write_stacked, LM.flash_decode,
                                  LM.flash_prefill)

    def fdw(q, k3, v3, k_new, v_new, li, pos, scale, hkv, s_limit=None, win_l=None,
            softcap=0.0):
        s_len = k3.shape[2]
        s_eff = s_limit if s_limit is not None and s_limit < s_len else s_len
        if A.decode_route(q.shape[2], hq=q.shape[1], s_eff=s_eff) == "einsum":
            return orig_fdw(q, k3, v3, k_new, v_new, li, pos, scale, hkv, s_limit, win_l,
                            softcap)
        return A.flash_decode_write_plain(q, k3, v3, k_new, v_new, li, pos, scale, hkv,
                                          s_eff, win_l, softcap)

    def fd(q, k, v, pos, scale, window=0, softcap=0.0, k_scale=None, v_scale=None):
        if A.decode_route(q.shape[2], hq=q.shape[1], s_eff=k.shape[1]) == "einsum":
            return orig_fd(q, k, v, pos, scale, window, softcap, k_scale, v_scale)
        return A.flash_decode_plain(q, k, v, pos, scale, window, softcap, k_scale, v_scale)

    def fp(q, k, v, scale, window=None, softcap=0.0):
        if window is None and not softcap and A._use_flash(q.shape[1], q.shape[3]):
            return A.flash_prefill_plain(q, k, v, scale)
        return orig_fp(q, k, v, scale, window, softcap)
    patches = [(Q, n, getattr(Q, n + "_plain"))
               for n in ("qmm_txn_m1", "qmm_txn", "qmm_q8_m1", "qmm_dequant", "qmm_int8",
                         "qmm_moe_m1", "qmm_txn_m1_r", "qmm_q8_m1_r", "qmm_txn_g",
                         "qmm_planes_g", "qmm_i8p") if products]
    if products:
        patches.append((Q, "qmm_planes",
                        lambda x, qs, sc, stacked=False, bf16_out=None:
                        Q.qmm_planes_plain(x, qs, sc, bf16_out)))
    patches += [(LM, "flash_decode_write_stacked", fdw), (LM, "flash_decode", fd),
                (LM, "flash_prefill", fp)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, f in patches:
        setattr(mod, name, f)
    try:
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def grouped_plain(Q, ia, codes):
    """The plain version of a grouped product (qmatmul_grouped's call ia) on
    the card, on the card's own x, activation codes and scales (codes, for
    tm <= 32), weights and tile experts; returned on the CPU. On the CPU
    these plain versions dequantize an expert's weights once a tile, the
    most of phase 3's CPU time at Mixtral width."""
    import torch
    qt, te = ia["args"][0], ia["args"][1].to(torch.int32)
    tm, dev = ia["kw"]["tm"], qt.qs.device
    if tm <= 32:
        xq, sx = (c.to(dev) for c in codes)
        y = Q.qmm_txn_g_plain(xq, sx, qt.qs, qt.scales, qt.bias, te, tm)
    else:
        y = Q.qmm_planes_g_plain(ia["x"].to(dev), qt.qs, qt.scales, qt.bias, te, tm)
    n = qt.shape[0]
    return (y[:, :n] if y.shape[1] > n else y).cpu()


# the limit (SAME_INPUT_TOL) that holds each kernel of qmatmul on the same
# inputs; qmm_i8p is held on its own codes (same["i8p"]), a dense product
# has no kernel
PRODUCT_CHECK = {"qmm_q8_m1": "int8", "qmm_txn_m1": "int8", "qmm_txn": "int8",
                 "qmm_int8": "int8", "qmm_planes": "planes", "qmm_dequant": "dequant"}


def with_codes(Q, codes, run):
    """run(), with its first activation quantization answered by `codes`
    (the card's (xq, sx) for the product being rerun), where there are any."""
    if codes is None:
        return run()
    orig, left = Q.quantize_activations_g32, [codes]
    Q.quantize_activations_g32 = lambda *a, **kw: left.pop() if left else orig(*a, **kw)
    try:
        return run()
    finally:
        Q.quantize_activations_g32 = orig


# phase 2's limits; planes: its bf16 output, then the bias term added in
# bf16, each a rounding of up to one bf16 step of the largest output
SAME_INPUT_TOL = {"int8": 1e-5, "dequant": 1e-3, "planes": 2 * PLANES_BF16_TOL,
                  "ffn": 2e-3, "planes_g": PLANES_BF16_TOL,     # planes_g: one rounding
                  "i8p": I8P_TOL}


def check_same_input(what, same):
    log(f"  {what} trace: each product against its plain version on the card's own "
        "inputs: " + ", ".join(f"{k} {v:.3g} (tol {SAME_INPUT_TOL[k]})"
                               for k, v in same.items()))
    bad = {k: v for k, v in same.items() if v > SAME_INPUT_TOL[k]}
    if bad:
        raise AssertionError(f"{what}: a product kernel parts from its plain version "
                             f"on the same inputs: {bad}")


def prefill_attention_report(torch, dev, card, cpu):
    """For each flash-kernel prefill attention call of one traced prefill:
    the kernel against its plain version on the card's own inputs, row by
    row (it must stay within FLASH_ROW_TOL), and the row where card and CPU
    part most, with that row's two largest scores: with the synthetic
    weights' large activations softmax is near one-hot, and a near tie
    there turns on one bf16 step of a q or k element."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    lines = []
    for j, ((lab, got, ins), (_, want, _)) in enumerate(zip(card, cpu)):
        if lab != "prefill attention" or not A._use_flash(ins[0].shape[1],
                                                          ins[0].shape[3]):
            continue
        q, k, v, scale = ins[:4]
        on_card = [t.to(dev) for t in (q, k, v)]
        same = row_rel_err(A.flash_prefill(*on_card, scale),
                           A.flash_prefill_plain(*on_card, scale))
        part = (got - want).abs().amax(-1)[0]                   # [T, Hq]
        t, h = divmod(int(part.argmax()), part.shape[1])
        bf = lambda a: a.to(torch.bfloat16).float()
        s = bf(q[0, t, h]) @ bf(k[0, :t + 1, h // (q.shape[2] // k.shape[2])]).T * scale
        top = torch.topk(s, min(2, s.numel())).values.tolist() + [float("nan")]
        lines.append(f"call {j} {lab}: kernel vs plain on the card's inputs {same:.3g} "
                     f"per row (tol {FLASH_ROW_TOL}); card vs CPU part most at row {t} "
                     f"head {h} ({part[t, h].item() / want[0, t, h].abs().max().item():.3g} "
                     f"of its max), top-2 scores {top[0]:.6g}, {top[1]:.6g} (std "
                     f"{s.std().item():.4g})")
        if same > FLASH_ROW_TOL:
            raise AssertionError(f"flash_prefill on the path's inputs: {same}")
    return lines


def whole_path_check(torch, dev, quant="Q4_K", n_prompt=32, n_decode=8,
                     kv_dtype="bf16", i8p=False, stack=True):
    """Two layers at llama3-8b width: card (kernels) vs CPU (plain versions).
    quant "Q4_K_M" is the Q4_K_M recipe at two layers (layer 1 holds the
    Q6_K V and down), unrolled; the others are stacked. i8p attaches the int8
    prefill companions first (models.llama.int8_prefill_params), as the
    Engine does under LLAMAFILE_TPU_I8P=1. The prompt is padded
    to its prefill bucket, as Engine.prefill does. Every op's output is kept
    on both sides, and trace_report's lines are logged: the op at which card
    and CPU first part in each step. stack False keeps the layers unrolled
    (LLAMAFILE_TPU_STACK=0's Engine)."""
    from llamafile_tpu_torch.models.llama import (forward, init_cache, int8_prefill_params,
                                                  stack_layers)
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.testing import make_q4_k_m_llama
    if quant == "Q4_K_M":
        cfg, params = make_q4_k_m_llama("llama3-8b-2l", seed=1, device=dev)
    else:
        cfg, params = make_synthetic_llama("llama3-8b-2l", quant, seed=1, fuse=True,
                                           device=dev)
    gpu = int8_prefill_params(params) if i8p else params
    gpu = stack_layers(gpu) if stack else gpu
    what = (f"{quant}{'' if kv_dtype == 'bf16' else ' ' + kv_dtype + ' KV'}"
            + (" int8 prefill" if i8p else "") + flavour_note())
    cpu = _to(gpu, "cpu")
    bucket = bucket_len(n_prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :n_prompt] = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                       generator=torch.Generator().manual_seed(2))
    max_len = max(256, bucket + n_decode)
    caches = {d: init_cache(cfg, 1, max_len, kv_dtype, device=d) for d in ("cuda", "cpu")}
    logits = {"cuda": [], "cpu": []}
    rec = {"cuda": [], "cpu": []}

    def run(d, p, tokens, pos, **kw):
        rec[d].append([])
        with op_trace(rec[d]):
            lg, _ = forward(p, cfg, tokens.to(d),
                            torch.tensor([pos], dtype=torch.int32, device=d), caches[d], **kw)
        logits[d].append(lg[0, -1].float().cpu())
    for d, p in (("cuda", gpu), ("cpu", cpu)):
        run(d, p, toks, 0, fresh_prefill=True,
            last_idx=torch.tensor([n_prompt - 1], device=d))
    nxt = int(logits["cuda"][0].argmax())
    for step in range(n_decode):
        for d, p in (("cuda", gpu), ("cpu", cpu)):
            run(d, p, torch.tensor([[nxt]]), n_prompt + step, attn_len=max_len)
        nxt = int(logits["cuda"][-1].argmax())
    lines, same = trace_report(rec["cuda"], rec["cpu"])
    for line in lines:
        log(f"  {what} trace {line}")
    check_same_input(f"{what} prompt {n_prompt}", same)
    for line in prefill_attention_report(torch, dev, rec["cuda"][0], rec["cpu"][0]):
        log(f"  {what} trace {line}")
    for line in decode_attention_report(torch, dev, rec["cuda"]):
        log(f"  {what} trace {line}")
    del rec
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  {what} prompt {n_prompt} (bucket {bucket}) step {i}: top-1 card "
            f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"whole path {what} step {i}: card and CPU disagree")
    del gpu, cpu, params
    torch.cuda.empty_cache()


ROUTER_SAME_TOL = 1e-5      # router weights, card vs plain on the card's input


def router_report(torch, step_card, step_cpu, n_experts, k):
    """The router calls of one traced forward (dense products of N =
    n_experts): each rerun through its plain version on the card's own input,
    whose softmax weights must agree with the card's within ROUTER_SAME_TOL;
    a row whose top-k differs there is a fault unless the plain margin
    between the k-th and (k+1)-th weight is within twice that row's rounding
    (a tie). Then the card's and the other side's (the CPU's, or the plain
    versions' on the card) choices row by row: a row that chose other
    experts there follows from an earlier parting of the two runs (each
    product is held on its own inputs). Returns (the rows routed otherwise
    on the two sides, the smallest margin of the other side among them,
    same-input ties, the largest router rounding)."""
    from llamafile_tpu_torch.models import llama as LM
    swaps, min_margin, ties, rnd = set(), float("inf"), 0, 0.0
    for (lab, a, ia), (_, b, ib) in zip(step_card, step_cpu):
        if not isinstance(ia, dict) or lab.startswith(("routed", "grouped", "fused")):
            continue
        qt = ib["args"][0]
        if qt.kind != "dense" or qt.shape[0] != n_experts:
            continue
        # a dense router product: the same torch matmul on either device
        plain = LM.qmatmul(ia["x"].to(qt.qs.device), *ib["args"], **ib["kw"]).cpu()
        wc, wp, wh = (torch.softmax(t.float(), -1) for t in (a, plain, b))
        row_rnd = (wc - wp).abs().amax(-1)
        rnd = max(rnd, row_rnd.max().item())
        pick = lambda w: LM.top_k(w, k)[1].sort(-1).values
        sorted_p = wp.sort(-1, descending=True).values
        margin_p = sorted_p[:, k - 1] - sorted_p[:, k]
        for r in (pick(wc) != pick(wp)).any(-1).nonzero()[:, 0].tolist():
            if margin_p[r] > 2 * row_rnd[r]:
                raise AssertionError(f"{lab}: row {r} routed to other experts on the same "
                                     f"input (margin {margin_p[r]:.3g}, rounding "
                                     f"{row_rnd[r]:.3g})")
            ties += 1
        sorted_h = wh.sort(-1, descending=True).values
        margin_h = sorted_h[:, k - 1] - sorted_h[:, k]
        diff = (pick(wc) != pick(wh)).any(-1)
        swaps |= set(diff.nonzero()[:, 0].tolist())
        if diff.any():
            min_margin = min(min_margin, margin_h[diff].min().item())
    if rnd > ROUTER_SAME_TOL:
        raise AssertionError(f"router weights part from the plain version on the card's "
                             f"input by {rnd}")
    return swaps, min_margin, ties, rnd


@contextlib.contextmanager
def no_sync_moe(torch):
    """While open, every moe_ffn call runs under
    torch.cuda.set_sync_debug_mode("error"): a call that reads a device value
    on the host (a sync) raises. Yields a list whose length counts the calls."""
    from llamafile_tpu_torch.models import llama as LM
    orig, calls = LM.moe_ffn, []

    def strict(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(a[0].shape[0])
        return out
    LM.moe_ffn = strict
    try:
        yield calls
    finally:
        LM.moe_ffn = orig


def moe_path_check(torch, dev, quant="Q4_K", runs=((24, 4), (300, 0)),
                   preset="mixtral-8x7b-2l"):
    """Layers at Mixtral-8x7B width (preset), card (kernels) against the
    plain versions on the card (plain_kernels: the same weights, every
    kernel wrapper on its plain version). quant "Q4_K" is stacked ([L*E] expert stacks: the
    grouped kernels at prefill, the routed fused FFN at decode); "Q4_K_M" is
    the recipe at two layers (layer 1's experts with Q6_K down: the routed
    GEMVs at decode and the dense expert loop at prefill; attn_k/v Q8_0,
    attn_output Q5_K), unrolled. Each run prefills its prompt (padded to its
    bucket) on both sides, then decodes teacher-forced with the card's
    greedy token, each step from the card's cache. Every product is rerun
    through its plain version on the card's own inputs and expert ids; the
    routers as router_report holds them; the logits of a step within 2e-2
    with the same top-1 where no row chose other experts on the two sides,
    and reported otherwise. Then one more decode step with every MoE FFN
    call under the sync check."""
    from llamafile_tpu_torch.models.llama import forward, init_cache, stack_layers
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.testing import make_q4_k_m_llama
    if quant == "Q4_K_M":
        cfg, params = make_q4_k_m_llama(preset, seed=1, device=dev)
    else:
        cfg, params = make_synthetic_llama(preset, quant, seed=1, fuse=True,
                                           device=dev)
    gpu = stack_layers(params)
    what = (f"Mixtral {quant} ({'stacked' if not isinstance(gpu.layers, list) else 'unrolled'}"
            f"{flavour_note()})")
    from llamafile_tpu_torch.ops import qmatmul as Q
    # the decode steps' routed products (gate|up, down a layer, both sides)
    # leave the routed GEMVs for _routed_fallback where the q4b experts are
    # outside the txn flavour
    fallback = quant == "Q4_K" and Q.q4b_flavour() != "txn"
    total_swaps = 0
    for n_prompt, n_decode in runs:
        Q.ROUTE_COUNTS["routed_fallback"] = 0
        bucket = bucket_len(n_prompt)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n_prompt] = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                           generator=torch.Generator().manual_seed(n_prompt))
        max_len = bucket + n_decode + 1
        caches = {d: init_cache(cfg, 1, max_len, device=dev) for d in ("card", "plain")}
        rec = {"card": [], "plain": []}
        logits = {"card": [], "plain": []}

        def run(d, tokens, pos, **kw):
            rec[d].append([])
            with plain_kernels() if d == "plain" else contextlib.nullcontext():
                with op_trace(rec[d]):
                    lg, _ = forward(gpu, cfg, tokens.to(dev),
                                    torch.tensor([pos], dtype=torch.int32, device=dev),
                                    caches[d], **kw)
            logits[d].append(lg[0, -1].float().cpu())
        for d in ("card", "plain"):
            run(d, toks, 0, fresh_prefill=True,
                last_idx=torch.tensor([n_prompt - 1], device=dev))
        nxt = int(logits["card"][0].argmax())
        for step in range(n_decode):
            for name in ("k", "v"):
                getattr(caches["plain"], name).copy_(getattr(caches["card"], name))
            for d in ("card", "plain"):
                run(d, torch.tensor([[nxt]]), n_prompt + step, attn_len=max_len)
            nxt = int(logits["card"][-1].argmax())
        want_fb = 2 * 2 * cfg.n_layers * n_decode if fallback else 0
        log(f"  {what}: {Q.ROUTE_COUNTS['routed_fallback']} _routed_fallback calls over both "
            f"sides' decode steps (expected {want_fb})")
        if Q.ROUTE_COUNTS["routed_fallback"] != want_fb:
            raise AssertionError(f"{what}: the routed products took another route")
        lines, same = trace_report(rec["card"], rec["plain"])
        for line in lines:
            log(f"  {what} trace {line}")
        check_same_input(f"{what} prompt {n_prompt}", same)
        bad = []
        for i, (a, b) in enumerate(zip(logits["card"], logits["plain"])):
            swaps, margin, ties, rnd = router_report(torch, rec["card"][i], rec["plain"][i],
                                                     cfg.n_experts, cfg.n_experts_used)
            total_swaps += len(swaps)
            rel = ((a - b).abs().max() / b.abs().max()).item()
            held = not swaps
            log(f"  {what} prompt {n_prompt} (bucket {bucket}) step {i}: top-1 card "
                f"{int(a.argmax())} plain {int(b.argmax())}, max |diff| / max |logit| = "
                f"{rel:.3g}; routers: card vs plain on its input {rnd:.3g} ({ties} ties), "
                f"{len(swaps)} rows routed otherwise than by the plain versions"
                + (f" (smallest plain margin {margin:.3g}): logits not held" if not held else ""))
            if held and (int(a.argmax()) != int(b.argmax()) or rel > 2e-2):
                bad.append(f"prompt {n_prompt} step {i}")
        if bad:
            raise AssertionError(f"{what}: the kernels and the plain versions disagree at {bad}")
        del rec
        if n_decode:
            with no_sync_moe(torch) as calls:
                forward(gpu, cfg, torch.tensor([[nxt]], device=dev),
                        torch.tensor([n_prompt + n_decode], dtype=torch.int32, device=dev),
                        caches["card"], attn_len=max_len)
                torch.cuda.synchronize()
            log(f"  {what}: {len(calls)} MoE FFN calls of a decode step ran under "
                "set_sync_debug_mode('error'): no device sync")
    log(f"  {what}: {total_swaps} router rows chose other experts on the kernels than on "
        "the plain versions over the traced steps")
    del gpu, params
    torch.cuda.empty_cache()


def decode_attention_report(torch, dev, steps):
    """Each int8-cache decode attention call of a traced run (flash_decode)
    rerun through the kernel and its plain version on the card's own inputs:
    within DECODE_INT8_ROW_TOL per row."""
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.testing import row_rel_err
    worst, n = 0.0, 0
    for step in steps:
        for lab, _, ins in step:
            if lab != "int8 decode attention":
                continue
            q, k, v, pos, scale = [t.to(dev) if hasattr(t, "to") else t for t in ins[:5]]
            kw = {name: t.to(dev) if hasattr(t, "to") else t for name, t in ins[5].items()}
            worst = max(worst, row_rel_err(A.flash_decode(q, k, v, pos, scale, **kw),
                                           A.flash_decode_plain(q, k, v, pos, scale, **kw)))
            n += 1
    if n and worst > DECODE_INT8_ROW_TOL:
        raise AssertionError(f"flash_decode on the path's inputs: {worst}")
    return [f"{n} int8 decode attention calls: kernel vs plain on the card's inputs "
            f"{worst:.3g} per row (tol {DECODE_INT8_ROW_TOL})"] if n else []


def paged_path_check(torch, dev, prompts=(24, 64, 200, 300), n_decode=4,
                     preset="llama3-8b-2l"):
    """The serving decode at two layers of llama3-8b width, card (kernels)
    against the same model on the CPU (plain versions): 4 rows admitted at
    `prompts` tokens (a dense row prefill each on the card, copied into a
    paged pool with shuffled page ids), then n_decode steps of
    forward_paged_decode over all rows, teacher-forced with the card's
    greedy tokens. Both sides start each step from the card's pool, so a
    step's parting is that step's own (the prefill's is phase 3's other
    checks'). Logits per row within 2e-2 of the largest with the same
    top-1; each paged attention call of the card's trace rerun through the
    kernel and its plain version on its own inputs, within PAGED_ROW_TOL.
    A MoE preset (Mixtral width) also holds its routers (router_report: a
    row routed otherwise on the two sides is reported, its logits not
    held), and runs one more step with every MoE FFN call under the sync
    check."""
    from llamafile_tpu_torch.models.llama import (forward, forward_paged_decode,
                                                  init_cache, stack_layers)
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.runtime.paged import PageAllocator, copy_row_to_pages, init_paged
    from llamafile_tpu_torch.testing import paged_controls, row_rel_err
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    gpu = stack_layers(params)
    cpu = _to(gpu, "cpu")
    r, ps, max_len = len(prompts), 64, 512
    what = f"paged {preset} {r} rows{flavour_note()}"
    maxp = max_len // ps
    n_pages = 1 + r * maxp
    alloc = PageAllocator(n_pages, ps, r, max_len)
    alloc.free = [int(p) for p in torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(5)) + 1]
    for i, n in enumerate(prompts):
        alloc.ensure(i, n + n_decode + 1)
    tables = {d: alloc.device_tables(r, device=d) for d in ("cuda", "cpu")}
    pools = {d: init_paged(cfg.n_layers, cfg.n_kv_heads, n_pages, ps, cfg.head_dim,
                           device=d) for d in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(6)
    last = []
    for i, n in enumerate(prompts):
        toks = torch.zeros((1, bucket_len(n)), dtype=torch.int64)
        toks[0, :n] = torch.randint(3, cfg.n_vocab, (n,), generator=gen)
        rc = init_cache(cfg, 1, max_len, device=dev)
        lg, _ = forward(gpu, cfg, toks.to(dev), torch.zeros(1, dtype=torch.int32, device=dev),
                        rc, fresh_prefill=True, last_idx=torch.tensor([n - 1], device=dev))
        copy_row_to_pages(pools["cuda"], rc.k, rc.v,
                          torch.tensor(alloc.tables[i], dtype=torch.int32), ps)
        last.append(int(lg[0, 0].argmax()))
    tok = torch.tensor(last, dtype=torch.int32)
    pos = torch.tensor(prompts, dtype=torch.int32)
    rec = {"cuda": [], "cpu": []}
    worst, bad = 0.0, []
    for step in range(n_decode):
        out = {}
        for name in ("k_pages", "v_pages"):
            getattr(pools["cpu"], name).copy_(getattr(pools["cuda"], name))
        for d, p in (("cuda", gpu), ("cpu", cpu)):
            rec[d].append([])
            with op_trace(rec[d]):
                lg, _ = forward_paged_decode(p, cfg, tok.to(d), (pos + step).to(d),
                                             pools[d], tables[d])
            out[d] = lg.float().cpu()
        a, b = out["cuda"], out["cpu"]
        swapped = set()
        if cfg.n_experts:
            swapped, margin, ties, rnd = router_report(torch, rec["cuda"][-1], rec["cpu"][-1],
                                                       cfg.n_experts, cfg.n_experts_used)
            log(f"  {what} step {step}: routers card vs plain on its input {rnd:.3g} "
                f"({ties} ties); rows routed otherwise than on the CPU {sorted(swapped)}")
        for i in range(r):
            rel = ((a[i] - b[i]).abs().max() / b[i].abs().max()).item()
            if i not in swapped:
                worst = max(worst, rel)
            log(f"  {what} step {step} row {i} (prompt {prompts[i]}): top-1 card "
                f"{int(a[i].argmax())} cpu {int(b[i].argmax())}, max |diff| / max |logit| "
                f"= {rel:.3g}" + (" (routed otherwise: not held)" if i in swapped else ""))
            if i not in swapped and (int(a[i].argmax()) != int(b[i].argmax()) or rel > 2e-2):
                bad.append(f"step {step} row {i}")
        tok = a.argmax(-1).to(torch.int32)
    lines, same = trace_report(rec["cuda"], rec["cpu"])
    for line in lines:
        log(f"  {what} trace {line}")
    check_same_input(what, same)
    if cfg.n_experts:
        with no_sync_moe(torch) as calls:
            forward_paged_decode(gpu, cfg, tok.to(dev), (pos + n_decode).to(dev),
                                 pools["cuda"], tables["cuda"])
            torch.cuda.synchronize()
        log(f"  {what}: {len(calls)} MoE FFN calls of a decode step ran under "
            "set_sync_debug_mode('error'): no device sync")
    same, ctl = 0.0, float("inf")
    for step in rec["cuda"]:
        for lab, _, ins in step:
            if lab != "paged attention":
                continue
            q, kp, vp, lens, tbl = [t.to(dev) for t in ins[:5]]
            want = A.paged_attention_plain(q, kp, vp, lens, tbl)
            same = max(same, row_rel_err(A.paged_attention(q, kp, vp, lens, tbl), want))
            ctl = min([ctl] + [row_rel_err(c, want) for c in
                               paged_controls(q, kp, vp, None, None, lens, tbl, ps)])
    log(f"  paged attention on the path's own inputs: kernel vs plain {same:.3g} per "
        f"(row, head) (tol {PAGED_PATH_TOL}); the controls there {ctl:.3g} at least "
        f"(not held: near one-hot softmax); logits card vs CPU at most {worst:.3g}")
    if same > PAGED_PATH_TOL:
        raise AssertionError(f"paged_attention on the path's inputs: {same}")
    if bad:
        raise AssertionError(f"{what}: card and CPU disagree at {bad}")
    del rec, gpu, cpu, params, pools
    torch.cuda.empty_cache()


def head_dim_64_check(torch, dev, n_prompt=40, n_decode=4, max_seq_len=1000):
    """Decode attention on the reference's non-kernel routes, at TinyLlama's
    widths at two layers (tinyllama-1.1b-2l: head_dim 64, 32 heads on 4 KV
    heads, d_ff 5632) with a max_seq_len that is not a multiple of 256. The
    Engine's prefill of an n_prompt-token prompt and n_decode decode steps
    over its bf16 cache (teacher-forced with the card's greedy token), card
    against CPU: logits within 2e-2 of the largest with the same top-1. Then,
    on the card, Engine.generate of 8 greedy tokens and 3 requests served at
    once by a 3-row batcher: every decode attention call takes the einsum
    (dense cache) or the gather (paged pool) route, counted exactly, and no
    decode kernel launches. Then the 3-row paged decode card against CPU
    (paged_path_check). Returns nothing; raises on any parting."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.server.batcher import Batcher
    preset = "tinyllama-1.1b-2l"
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    n = cfg.n_layers
    engs = {"cuda": Engine(cfg, params, Tokenizer({}), max_seq_len=max_seq_len, device=dev)}
    engs["cpu"] = Engine(cfg, _to(engs["cuda"].params, "cpu"), Tokenizer({}),
                         max_seq_len=max_seq_len, device="cpu")
    del params
    what = f"{preset} (head_dim {cfg.head_dim}, max_seq_len {max_seq_len})"
    prompt = torch.randint(3, cfg.n_vocab, (300,),
                           generator=torch.Generator().manual_seed(11)).tolist()
    caches = {d: e.new_cache() for d, e in engs.items()}
    logits = {d: [e.prefill(caches[d], prompt[:n_prompt])[0].float().cpu()]
              for d, e in engs.items()}
    nxt = int(logits["cuda"][0].argmax())
    for step in range(n_decode):
        for d, e in engs.items():
            lg, _ = forward(e.params, cfg, torch.tensor([[nxt]], device=d),
                            torch.tensor([n_prompt + step], dtype=torch.int32, device=d),
                            caches[d], attn_len=max_seq_len)
            logits[d].append(lg[0, -1].float().cpu())
        nxt = int(logits["cuda"][-1].argmax())
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"  {what} prompt {n_prompt} {'prefill' if i == 0 else f'decode step {i}'}: "
            f"top-1 card {int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| "
            f"= {rel:.3g}")
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"{what} step {i}: card and CPU disagree")
    del engs["cpu"], caches
    eng = engs["cuda"]
    sp = SamplingParams(temperature=0.0)
    decode_kernels = (A.flash_decode_write_stacked, A.flash_decode, A.paged_attention)

    def tallies():
        return dict(A.ROUTE_COUNTS), {w.__name__: w.launches for w in decode_kernels}
    reset_launch_counts()
    toks = [t for t, _ in eng.generate("", max_tokens=8, sampling=sp, stop_on_eog=False,
                                       prompt_ids=prompt[:n_prompt])]
    torch.cuda.synchronize()
    routes, launched = tallies()
    log(f"  {what} Engine.generate of {len(toks)} tokens: routes {routes}, decode kernel "
        f"launches {launched} (expected einsum {7 * n}, none launched)")
    if routes != {"einsum": 7 * n, "gather": 0} or any(launched.values()):
        raise AssertionError(f"{what}: Engine decode left the einsum route")
    reset_launch_counts()
    bt = Batcher(eng, rows=3)
    try:
        st0 = bt.stats["decode_steps"]
        reqs = [bt.submit(prompt[:k], sp, 6) for k in (24, 64, 300)]
        outs = []
        for r in reqs:
            got = []
            while True:
                kind, val = r.out.get(timeout=600)
                if kind == "error":
                    raise AssertionError(f"{what} batcher: {val}")
                if kind == "done":
                    break
                got.append(val)
            outs.append(got)
        steps = bt.stats["decode_steps"] - st0
    finally:
        bt.shutdown()
    routes, launched = tallies()
    log(f"  {what} batcher, 3 rows (prompts 24, 64, 300): {[len(o) for o in outs]} tokens, "
        f"{steps} paged decode steps; routes {routes}, decode kernel launches {launched} "
        f"(expected gather {n * steps}, none launched)")
    if [len(o) for o in outs] != [6] * 3 or routes["gather"] != n * steps \
            or any(launched.values()):
        raise AssertionError(f"{what}: the batcher's decode left the gather route")
    del engs, eng, bt
    torch.cuda.empty_cache()
    reset_launch_counts()
    paged_path_check(torch, dev, prompts=(24, 64, 300), preset=preset)
    if A.paged_attention.launches:
        raise AssertionError(f"{what}: the paged decode launched the paged kernel")
    log(f"  {what} paged decode card vs CPU: gather route {A.ROUTE_COUNTS['gather']} "
        "calls (both sides), no paged kernel launch")


def decode_model_check(torch, dev, preset="llama3.2-3b-2l", n_decode=4, max_seq_len=1024,
                       paged_prompts=(24, 64, 200, 300)):
    """Decode attention at a head group of 3 (llama3.2-3b-2l: Llama-3.2-3B's
    widths at two layers, 24 query heads over 8 KV heads, head_dim 128) or
    at head_dim 256 (gemma-2b-widths-2l: 8 over 1, a group of 8), Q4_K,
    fused and stacked. The Engine's prefill (a 300-token prompt over
    its bf16 cache, bucket 512: the dequant GEMM and the flash prefill; a
    40-token one over its stacked int8 cache) and n_decode decode steps
    (teacher-forced with the card's greedy token), card against CPU: logits
    within 2e-2 of the largest with the same top-1, each decode step on the
    card launching its decode kernel once a layer (flash_decode_write for
    bf16, flash_decode for int8) with no einsum step. Then, on the card,
    Engine.generate of 8 greedy tokens and 4 requests served at once by a
    4-row batcher, every decode attention call a kernel launch, counted
    exactly, with no einsum or gather step; then the paged decode of rows at
    paged_prompts, card against CPU (paged_path_check)."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.server.batcher import Batcher
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    n = cfg.n_layers
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=max_seq_len, device=dev)
    del params
    cpu_params = _to(eng.params, "cpu")
    what = f"{preset} (G = {cfg.n_heads // cfg.n_kv_heads}, D = {cfg.head_dim})"
    prompt = torch.randint(3, cfg.n_vocab, (300,),
                           generator=torch.Generator().manual_seed(12)).tolist()
    decode_kernel = {"bf16": A.flash_decode_write_stacked, "int8": A.flash_decode}
    for kv, n_prompt in (("bf16", 300), ("int8", 40)):
        engs = {d: Engine(cfg, p, Tokenizer({}), max_seq_len=max_seq_len, kv_dtype=kv,
                          device=d) for d, p in (("cuda", eng.params), ("cpu", cpu_params))}
        caches = {d: e.new_cache() for d, e in engs.items()}
        logits = {d: [e.prefill(caches[d], prompt[:n_prompt])[0].float().cpu()]
                  for d, e in engs.items()}
        nxt = int(logits["cuda"][0].argmax())
        torch.cuda.synchronize()
        reset_launch_counts()
        for step in range(n_decode):
            for d, e in engs.items():
                lg, _ = forward(e.params, cfg, torch.tensor([[nxt]], device=d),
                                torch.tensor([n_prompt + step], dtype=torch.int32, device=d),
                                caches[d], attn_len=max_seq_len)
                logits[d].append(lg[0, -1].float().cpu())
            nxt = int(logits["cuda"][-1].argmax())
        launched, routes = decode_kernel[kv].launches, dict(A.ROUTE_COUNTS)
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            log(f"  {what} {kv} KV, prompt {n_prompt} "
                f"{'prefill' if i == 0 else f'decode step {i}'}: top-1 card "
                f"{int(a.argmax())} cpu {int(b.argmax())}, max |diff| / max |logit| = {rel:.3g}")
            if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
                raise AssertionError(f"{what} {kv} KV step {i}: card and CPU disagree")
        log(f"  {what} {kv} KV: {n_decode} decode steps on the card launched "
            f"{decode_kernel[kv].__name__} {launched} times (expected {n * n_decode}); "
            f"routes {routes}")
        if launched != n * n_decode or any(routes.values()):
            raise AssertionError(f"{what} {kv} KV: decode left the kernel route")
        del engs, caches
    del cpu_params
    sp = SamplingParams(temperature=0.0)
    reset_launch_counts()
    toks = [t for t, _ in eng.generate("", max_tokens=8, sampling=sp, stop_on_eog=False,
                                       prompt_ids=prompt[:24])]
    torch.cuda.synchronize()
    counts, routes = launch_counts(), dict(A.ROUTE_COUNTS)
    log(f"  {what} Engine.generate of {len(toks)} tokens: flash_decode_write launches "
        f"{counts['flash_decode_write_stacked']} (expected {7 * n}), routes {routes}")
    if counts["flash_decode_write_stacked"] != 7 * n or any(routes.values()):
        raise AssertionError(f"{what}: Engine decode left the kernel route")
    reset_launch_counts()
    bt = Batcher(eng, rows=4)
    try:
        st0 = bt.stats["decode_steps"]
        reqs = [bt.submit(prompt[:k], sp, 6) for k in (24, 64, 200, 300)]
        outs = []
        for r in reqs:
            got = []
            while True:
                kind, val = r.out.get(timeout=600)
                if kind == "error":
                    raise AssertionError(f"{what} batcher: {val}")
                if kind == "done":
                    break
                got.append(val)
            outs.append(got)
        steps = bt.stats["decode_steps"] - st0
    finally:
        bt.shutdown()
    counts, routes = launch_counts(), dict(A.ROUTE_COUNTS)
    log(f"  {what} batcher, 4 rows (prompts 24, 64, 200, 300): {[len(o) for o in outs]} "
        f"tokens, {steps} paged decode steps; paged_attention launches "
        f"{counts['paged_attention']} (expected {n * steps}), routes {routes}")
    if [len(o) for o in outs] != [6] * 4 or counts["paged_attention"] != n * steps \
            or any(routes.values()):
        raise AssertionError(f"{what}: the batcher's decode left the kernel route")
    del eng, bt
    torch.cuda.empty_cache()
    paged_path_check(torch, dev, prompts=paged_prompts, n_decode=n_decode, preset=preset)


# The reference's attention routes, written out here rather than read from
# the port, so that the launch counts expected from them hold the port's
# routing to the reference's (llamafile_tpu/ops/attention.py: _use_flash,
# and the decode wrappers' einsum branch at :334).
def ref_flash_prefill(t: int, d: int) -> bool:
    """flash_prefill runs a T-token prefill at head_dim d."""
    return t >= 128 and t % 128 == 0 and d in (64, 128, 256)


def ref_decode_kernel(d: int, hq: int, s_eff: int) -> bool:
    """A dense-cache decode of hq query heads at head_dim d over s_eff
    positions runs its kernel (else the einsum)."""
    return s_eff % 256 == 0 and d % 128 == 0 and hq <= 256


def prefill_kernel_layers(cfg, bucket: int) -> int:
    """The layers whose prefill attention at `bucket` tokens runs the
    flash_prefill kernel (ref_flash_prefill: from 128 tokens at a head_dim
    of 64, 128 or 256, not Phi-2's 80), with no softcap and no window
    narrower than the bucket."""
    from llamafile_tpu_torch.models.llama import layer_window
    return sum(1 for li in range(cfg.n_layers)
               if ref_flash_prefill(bucket, cfg.head_dim) and not cfg.attn_softcap
               and (layer_window(cfg, li) or bucket) >= bucket)


def gemma_path_check(torch, dev, preset="gemma-2-9b-2l", prompts=(24, 4200), n_decode=4,
                     recipes=(("Q4_K", "bf16"), ("Q4_K_M", "int8")), max_len=8192,
                     serve=False, vocab_hi=256000):
    """A gemma, qwen or LayerNorm-family preset at two or six layers of a
    published model's widths, the kernels against the plain versions on the
    card (plain_kernels). qwen2.5-7b-2l (Qwen2.5-7B's widths: q/k/v biases, 28
    over 4 heads, G = 7) and qwen3-32b-2l (Qwen3-32B's: q/k norms, 64 over 8
    heads, the fused FFN on stacked layers) take prompts from token ids
    below vocab_hi (their vocabularies are about 152K). The LayerNorm
    presets (pythia-6.9b-2l, phi-2-2l, falcon-7b-2l) run unrolled at every
    recipe, as their layers never stack; a recipe names the layers' format
    (falcon's Q8_0: K = 4544 holds no 256-block). Where the head_dim is not
    a multiple of 128 (Falcon's 64, Phi-2's 80), every decode step takes the
    einsum route on both sides (attention.ROUTE_COUNTS, held) and launches
    no decode kernel; flash_prefill takes head_dim 64, not 80.
    gemma-2-9b-2l (Gemma-2-9B's widths: the gemma2 branches, layer 0
    windowed at 4096, softcaps 50 / 30), gemma-7b-2l (Gemma-7B's: gemma,
    16 over 16 heads of head_dim 256) or gemma-3-27b-6l (Gemma-3-27B's:
    layers 0-4 windowed at 1024, layer 5 global, q/k norms, two rope
    tables): Q4_K stacked over a bf16 cache, then (recipes) llama.cpp's
    Q4_K_M recipe (some layers' V and down in Q6_K: unrolled) over an int8
    cache. For each, the Engine's prefill of each prompt (24 tokens: bucket
    32; gemma3's 600, bucket 1024, where every layer's prefill runs the
    flash_prefill kernel; a longer one whose bucket is past the window: 4200
    tokens, bucket 8192, or 1100, bucket 2048, where the windowed layers'
    prefill runs the einsum and the others' the flash_prefill kernel), then n_decode decode
    steps teacher-forced with the kernels' greedy token, each taken by both
    sides from the kernels' cache, the window biting at the long prompt
    (a windowed layer reads the rows pos - window + 1 .. pos): logits
    within 2e-2 of the largest with the same top-1 at every step. The
    kernels' prefill launches flash_prefill on prefill_kernel_layers' count
    of layers; each decode step launches its decode kernel once a layer
    (flash_decode_write, or flash_decode with the layer's window and the
    softcap), and the fused FFN (its two kernels) once a layer where the
    layers are stacked and their FFN fuses (qwen3; never under GELU or
    unrolled); the plain
    side launches nothing. serve: then, over the stacked recipe's engine,
    the HTTP server at 4 slots (serve_four: 4 greedy requests,
    paged_attention's decode, launches exact), those of the shortest and
    longest prompt against themselves served alone."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.ops.qmatmul import moe_fusable
    from llamafile_tpu_torch.runtime.engine import Engine, attn_bucket, bucket_len
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import make_q4_k_m_llama
    prompt = torch.randint(3, vocab_hi, (max(prompts),),
                           generator=torch.Generator().manual_seed(13)).tolist()
    for recipe, kv in recipes:
        if recipe == "Q4_K_M":
            cfg, params = make_q4_k_m_llama(preset, seed=1, device=dev)
        else:
            cfg, params = make_synthetic_llama(preset, recipe, seed=1, fuse=True, device=dev)
        eng = Engine(cfg, params, Tokenizer({}), max_seq_len=max_len, kv_dtype=kv, device=dev)
        del params
        unrolled = isinstance(eng.params.layers, list)
        if unrolled != (recipe == "Q4_K_M" or cfg.norm_type == "ln"):
            raise AssertionError(f"{preset} {recipe}: the layers were "
                                 f"{'' if unrolled else 'not '}left unrolled")
        what = f"{preset} {recipe} {'unrolled' if unrolled else 'stacked'}, {kv} KV"
        kernel = "flash_decode_write_stacked" if kv == "bf16" else "flash_decode"
        ly = eng.params.layers
        fused = (not unrolled and not cfg.ffn_gelu and ly.w_gate_up is not None
                 and ly.w_gate_up.il and moe_fusable(ly.w_gate_up, ly.w_down, cfg.d_model,
                                                     cfg.d_ff))
        want_moe = 2 * cfg.n_layers * n_decode if fused else 0    # two kernels a call
        for n_prompt in prompts:
            alen = attn_bucket(n_prompt + n_decode + 1, max_len)
            on_kernel = ref_decode_kernel(cfg.head_dim, cfg.n_heads, alen)
            want_dec = cfg.n_layers * n_decode if on_kernel else 0
            caches, logits = {}, {}
            before = launch_counts()["flash_prefill"]
            for side in ("kernels", "plain"):
                with plain_kernels() if side == "plain" else contextlib.nullcontext():
                    caches[side] = eng.new_cache()
                    logits[side] = [eng.prefill(caches[side], prompt[:n_prompt])[0].float().cpu()]
                if side == "kernels":
                    n_fp = launch_counts()["flash_prefill"] - before
            torch.cuda.synchronize()
            want_fp = prefill_kernel_layers(cfg, bucket_len(n_prompt))
            log(f"  {what}, prompt {n_prompt} (bucket {bucket_len(n_prompt)}): prefill "
                f"launched flash_prefill {n_fp} times (expected {want_fp})")
            if n_fp != want_fp:
                raise AssertionError(f"{what}: the prefill did not run as expected")
            reset_launch_counts()
            counts = {"plain": dict.fromkeys(launch_counts(), 0)}
            for step in range(n_decode):
                # both sides take the step from the kernels' cache, so a
                # step's parting is that step's own: on the synthetic
                # weights a parting grows from step to step (0.0054 of the
                # largest logit at step 1, 0.069 at step 2 when each side
                # kept its own cache)
                caches["plain"] = dataclasses.replace(caches["kernels"], **{
                    f.name: None if getattr(caches["kernels"], f.name) is None
                    else getattr(caches["kernels"], f.name).clone()
                    for f in dataclasses.fields(caches["kernels"])})
                tok = torch.tensor([[int(logits["kernels"][-1].argmax())]], device=dev)
                pos = torch.tensor([n_prompt + step], dtype=torch.int32, device=dev)
                for side in ("kernels", "plain"):
                    before = launch_counts()
                    with plain_kernels() if side == "plain" else contextlib.nullcontext():
                        lg, _ = forward(eng.params, cfg, tok, pos, caches[side], attn_len=alen)
                    logits[side].append(lg[0, -1].float().cpu())
                    if side == "plain":
                        counts["plain"] = {k: counts["plain"][k] + v - before[k]
                                           for k, v in launch_counts().items()}
            torch.cuda.synchronize()
            counts["kernels"] = {k: v - counts["plain"][k] for k, v in launch_counts().items()}
            del caches
            for i, (a, b) in enumerate(zip(logits["kernels"], logits["plain"])):
                rel = ((a - b).abs().max() / b.abs().max()).item()
                log(f"  {what}, prompt {n_prompt} (decode s_eff {alen}) "
                    f"{'prefill' if i == 0 else f'decode step {i}'}: top-1 kernels "
                    f"{int(a.argmax())} plain {int(b.argmax())}, max |diff| / max |logit| = "
                    f"{rel:.3g}, max |logit| {b.abs().max().item():.4g}")
                if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
                    raise AssertionError(f"{what} prompt {n_prompt} step {i}: the kernels and "
                                         "the plain versions disagree")
            k = counts["kernels"]
            # both sides' decode calls on the einsum route, where it is theirs
            want_einsum = 0 if on_kernel else 2 * cfg.n_layers * n_decode
            log(f"  {what}, prompt {n_prompt}: {n_decode} decode steps launched {kernel} "
                f"{k[kernel]} times (expected {want_dec}), qmm_moe_m1 "
                f"{k['qmm_moe_m1']} (expected {want_moe}); the plain side launched "
                f"{sum(counts['plain'].values())}; decode routes {dict(A.ROUTE_COUNTS)} "
                f"(einsum expected {want_einsum})")
            if k[kernel] != want_dec or k["qmm_moe_m1"] != want_moe \
                    or A.ROUTE_COUNTS["einsum"] != want_einsum \
                    or any(counts["plain"].values()):
                raise AssertionError(f"{what}: the decode steps did not run as expected")
        if serve and not unrolled:
            n = cfg.n_layers
            # a decode step's 4 rows: the layers' products on qmm_txn and the
            # Q6_K head at M = 4 on the dequant GEMM; an admission slice's
            # head (M = 1) on qmm_q8_m1
            expect = lambda d, small, big, fr: {
                "paged_attention": n * d, "qmm_txn": 4 * n * d + 4 * n * small,
                "qmm_dequant": d + 4 * n * big,
                "flash_prefill": sum(prefill_kernel_layers(cfg, b) * c for b, c in fr.items()),
                "qmm_q8_m1": small + big}
            serve_four(torch, eng, f"synthetic-{preset}-q4k", f"{preset} (phase 3)", expect)
        del eng
        torch.cuda.empty_cache()


def planes_exact_check(torch, dev, preset="pythia-6.9b-2l", n_prompt=300, tol=1e-2):
    """A Q4_K product of an unrolled layer from 256 rows runs qmm_planes,
    whose f32 sum takes the q4b bias term (the group sums of x times the
    per-group bias) before one rounding to bf16. The reference rounds the
    kernel's output to bf16 and adds the bias term in bf16 (ROADMAP C.11):
    where the input has a large mean (the gateless FFN's down product, on
    GELU's output) and the weights a mean near zero, the two terms are each
    far larger than their sum, and each rounding moves it by several
    percent. One 300-token prefill (bucket 512) of preset through op_trace;
    for each q4b product on qmm_planes, the kernel's and its plain
    version's output (on the card's own input) against the exact product
    (the bf16-rounded input times the dequantized weights, f32 on the card),
    in units of the exact output's largest magnitude: each within tol. The
    control, the reference's order of roundings on the same input, must
    part by more than tol on at least one product, or the check could not
    see the fault."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import qmatmul as Q
    from llamafile_tpu_torch.ops.repack import dequant_qtensor
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import rel_err
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    prompt = torch.randint(3, min(50000, cfg.n_vocab), (n_prompt,),
                           generator=torch.Generator().manual_seed(13)).tolist()
    rec = [[]]
    with op_trace(rec):
        eng.prefill(eng.new_cache(), prompt)
    n_checked, worst_control = 0, 0.0
    for j, (lab, got, ins) in enumerate(rec[0]):
        if not isinstance(ins, dict) or not lab.startswith("product"):
            continue
        qt, x = ins["args"][0], ins["x"]
        if Q.product_route(qt, x.shape[0], x.shape[1]) != "qmm_planes":
            continue
        plain = plain_rerun(Q, LM.qmatmul, ins, None)
        pn = ins["kw"].get("prenorm")
        xd = (x.to(dev).float() if pn is None
              else Q.apply_rmsnorm(x.to(dev), pn[0], float(pn[1])))
        exact = (xd.to(torch.bfloat16).float() @ dequant_qtensor(qt).t()).cpu()
        n_out, k = qt.shape
        terms = xd.reshape(xd.shape[0], k // qt.g, qt.g).sum(-1) @ qt.bias.float()
        control = (Q.qmm_planes_plain(xd, qt.qs, qt.scales, bf16_out=True)
                   + terms.to(torch.bfloat16))[:, :n_out].cpu()
        n = n_prompt
        errs = [rel_err(t[:n].float(), exact[:n]) for t in (got, plain, control)]
        worst_control = max(worst_control, errs[2])
        log(f"  {preset} prompt {n_prompt} call {j} {lab} (K {k}, input mean "
            f"{x[:n].float().mean().item():.3g}, out {got.dtype}): against the exact "
            f"product kernel {errs[0]:.3g}, plain {errs[1]:.3g} (within {tol}); "
            f"the reference's roundings {errs[2]:.3g}")
        if max(errs[:2]) > tol:
            raise AssertionError(f"{preset} {lab}: the planes product parts from the exact one")
        n_checked += 1
    if not n_checked or worst_control <= tol:
        raise AssertionError(f"{preset}: {n_checked} planes products checked, the "
                             f"reference's roundings parted by at most {worst_control:.3g}")
    del eng, rec
    torch.cuda.empty_cache()


def counted_generate(torch, eng, prompt, n_new, sp=None):
    """One Engine.generate of n_new tokens (greedy unless sp is given) after
    a warm-up run (first launches of each kernel at these shapes,
    allocator; not counted), with every launch count set to 0 just before
    and read just after. Returns (tokens, counts, time to first token s,
    decode s after the first)."""
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    sp = sp or SamplingParams(temperature=0.0)
    list(eng.generate("", max_tokens=min(n_new, 9), sampling=sp, stop_on_eog=False,
                      prompt_ids=prompt))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, t_first = [], None
    for tid, _ in eng.generate("", max_tokens=n_new, sampling=sp, stop_on_eog=False,
                               prompt_ids=prompt):
        if t_first is None:
            t_first = time.perf_counter()
        toks.append(tid)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = launch_counts()
    if len(toks) != n_new or any(t < 0 or t >= eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"generate produced {toks}")
    return toks, counts, t_first - t0, t_end - t_first


def launch_counts():
    """Every kernel wrapper's launch count by name, and qmm_planes' launches
    on a stacked layer's view (row 12) apart as "qmm_planes_stacked"."""
    from llamafile_tpu_torch.ops import kernel_wrappers
    from llamafile_tpu_torch.ops.qmatmul import qmm_planes
    return {**{w.__name__: w.launches for w in kernel_wrappers()},
            "qmm_planes_stacked": qmm_planes.stacked_launches}


def check_counts(counts, expect, what):
    """Exact launch counts: every kernel not named in expect launched 0 times."""
    want = {name: expect.get(name, 0) for name in counts}
    log(f"  launches in {what}: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{what} did not run through the kernels as expected")


def decode_report(torch, read, steps, ttft_s, decode_s, prompt_note):
    step_ms = decode_s / steps * 1e3
    bound = read / HBM_BYTES_PER_S * 1e3
    log(f"  time to first token {ttft_s * 1e3:.2f} ms ({prompt_note})")
    log(f"  decode {steps / decode_s:.2f} tok/s = {step_ms:.3f} ms a step; "
        f"weight-read bound {bound:.3f} ms a step ({bound / step_ms:.1%})")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return step_ms


def build_engine(torch, dev, quant, i8p=False):
    """Phase 4's engine: llama3-8b, 32 layers, fused, stacked; with i8p, built
    under LLAMAFILE_TPU_I8P=1 (companions attached before stacking)."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3-8b", quant, seed=0, fuse=True, device=dev)
    os.environ["LLAMAFILE_TPU_I8P"] = "1" if i8p else "0"
    try:
        eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    finally:
        del os.environ["LLAMAFILE_TPU_I8P"]
    del params
    torch.cuda.synchronize()
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b {quant}{' with int8 prefill companions' if i8p else ''} (32 "
        f"layers, fused, stacked) in {time.time() - t0:.1f} s; decode reads "
        f"{read / 1e9:.3f} GB of weights a step")
    return eng, read


def i8p_phase(torch, dev, prompt, long_prompt, n_new):
    """Phase 4e: phase 4's model (llama3-8b Q4_K, the same seed, fused,
    stacked) built under LLAMAFILE_TPU_I8P=1: Engine.generate of n_new greedy
    tokens from the 24-token prompt (bucket 32: qmm_txn, no companion read;
    decode as phase 4), then the 1000-token prompt's TTFT, median of 3, with
    one qmm_i8p launch a product of a layer's fused form (qkv, o, gate|up,
    down). Launches exact; the companions' bytes and the peak device memory.
    Returns the counted runs' counts."""
    from llamafile_tpu_torch.models.llama import I8P_FIELDS
    from llamafile_tpu_torch.ops.repack import I8PQTensor
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng, read = build_engine(torch, dev, "Q4_K", i8p=True)
    n = eng.cfg.n_layers
    leaves = [q for q in (getattr(eng.params.layers, f) for f in I8P_FIELDS)
              if isinstance(q, I8PQTensor)]
    comp = sum(t.numel() * t.element_size() for q in leaves for t in (q.qs8, q.s8))
    base = sum(q.nbytes for q in leaves)
    log(f"  companions on {len(leaves)} stacked leaves: {comp / 1e9:.3f} GB (their base "
        f"weights {base / 1e9:.3f} GB); device memory held before building "
        f"{held / 1e9:.2f} GB, peak while building "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, held after "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n,
                          "qmm_moe_m1": 64 * steps,
                          "flash_decode_write_stacked": n * steps}, "phase 4e")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_i8p": 4 * n, "flash_prefill": n, "qmm_txn_m1": 1},
                     "phase 4e, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt, int8 prefill: "
        f"{statistics.median(ttfts):.2f} ms (median of {', '.join(f'{t:.2f}' for t in ttfts)} "
        f"ms); peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, leaves
    torch.cuda.empty_cache()
    return [counts, counts_b]


def main_path(torch, dev):
    """The port's main paths at full width through their user entry points
    (phases 4 to 16; the profiles run apart, profile_run). Returns the
    launch counts of each timed run."""
    eng, read = build_engine(torch, dev, "Q4_K")
    n_layers = eng.cfg.n_layers
    prompt, long_prompt = main_prompts(torch, eng.cfg.n_vocab)
    n_new = 64
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n_layers,
                          "qmm_moe_m1": 64 * steps,
                          "flash_decode_write_stacked": 32 * steps}, "phase 4")
    step_q4 = decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")

    phase("phase 4b: the same engine, a 1000-token prompt (bucket 1024)")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_dequant": 4 * n_layers, "flash_prefill": n_layers,
                                "qmm_txn_m1": 1}, "phase 4b")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
    phase("phase 4d: the same stacked Q4_K weights, dense int8 KV cache, Engine.generate")
    from llamafile_tpu_torch.runtime.engine import Engine
    eng8 = Engine(eng.cfg, eng.params, eng.tokenizer, max_seq_len=2048, kv_dtype="int8",
                  device=dev)
    _, counts_d, ttft, decode_s = counted_generate(torch, eng8, prompt, n_new)
    check_counts(counts_d, {"qmm_txn_m1": 1 + 65 * steps, "qmm_txn": 4 * n_layers,
                            "qmm_moe_m1": 64 * steps, "flash_decode": n_layers * steps},
                 "phase 4d")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32, int8 KV")
    del eng8
    phase("phase 5: serving, the port's HTTP server over the same engine, 8 slots")
    counts_5, _ = serving_phase(torch, eng, read)
    phase("phase 4f: the same engine under the q4b flavours int8 and planes")
    # 32 new tokens under each flavour (cut from 64 to pay for phase 15)
    counts_f, _ = flavour_phase(torch, eng, read, prompt, long_prompt, n_new // 2)
    phase("phase 13: the same engine: grammar requests and slot save/restore under the "
          "HTTP server, then penalties with mirostat and --prompt-cache in Engine.generate")
    counts_13 = state_phase(torch, eng, prompt, step_q4)
    phase("phase 14: the same engine: the batcher's dense row mode at 8 rows, then the "
          f"REPL (--chat) for {len(CHAT_TURNS)} turns")
    counts_14, _ = dense_phase(torch, eng, read)
    phase("phase 15a: the same weights with an f16 and an f32 KV cache, 32 layers, "
          f"Engine.generate of {KV_NEW} tokens each, held against the plain decode attention")
    counts_15 = kv_dtype_phase(torch, eng, read, prompt)
    del eng
    torch.cuda.empty_cache()
    phase("phase 15c: the route knobs, llama3-8b width at 2 layers, card against CPU plain")
    counts_15 += knob_phase(torch, dev)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        phase(f"phase 15d: a {PHASE15_FORMAT} file by the port's writer, llama3-8b widths, "
              f"1 layer, vocabulary cut to {PHASE15_VOCAB}: card against plain")
        counts_15 += format_phase(torch, dev, tmp)
        phase(f"phase 15f: a grid IQ file by the port's writer, llama3-8b widths, 1 layer "
              f"of {PHASE15F_FORMAT} (qmm_dequant at g 8), a {PHASE15F_HEAD} head, "
              f"vocabulary cut to {PHASE15_VOCAB}: card against plain")
        counts_15 += format_phase(torch, dev, tmp, PHASE15F_FORMAT, PHASE15F_HEAD,
                                  "phase 15f")
        phase(f"phase 15e: a llama3-8b Q4_K file of {PHASE15_LOAD_LAYERS} layers with the full "
              "vocabulary by the port's writer, load_engine with the native repacker timed "
              "by piece")
        load_phase(torch, dev, tmp)

    phase("phase 4e: phase 4's weights with the int8 prefill (LLAMAFILE_TPU_I8P=1)")
    counts_e = i8p_phase(torch, dev, prompt, long_prompt, n_new)

    phase("phase 4c: main path, llama3-8b Q8_0, 32 layers, Engine.generate")
    eng, read = build_engine(torch, dev, "Q8_0")
    _, counts_c, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts_c, {"qmm_q8_m1": 1 + (4 * n_layers + 1) * steps,
                            "qmm_dequant": 4 * n_layers,
                            "flash_decode_write_stacked": n_layers * steps}, "phase 4c")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")

    phase(f"phase 6: main path, llama3-8b Q4_K_M, {PHASE6_LAYERS} of 32 layers unrolled, "
          "Engine.generate and the HTTP server")
    counts_6 = q4km_phase(torch, dev, prompt, long_prompt, n_new)
    del eng
    torch.cuda.empty_cache()

    moe_engines, _, counts_7, _ = moe_phase(torch, dev, n_new)
    del moe_engines
    torch.cuda.empty_cache()

    phase(f"phase 8: llama3.2-3b Q4_K (G = 3), {PHASE8_LAYERS} of 28 layers stacked, "
          "Engine.generate and the HTTP server")
    counts_8 = llama32_phase(torch, dev, prompt)

    phase(f"phase 9: gemma-2-9b Q4_K (gemma2), {PHASE9_LAYERS} of 42 layers stacked, "
          "Engine.generate")
    counts_9 = gemma_phase(torch, dev, prompt, long_prompt, n_layers=PHASE9_LAYERS)
    phase(f"phase 10: gemma-3-27b Q4_K (gemma3), {PHASE10_LAYERS} of 62 layers stacked, "
          "Engine.generate")
    counts_10 = gemma_phase(torch, dev, prompt, long_prompt, preset="gemma-3-27b",
                            what="phase 10", n_layers=PHASE10_LAYERS)
    phase(f"phase 11: qwen3-32b Q4_K (qwen3), {PHASE11_LAYERS} of 64 layers stacked, "
          "Engine.generate and the HTTP server")
    qprompt = [t % 150000 for t in prompt]
    qlong = [t % 150000 for t in long_prompt]
    counts_11 = qwen_phase(torch, dev, qprompt, qlong, "qwen3-32b", "phase 11", serve=True,
                           n_layers=PHASE11_LAYERS)
    phase(f"phase 12: qwen2.5-7b Q4_K (qwen2), {PHASE12_LAYERS} of 28 layers stacked, "
          "Engine.generate")
    # (its prefill profile cut to pay for phase 15)
    counts_12 = qwen_phase(torch, dev, qprompt, qlong, "qwen2.5-7b", "phase 12",
                           n_layers=PHASE12_LAYERS)
    counts_16 = ln_phases(torch, dev, prompt, long_prompt)
    return ([counts, counts_b, counts_d, counts_c] + counts_5 + counts_f + counts_13
            + counts_14 + counts_15 + counts_e
            + counts_6 + counts_7 + counts_8 + counts_9 + counts_10 + counts_11 + counts_12
            + counts_16)


def ln_phases(torch, dev, prompt, long_prompt):
    """Phase 16 (ln_phase): starcoder2-7b with generate, the 1000-token
    TTFT and the HTTP server, then command-r-v01 with generate. Returns the
    counted runs' launches."""
    phase(f"phase 16: starcoder2-7b Q4_K (starcoder2), {PHASE16_LAYERS} of 32 layers "
          "unrolled, Engine.generate and the HTTP server")
    sprompt = [t % 49000 for t in prompt]
    slong = [t % 49000 for t in long_prompt]
    runs = ln_phase(torch, dev, sprompt, slong, "starcoder2-7b", "phase 16",
                    PHASE16_LAYERS, ttft=True, serve=True)
    phase(f"phase 16b: command-r-v01 Q4_K (command-r), {PHASE16_CR_LAYERS} of 40 layers "
          "unrolled, Engine.generate")
    return runs + ln_phase(torch, dev, prompt, long_prompt, "command-r-v01", "phase 16b",
                           PHASE16_CR_LAYERS)


def llama32_phase(torch, dev, prompt, n_new=32):
    """Phase 8: Llama-3.2-3B's published widths (models.synthetic preset
    llama3.2-3b: 28 layers, 24 query heads over 8 KV heads, a head group of
    3), Q4_K, fused and stacked: Engine.generate of n_new greedy tokens from
    phase 4's 24-token prompt, launches exact as in phase 4 (the decode
    attention on flash_decode_write at G = 3), the decode rate against the
    weight-read bound; then the HTTP server at 4 slots (serve_four: 4 greedy
    requests, paged_attention at G = 3), that of the longest prompt against
    itself served alone.
    No decode attention call takes the einsum or gather route. Returns the
    counted runs' launch counts."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama("llama3.2-3b", "Q4_K", seed=0, fuse=True, device=dev,
                                       n_layers=PHASE8_LAYERS)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    n = cfg.n_layers
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3.2-3b Q4_K ({n} layers, fused, stacked) in {time.time() - t0:.1f} s; "
        f"decode reads {read / 1e9:.3f} GB of weights a step")
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 1 + (2 * n + 1) * steps, "qmm_txn": 4 * n,
                          "qmm_moe_m1": 2 * n * steps,
                          "flash_decode_write_stacked": n * steps}, "phase 8")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    routes = dict(A.ROUTE_COUNTS)
    counts_s = serve_four(torch, eng, "synthetic-llama3.2-3b-q4k", "phase 8", serving_counts(n))
    log(f"  phase 8 decode attention routes: generate {routes}, served {dict(A.ROUTE_COUNTS)}")
    if any(routes.values()) or any(A.ROUTE_COUNTS.values()):
        raise AssertionError("phase 8: a decode attention call left the kernel route")
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_s]


def gemma_phase(torch, dev, prompt, long_prompt, n_new=64, preset="gemma-2-9b",
                what="phase 9", profile=False, n_layers=None):
    """Phases 9 and 10: Gemma-2-9B's published widths (models.synthetic
    preset gemma-2-9b: 42 layers, 16 query heads over 8 KV heads of head_dim
    256, the gemma2 branches) or Gemma-3-27B's (gemma-3-27b: 62 layers, 32
    query heads over 16 KV heads of head_dim 128, the gemma3 branches),
    Q4_K, fused and stacked, its head in Q6_K, a bf16 cache:
    Engine.generate of n_new greedy tokens from phase 4's 24-token prompt,
    launches exact (a step: qkv, o, gate|up and down on qmm_txn_m1, the
    GELU FFN never fused, the head on qmm_q8_m1, flash_decode_write with the
    layer's window, and gemma2's softcap), the decode rate against the
    weight-read bound; then the 1000-token prompt's TTFT, median of 3 (the
    dequant GEMM; the prefill attention on the flash_prefill kernel on
    prefill_kernel_layers' count: gemma3's every layer at bucket 1024,
    none under gemma2's softcap, whose prefill runs the einsum as the
    reference's). profile: then the device time by kernel of one
    1000-token prefill. Returns the counted runs' launches."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=0, fuse=True, device=dev,
                                       n_layers=n_layers)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    n = cfg.n_layers
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built {preset} Q4_K ({n} layers, fused, stacked, Q6_K head) in "
        f"{time.time() - t0:.1f} s; decode reads {read / 1e9:.3f} GB of weights a step; "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    steps = n_new - 1
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 4 * n * steps, "qmm_txn": 4 * n,
                          "qmm_q8_m1": 1 + steps,
                          "flash_decode_write_stacked": n * steps}, what)
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    n_fp = prefill_kernel_layers(cfg, 1024)
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_dequant": 4 * n, "qmm_q8_m1": 1, "flash_prefill": n_fp},
                     f"{what}, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
    if profile:
        prefill_profile(torch, eng, long_prompt)
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_b]


def qwen_phase(torch, dev, prompt, long_prompt, preset, what, serve=False, profile=False,
               n_layers=None):
    """Phases 11 and 12: Qwen3-32B's published widths (models.synthetic
    preset qwen3-32b: 64 layers, 64 query heads over 8 KV heads of head_dim
    128, q/k norms, d_ff 25600) or Qwen2.5-7B's (qwen2.5-7b: 28 layers, 28
    over 4, q/k/v biases, d_ff 18944), Q4_K, fused and stacked, a Q6_K head,
    a bf16 cache: Engine.generate of 64 greedy tokens from the 24-token
    prompt, launches exact (a step: qkv and o on qmm_txn_m1, the FFN on the
    fused qmm_moe_m1 where d_ff % 1024 == 0 (Qwen3-32B) and on gate|up and
    down otherwise (Qwen2.5-7B's concatenated gate|up), the head on
    qmm_q8_m1, flash_decode_write), the decode rate against the weight-read
    bound; the 1000-token prompt's TTFT, median of 3; serve: the HTTP server
    at 4 slots, 4 greedy requests, launches exact (phase 3's two-layer
    check serves them again alone at these widths); profile (the last timed run of the
    script): then the device time by kernel of one 1000-token prefill;
    n_layers cuts the depth. Returns the counted runs' launches."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.ops.qmatmul import moe_fusable
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=0, fuse=True, device=dev,
                                       n_layers=n_layers)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    n = cfg.n_layers
    ly = eng.params.layers
    fused = ly.w_gate_up.il and moe_fusable(ly.w_gate_up, ly.w_down, cfg.d_model, cfg.d_ff)
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built {preset} Q4_K ({n} layers, fused, stacked, Q6_K head; FFN "
        f"{'fused' if fused else 'unfused'}) in {time.time() - t0:.1f} s; decode reads "
        f"{read / 1e9:.3f} GB of weights a step; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    steps = 63
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, 64)
    gemv = (2 if fused else 4) * n * steps
    check_counts(counts, {"qmm_txn_m1": gemv, "qmm_moe_m1": 2 * n * steps if fused else 0,
                          "qmm_txn": 4 * n, "qmm_q8_m1": 1 + steps,
                          "flash_decode_write_stacked": n * steps}, what)
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_dequant": 4 * n, "qmm_q8_m1": 1, "flash_prefill": n},
                     f"{what}, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
    runs = [counts, counts_b]
    if serve:
        expect = lambda d, small, big, fr: {
            "paged_attention": n * d, "qmm_txn": 4 * n * d + 4 * n * small,
            "qmm_dequant": d + 4 * n * big,
            "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
            "qmm_q8_m1": small + big}
        # the requests alone are held at two layers of these widths (phase 3)
        runs.append(serve_four(torch, eng, f"synthetic-{preset}-q4k", what, expect,
                               serve_alone=False))
    if profile:
        prefill_profile(torch, eng, long_prompt)
    del eng, ly
    gc.collect()                # the served engine's server and loop hold cycles
    torch.cuda.empty_cache()
    return runs


PHASE16_LAYERS = 4     # of StarCoder2-7B's 32
PHASE16_CR_LAYERS = 2  # of Command-R v01's 40


def ln_phase(torch, dev, prompt, long_prompt, preset, what, n_layers, ttft=False,
             serve=False):
    """Phase 16: the LayerNorm families at full width, cut in depth:
    StarCoder2-7B's widths (models.synthetic preset starcoder2-7b: 36 query
    heads over 4 KV heads of 128, G = 9, the gateless GELU FFN at d_ff
    18432, biases on every norm and projection) or Command-R v01's
    (command-r-v01: 64 over 64 heads, SwiGLU at d_ff 22528, a shared norm
    under the parallel residual, vocab 256000, logit_scale), Q4_K, fused,
    unrolled (their layers never stack), a Q6_K head, a bf16 cache:
    Engine.generate of 64 greedy tokens from the 24-token prompt, launches
    exact (a step: qkv, o, up (or gate|up) and down on qmm_txn_m1 a layer,
    never the fused FFN; the head on qmm_q8_m1; flash_decode_write), the
    decode rate against the weight-read bound; ttft: the 1000-token
    prompt's TTFT, median of 3 (qmm_planes on every unrolled product,
    flash_prefill a layer); serve: the HTTP server at 4 slots, 4 greedy
    requests, launches exact, those of the shortest and longest prompt
    against themselves served alone, then the fused 4-row step at the
    served rows' lengths against its bound (fused_step). Returns the
    counted runs' launches."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    t0 = time.time()
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=0, fuse=True, device=dev,
                                       n_layers=n_layers)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    if not isinstance(eng.params.layers, list):
        raise AssertionError(f"{what}: the LayerNorm layers were stacked")
    n = cfg.n_layers
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built {preset} Q4_K ({n} layers, fused, unrolled, Q6_K head) in "
        f"{time.time() - t0:.1f} s; decode reads {read / 1e9:.3f} GB of weights a step; "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    steps = 63
    _, counts, t_first, decode_s = counted_generate(torch, eng, prompt, 64)
    check_counts(counts, {"qmm_txn_m1": 4 * n * steps, "qmm_txn": 4 * n,
                          "qmm_q8_m1": 1 + steps, "flash_decode_write_stacked": n * steps},
                 what)
    decode_report(torch, read, steps, t_first, decode_s, "24-token prompt, bucket 32")
    runs = [counts]
    if ttft:
        ttfts = []
        for _ in range(3):
            _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
            check_counts(counts_b, {"qmm_planes": 4 * n, "qmm_q8_m1": 1,
                                    "flash_prefill": prefill_kernel_layers(cfg, 1024)},
                         f"{what}, 1000 tokens")
            ttfts.append(ttft_b * 1e3)
        log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
            f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
        runs.append(counts_b)
    if serve:
        # a 4-row step: the products on qmm_txn, the Q6_K head at M = 4 on
        # the dequant GEMM; a slice: qmm_txn (bucket <= 32) or qmm_planes
        # (>= 64), the head at M = 1 on the q8b GEMV
        runs.append(serve_four(torch, eng, f"synthetic-{preset}-q4k", what,
                               lambda d, small, big, fr: {
            "paged_attention": n * d, "qmm_txn": 4 * n * (d + small), "qmm_dequant": d,
            "qmm_planes": 4 * n * big,
            "flash_prefill": sum(prefill_kernel_layers(cfg, b) * c for b, c in fr.items()),
            "qmm_q8_m1": small + big}))
        # the served rows' step alone: 4 rows at the served prompts' lengths
        fused_step(torch, eng, read, lengths=(40, 144, 516, 1016))
    del eng
    gc.collect()                # the served engine's server and loop hold cycles
    torch.cuda.empty_cache()
    return runs


MOE_SERVED = (0, 1, 2, 3, 4, 5, 6, 7)      # two requests a prompt length
MOE_REQ = (0, 2, 3, 4, 5, 7, 8, 9)        # their _serve_request indices: greedy, half streamed


def moe_phase(torch, dev, n_new):
    """Phase 7: mixtral-8x7b-8l (Mixtral-8x7B's published widths, top-2 of 8
    experts, 8 layers sharing their weight buffers) at full width. 7a: Q4_K,
    stacked ([64, ...] expert stacks), Engine.generate of n_new greedy tokens
    from a 24-token prompt (the grouped qmm_txn_g at the bucket-32 prompt,
    the routed fused FFN at decode), then the 1000-token prompt's TTFT
    (qmm_planes_g). 7b: the same widths by the Q4_K_M recipe, unrolled
    (layers 0, 3, 6, 7 with Q6_K experts' down: the routed GEMVs at decode,
    the dense expert loop at prefill). 7c: the HTTP server at 8 slots over
    7a's engine, 8 greedy requests (prompts of 24, 128, 500 and 1000 tokens,
    two each), that of the longest prompt against itself
    served alone. Launch counts exact.
    Returns ([7a's engine, 7b's engine], their decode step ms, the counted
    runs' counts, the 24-token prompt)."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import make_q4_k_m_llama, use_more_bits
    runs, engines, step_ms = [], [], []
    vocab = 32000                                   # Mixtral-8x7B's
    prompt = torch.randint(3, vocab, (24,), generator=torch.Generator().manual_seed(3)).tolist()
    long_prompt = torch.randint(3, vocab, (1000,),
                                generator=torch.Generator().manual_seed(4)).tolist()
    for tag, quant in (("7a", "Q4_K"), ("7b", "Q4_K_M")):
        phase(f"phase {tag}: mixtral-8x7b-8l {quant}, Engine.generate")
        t0 = time.time()
        if quant == "Q4_K_M":
            cfg, params = make_q4_k_m_llama("mixtral-8x7b-8l", seed=0, device=dev)
        else:
            cfg, params = make_synthetic_llama("mixtral-8x7b-8l", quant, seed=0, fuse=True,
                                               device=dev)
        eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
        del params
        n = cfg.n_layers
        six = [i for i in range(n) if use_more_bits(i, n)]
        stacked = not isinstance(eng.params.layers, list)
        if stacked != (quant == "Q4_K"):
            raise AssertionError(f"phase {tag}: the layers were {'' if stacked else 'not '}"
                                 "stacked")
        torch.cuda.synchronize()
        read = decode_read_bytes(eng.params, cfg)
        log(f"  built mixtral-8x7b-8l {quant} ({n} layers, "
            + ("stacked, expert stacks [64, ...]" if stacked else
               f"unrolled; Q6_K experts' down in layers {six}, attn_k/v Q8_0, attn_output "
               "Q5_K, output Q6_K") + f") in {time.time() - t0:.1f} s; a decode step "
            f"reads {read / 1e9:.3f} GB of weights (top-2 of 8 experts)")
        steps = n_new - 1
        _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
        if stacked:
            # a step: qkv and o GEMVs, the fused FFN (2 launches) and the
            # fused attention a layer, the head; the bucket-32 prompt: qkv
            # and o on qmm_txn, gate|up and down on qmm_txn_g (64 slots, tm 8)
            want = {"qmm_txn_m1": 1 + (2 * n + 1) * steps, "qmm_txn": 2 * n,
                    "qmm_txn_g": 2 * n, "qmm_moe_m1": 2 * n * steps,
                    "flash_decode_write_stacked": n * steps}
            long_want = {"qmm_dequant": 2 * n, "qmm_planes_g": 2 * n, "flash_prefill": n,
                         "qmm_txn_m1": 1}
        else:
            # a step: q on qmm_txn_m1, k, v (Q8_0) and o (Q5_K) on
            # qmm_q8_m1 a layer; the fused FFN in the Q4_K-down layers, the
            # routed GEMVs (gate|up q4b, down q8b) in the others; the Q6_K
            # head. The prompt: q on qmm_txn, k, v, o on the dequant GEMM;
            # qmm_txn_g in the Q4_K-down layers, the dense loop over 8
            # experts (gate|up on qmm_txn, down on the dequant GEMM) in the
            # others; a 1000-token prompt the same on qmm_planes and qmm_planes_g
            n4 = n - len(six)
            want = {"qmm_txn_m1": n * steps, "qmm_q8_m1": 1 + (3 * n + 1) * steps,
                    "qmm_moe_m1": 2 * n4 * steps, "qmm_txn_m1_r": len(six) * steps,
                    "qmm_q8_m1_r": len(six) * steps, "flash_decode_write_stacked": n * steps,
                    "qmm_txn": n + 8 * len(six), "qmm_dequant": 3 * n + 8 * len(six),
                    "qmm_txn_g": 2 * n4}
            long_want = {"qmm_planes": n + 8 * len(six), "qmm_dequant": 3 * n + 8 * len(six),
                         "qmm_planes_g": 2 * n4, "flash_prefill": n, "qmm_q8_m1": 1}
        check_counts(counts, want, f"phase {tag}")
        step_ms.append(decode_report(torch, read, steps, ttft, decode_s,
                                     "24-token prompt, bucket 32"))
        ttfts = []
        for _ in range(3):
            _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
            check_counts(counts_b, long_want, f"phase {tag}, 1000 tokens")
            ttfts.append(ttft_b * 1e3)
        log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
            f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")
        runs += [counts, counts_b]
        engines.append(eng)
        del eng
    phase("phase 7c: the HTTP server over 7a's engine, 8 slots, 8 greedy requests")
    runs.append(moe_serving(torch, engines[0]))
    return engines, step_ms, runs, prompt


def moe_serving(torch, eng):
    """Phase 7c: 8 greedy requests through the port's Server at 8 slots over
    the stacked Mixtral engine, launches exact from the batcher's tallies;
    each request of the longest prompt served again alone by a
    fresh batcher gives the same ids."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.models.llama import grouped_tm
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    cfg = eng.cfg
    n, k = cfg.n_layers, cfg.n_experts_used
    srv = Server(Flags(model="synthetic-mixtral-8x7b-q4k", slots=8, temp=0.0), eng)
    gen = torch.Generator().manual_seed(9)
    prompts = {i: torch.randint(3, cfg.n_vocab, (SERVE_LENGTHS[i % 4],), generator=gen).tolist()
               for i in MOE_SERVED}
    with running_server(srv) as base:
        _serve_request(base, 3, torch.randint(3, cfg.n_vocab, (40,), generator=gen).tolist(),
                       False)                                # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            results = dict(zip(MOE_SERVED, ex.map(
                lambda i: _serve_request(base, MOE_REQ[i], prompts[i], False, SERVE_NEW),
                MOE_SERVED)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, r[3]) for i, r in results.items() if r[3]]
        if errors:
            raise AssertionError(f"phase 7c requests failed: {errors}")
        n_out = sum(r[1]["completion_tokens"] for r in results.values())
        log(f"  8 requests (prompts {SERVE_LENGTHS} x 2, {SERVE_NEW} new tokens), {n_out} "
            f"tokens out in {wall:.3f} s: {n_out / wall:.2f} output tok/s")
        for L in SERVE_LENGTHS:
            t = sorted((r[2] * 1e3 if r[2] is not None else r[1]["ttft_ms"]) for i, r in
                       results.items() if SERVE_LENGTHS[i % 4] == L)
            log(f"  prompt {L}: TTFT {', '.join(f'{v:.2f}' for v in t)} ms (streamed: client "
                "first token event; plain: the server's ttft_ms)")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        delta = lambda key: {b: c - st0[key].get(b, 0) for b, c in st1[key].items()}
        dsteps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(c for b, c in allb.items() if b <= 32)
        big = sum(c for b, c in allb.items() if b >= 64)
        txn_g = sum(c for b, c in allb.items() if grouped_tm(k * b) <= 32)
        planes_g = sum(c for b, c in allb.items() if grouped_tm(k * b) > 32)
        log(f"  batcher tallies: {dsteps} fused decode steps at 8 rows (16 slots: qmm_txn_g), "
            f"admission slices by bucket {allb} (fresh {fr})")
        # a step: qkv, o and the head on qmm_txn (8 rows), the grouped FFN
        # (2 qmm_txn_g), paged attention; a slice: qkv and o on qmm_txn
        # (bucket <= 32) or the dequant GEMM, the grouped FFN by its tile
        # size, the head at M = 1
        check_counts(counts, {
            "paged_attention": n * dsteps, "qmm_txn": (2 * n + 1) * dsteps + 2 * n * small,
            "qmm_txn_g": 2 * n * (dsteps + txn_g), "qmm_planes_g": 2 * n * planes_g,
            "qmm_dequant": 2 * n * big,
            "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
            "qmm_txn_m1": small + big}, "phase 7c")
    alone = Batcher(eng, rows=8)
    try:
        for i in (i for i in MOE_SERVED if len(prompts[i]) in ALONE_LENGTHS):
            toks = _alone_tokens(alone, prompts[i], srv._sp({"temperature": 0.0}), SERVE_NEW)
            same = toks == results[i][0]
            log(f"  request {i} (prompt {len(prompts[i])}): alone {len(toks)} tokens, "
                f"{'the same ids' if same else 'DIFFERENT ids'} as served beside the others")
            if not same:
                raise AssertionError(f"phase 7c request {i}: {toks} alone, "
                                     f"{results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return counts


SERVE_SAMPLED = (1, 6, 11, 12)        # request indices sampled at temperature 0.8
SERVE_CHAT = (14, 15)                 # request indices sent as chat messages


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_request(base, i, ids, chat, max_tokens=64):
    """Request i of phase 5 over HTTP; returns (token ids, usage, client TTFT
    s or None, error or None). Streamed requests take their TTFT at the
    first token event."""
    import urllib.request
    body = {"max_tokens": max_tokens, "stream": i % 2 == 0}
    if i in SERVE_SAMPLED:
        body.update(temperature=0.8, top_k=40, seed=i)
    else:
        body.update(temperature=0.0)
    if chat:
        # Tokenizer({}) maps each byte to one token: a message of about the
        # prompt length (the chat template adds its own tokens)
        body["messages"] = [{"role": "user", "content": "x" * (len(ids) - 40)}]
        path = "/v1/chat/completions"
    else:
        body["prompt"] = ids
        path = "/v1/completions"
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, text, usage = None, "", None
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            if not body["stream"]:
                out = json.loads(r.read())
                ch = out["choices"][0]
                text = ch["message"]["content"] if chat else ch["text"]
                usage = out["usage"]
            else:
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    evt = json.loads(line[6:])
                    if "error" in evt:
                        return [], None, None, evt["error"]
                    ch = evt["choices"][0]
                    piece = (ch.get("delta") or {}).get("content", "") if chat \
                        else ch.get("text", "")
                    if piece and ttft is None:
                        ttft = time.perf_counter() - t0
                    text += piece
                    usage = evt.get("usage", usage)
    except Exception as e:                     # noqa: BLE001 — reported, then raised
        return [], None, None, repr(e)
    # Tokenizer({}) decodes token t as "<t>": the text carries the ids
    return [int(t) for t in re.findall(r"<(\d+)>", text)], usage, ttft, None


def _collect_tokens(req):
    """A batcher request's token ids, once it is done."""
    toks = []
    while True:
        kind, val = req.out.get(timeout=900)
        if kind == "token":
            toks.append(val)
        elif kind == "done":
            return toks
        elif kind == "error":
            raise AssertionError(f"request failed: {val}")


def _alone_tokens(batcher, ids, sp, max_tokens=64):
    return _collect_tokens(batcher.submit(ids, sp, max_tokens))


@contextlib.contextmanager
def running_server(srv):
    """The port's HTTP server srv on a free 127.0.0.1 port, in a thread of
    this process, until the block ends; yields its base URL."""
    import asyncio
    import urllib.request
    from llamafile_tpu_torch.server.http import _amain
    port = _free_port()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(_amain(srv, "127.0.0.1", port))
        except RuntimeError:
            pass                               # loop.stop() at the end
    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                urllib.request.urlopen(base + "/health", timeout=5)
                break
            except Exception:
                time.sleep(0.1)
        yield base
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        srv.shutdown()


# phase 5's embedding traffic: (requests, tokens a request, client threads)
EMBED_SHORT = (128, 50, 16)      # cut from 256 requests to pay for phase 15
EMBED_LONG = (8, 500, 8)
EMBED_TOL = 1e-3                  # max abs, unit vectors


def _embed_request(base, ids):
    """One /v1/embeddings request of a token array; (vector, seconds)."""
    import urllib.request
    req = urllib.request.Request(base + "/v1/embeddings",
                                 data=json.dumps({"input": ids}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    return out["data"][0]["embedding"], time.perf_counter() - t0


def embedding_phase(torch, srv, base, eng):
    """Phase 5's embeddings, after its generation traffic, over the same
    server: EMBED_SHORT's 128 /v1/embeddings requests of 50 tokens from 16
    client threads (batches of up to 64 rows of bucket 64: the dequant GEMM
    at M = rows x 64), then EMBED_LONG's 8 requests of 500 tokens from 8
    threads (bucket 512: flash_prefill at B > 1 where they batch). Each
    window alone (the batcher idle) with launch counts exact: a batch
    launches the four products a layer on qmm_dequant and, at bucket 512,
    flash_prefill once a layer, nothing else (no head). Reports req/s, the
    p50 latency and the batches formed; then holds vectors of both windows
    within EMBED_TOL (max abs) of the same ids embedded alone, on the
    kernels and on the plain versions on the card. Returns the windows'
    launch counts."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import bucket_len
    from llamafile_tpu_torch.server.embed import llama_embed_many
    n = eng.cfg.n_layers
    runs, held = [], []
    for (n_req, length, threads), seed in ((EMBED_SHORT, 21), (EMBED_LONG, 22)):
        g = torch.Generator().manual_seed(seed)
        reqs = [torch.randint(3, eng.cfg.n_vocab, (length,), generator=g).tolist()
                for _ in range(n_req)]
        _embed_request(base, reqs[0])              # warm-up, not counted
        torch.cuda.synchronize()
        st0 = dict(srv.embedder.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as ex:
            outs = list(ex.map(lambda ids: _embed_request(base, ids), reqs))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        batches = srv.embedder.stats["batches"] - st0["batches"]
        lat = [o[1] for o in outs]
        b = bucket_len(length)
        log(f"  embeddings, {n_req} requests of {length} tokens from {threads} threads: "
            f"{n_req / wall:.2f} req/s ({wall:.3f} s), latency p50 "
            f"{statistics.median(lat) * 1e3:.2f} ms, max {max(lat) * 1e3:.2f} ms; {batches} "
            f"batches formed ({n_req / batches:.2f} texts a batch, bucket {b})")
        check_counts(counts, {"qmm_dequant": 4 * n * batches,
                              "flash_prefill": n * batches if b >= 128 else 0},
                     f"phase 5 embeddings, {length} tokens")
        runs.append(counts)
        held += [(reqs[i], outs[i][0]) for i in (0, n_req - 1)]
    em = llama_embed_many(eng)
    for ids, served in held:
        served = torch.tensor(served)
        alone = torch.tensor(em([ids])[0])
        with plain_kernels():
            plain = torch.tensor(em([ids])[0])
        torch.cuda.synchronize()
        e_alone, e_plain = ((served - w).abs().max().item() for w in (alone, plain))
        log(f"  embedding of {len(ids)} tokens: served vs alone {e_alone:.3g}, vs the plain "
            f"versions on the card {e_plain:.3g} (tol {EMBED_TOL}, max abs; |v| = "
            f"{served.norm().item():.6f})")
        if not (e_alone <= EMBED_TOL and e_plain <= EMBED_TOL):
            raise AssertionError("phase 5: an embedding parts from itself alone or from "
                                 "the plain versions")
    return runs


def db_webui_check(base, db_path):
    """The web UI's routes on a running server started with --db: a chat
    made, a message added and read back through /db/*, the file on disk
    holding them, and / serving the port's copy of the web UI."""
    import sqlite3
    import urllib.request
    from llamafile_tpu_torch.server import http as H

    def call(path, body=None, method=None):
        req = urllib.request.Request(base + path, method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    cid = json.loads(call("/db/chats", {"title": "chip smoke"})[2])["id"]
    call(f"/db/chats/{cid}/messages", {"role": "user", "content": "hello card"})
    chat = json.loads(call(f"/db/chats/{cid}")[2])
    if chat["title"] != "chip smoke" or [m["content"] for m in chat["messages"]] \
            != ["hello card"]:
        raise AssertionError(f"/db: read back {chat}")
    with sqlite3.connect(db_path) as c:
        rows = c.execute("SELECT role, content FROM messages WHERE chat_id=?",
                         (cid,)).fetchall()
    if rows != [("user", "hello card")]:
        raise AssertionError(f"/db: the database file holds {rows}")
    status, ct, page = call("/")
    with open(os.path.join(os.path.dirname(H.__file__), "www", "index.html"), "rb") as f:
        if status != 200 or ct != "text/html" or page != f.read():
            raise AssertionError(f"/: status {status}, {ct}, {len(page)} bytes")
    log(f"  /db: chat {cid} made, a message added and read back (and from the "
        f"file); /: the web UI, {len(page)} bytes of text/html")


def serving_phase(torch, eng, read):
    """Phase 5: the port's Server at full width, 8 slots, 16 requests from 8
    client threads; then the embeddings (embedding_phase) and the web UI's
    routes (db_webui_check, the server started with --db). Returns (the
    launch counts of the counted run, the fused 8-row step's time in
    ms)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    tmp = tempfile.TemporaryDirectory()
    db_path = os.path.join(tmp.name, "chats.db")
    srv = Server(Flags(model="synthetic-llama3-8b-q4k", slots=8, temp=0.0, db=db_path),
                 eng)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, eng.cfg.n_vocab, (SERVE_LENGTHS[i % 4],),
                             generator=gen).tolist() for i in range(16)]
    with running_server(srv) as base:
        # warm-up (first launches at these shapes, allocator): not counted
        warm = torch.randint(3, eng.cfg.n_vocab, (40,), generator=gen).tolist()
        _serve_request(base, 0, warm, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(lambda i: _serve_request(base, i, prompts[i],
                                                           i in SERVE_CHAT), range(16)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, e) for i, (_, _, _, e) in enumerate(results) if e]
        if errors:
            raise AssertionError(f"phase 5 requests failed: {errors}")
        n_out = sum(u["completion_tokens"] for _, u, _, _ in results)
        log(f"  16 requests, {n_out} tokens out in {wall:.3f} s: {n_out / wall:.2f} "
            f"output tok/s (8 slots, prompts {SERVE_LENGTHS} x 4, 64 new tokens)")
        for n in SERVE_LENGTHS:
            sel = [(i, results[i]) for i in range(16) if SERVE_LENGTHS[i % 4] == n]
            ttfts = sorted((res[2] if res[2] is not None else res[1]["ttft_ms"] / 1e3)
                           for _, res in sel)
            log(f"  prompt {n}: TTFT p50 {statistics.median(ttfts) * 1e3:.2f} ms, max "
                f"{max(ttfts) * 1e3:.2f} ms (streamed: client first token event; plain: "
                f"the server's ttft_ms); prompt tokens "
                f"{[res[1]['prompt_tokens'] for _, res in sel]}")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        delta = lambda k: {b: n - st0[k].get(b, 0) for b, n in st1[k].items()}
        steps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(n for b, n in allb.items() if b <= 32)
        big = sum(n for b, n in allb.items() if b >= 64)
        n_layers = eng.cfg.n_layers
        expect = {"paged_attention": n_layers * steps,
                  "qmm_txn": (4 * n_layers + 1) * steps + 4 * n_layers * small,
                  "qmm_dequant": 4 * n_layers * big,
                  "flash_prefill": n_layers * sum(n for b, n in fr.items() if b >= 128),
                  "qmm_txn_m1": small + big}
        log(f"  batcher tallies: {steps} fused decode steps, admission slices by bucket "
            f"{allb} (fresh {fr})")
        check_counts(counts, expect, "phase 5")
        if not srv.batcher.alive():
            raise AssertionError("phase 5: the batcher's device thread died")
        counts_e = embedding_phase(torch, srv, base, eng)
        db_webui_check(base, db_path)
    tmp.cleanup()
    # the same requests alone, one after another, on a fresh 8-slot batcher
    greedy = [next(i for i in range(16) if SERVE_LENGTHS[i % 4] == n and i not in
                   SERVE_SAMPLED and i not in SERVE_CHAT) for n in SERVE_LENGTHS]
    check_ids = [i for i in greedy if SERVE_LENGTHS[i % 4] in ALONE_LENGTHS] + [SERVE_SAMPLED[0]]
    alone = Batcher(eng, rows=8)
    try:
        for i in check_ids:
            sp = srv._sp({"temperature": 0.8, "top_k": 40, "seed": i}
                         if i in SERVE_SAMPLED else {"temperature": 0.0})
            toks = _alone_tokens(alone, prompts[i], sp)
            same = toks == results[i][0]
            log(f"  request {i} (prompt {SERVE_LENGTHS[i % 4]}, "
                f"{'sampled' if i in SERVE_SAMPLED else 'greedy'}): alone "
                f"{len(toks)} tokens, {'the same ids' if same else 'DIFFERENT ids'} "
                "as served beside the others")
            if not same:
                raise AssertionError(f"request {i}: {toks} alone, {results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return [counts] + counts_e, fused_step(torch, eng, read)


Q4KM_SERVED = (0, 2, 3, 5)          # phase 5's greedy request indices: 2 streamed


def _dense_setup(torch, eng):
    """A row-batched cache and row state for one fused chunk of the dense
    mode at 8 rows (FUSED_LENGTHS), and the chunk's attn_bucket window."""
    from llamafile_tpu_torch.runtime.engine import attn_bucket
    pw, rp, tok, pos = _row_state(torch, eng)
    alen = attn_bucket(max(FUSED_LENGTHS) + 8 + 1, eng.max_seq_len)
    return eng.init_row_cache(len(FUSED_LENGTHS)), pw, rp, tok, pos, alen


def dense_step(torch, eng, read):
    """Engine.fused_decode, the dense mode's fused step, at 8 rows (rows at
    FUSED_LENGTHS, the window their attn_bucket), timed by the host clock
    around synchronized 8-step chunks, against its bound: the weights plus
    R x attn_len positions of K/V read once a step."""
    cache, pw, rp, tok, pos, alen = _dense_setup(torch, eng)
    run = lambda: eng.fused_decode(tok, pos, cache, pw, [None] * 8, rp, 8, attn_len=alen)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 8 * 1e3)
    step_ms = statistics.median(times)
    kv = len(FUSED_LENGTHS) * alen * KV_BYTES_PER_TOKEN
    bound = (read + kv) / HBM_BYTES_PER_S * 1e3
    log(f"  dense fused step at 8 rows (lengths {FUSED_LENGTHS}, attn_len {alen}): "
        f"{step_ms:.3f} ms (median of {', '.join(f'{t:.3f}' for t in times)}) against a "
        f"{bound:.3f} ms bound ({read / 1e9:.3f} GB weights + 8 x {alen} x "
        f"{KV_BYTES_PER_TOKEN} B = {kv / 1e9:.3f} GB KV): {bound / step_ms:.1%}")
    del cache
    torch.cuda.empty_cache()
    return step_ms


def dense_profile(torch, eng, step_ms):
    """Device busy share of one dense fused 8-row chunk under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    cache, pw, rp, tok, pos, alen = _dense_setup(torch, eng)
    run = lambda: eng.fused_decode(tok, pos, cache, pw, [None] * 8, rp, 8, attn_len=alen)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / 8
    del cache
    torch.cuda.empty_cache()
    if busy_ms == 0:
        log("  dense fused step busy share: not measured (the profiler recorded no kernels)")
        return
    log(f"  dense fused 8-row step: device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms "
        f"step ({busy_ms / step_ms:.1%}); {n_act / 8:.1f} device activities a step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 8 / 1e3:8.4f} ms/step  {name[:90]}")


CHAT_TURNS = ("Tell me about the card in this machine.",      # a third cut for phase 15
              "What else can it do, and how fast is it?")
CHAT_NEW = 16                     # tokens a turn of the REPL session


def chat_phase(torch, eng):
    """A two-turn REPL session in process (a third cut for phase 15): cli.chat_loop over a
    ChatSession on eng's weights with grammar_tokenizer's pieces (text to
    byte pieces), CHAT_NEW greedy tokens a turn. Each turn's TTFT and the
    tokens it reused from the kept cache; turn 2's first-token logits
    against a fresh prefill of its whole prompt: within 2e-2 of the
    largest, the same top-1. Launches counted over the session:
    flash_decode_write once a layer a decode step when no turn stops at an
    end-of-generation piece. Returns the launch counts."""
    import io
    from llamafile_tpu_torch.cli import chat_loop
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import ChatSession, Engine
    from llamafile_tpu_torch.utils.flags import parse_flags
    n, v = eng.cfg.n_layers, eng.cfg.n_vocab
    ceng = Engine(eng.cfg, eng.params, grammar_tokenizer(v), max_seq_len=eng.max_seq_len,
                  device=eng.device)
    turns, logits = [], []

    class TimedSession(ChatSession):
        def generate(self, prompt_ids, **kw):
            t0 = time.perf_counter()
            got = 0
            for tid, piece in super().generate(prompt_ids, **kw):
                if not got:
                    turns.append(dict(ids=list(prompt_ids), reused=self.reused_last,
                                      ttft=time.perf_counter() - t0))
                got += 1
                yield tid, piece
            turns[-1]["tokens"] = got

    def prefill(orig):
        def run(cache, ids, pos0=0):
            last, cache = orig(cache, ids, pos0)
            logits.append(last.clone())
            return last, cache
        return run

    flags = parse_flags(["-n", str(CHAT_NEW), "--temp", "0"])
    out = io.StringIO()
    list(ceng.generate("warm up", max_tokens=9, sampling=flags.sampling()))
    torch.cuda.synchronize()
    reset_launch_counts()
    with patched(ceng, "prefill", prefill):
        rc = chat_loop(ceng, flags, io.StringIO("".join(t + "\n" for t in CHAT_TURNS)),
                       out, session=TimedSession(ceng))
    torch.cuda.synchronize()
    counts = launch_counts()
    if rc != 0 or out.getvalue().count(">>> ") != len(CHAT_TURNS) + 1 \
            or len(turns) != len(CHAT_TURNS):
        raise AssertionError(f"REPL session: rc {rc}, {turns}, output {out.getvalue()!r}")
    for i, t in enumerate(turns):
        log(f"  REPL turn {i + 1}: prompt {len(t['ids'])} tokens, {t['reused']} reused "
            f"from the kept cache, {len(t['ids']) - t['reused']} prefilled; TTFT "
            f"{t['ttft'] * 1e3:.2f} ms; {t['tokens']} tokens")
    if turns[0]["reused"] != 0 or not all(t["reused"] > 0 for t in turns[1:]) \
            or not all(len(t["ids"]) - t["reused"] > 1 for t in turns):
        raise AssertionError(f"REPL session reuse: {[t['reused'] for t in turns]}")
    fresh, _ = ceng.prefill(ceng.new_cache(), turns[1]["ids"])
    rel = ((logits[1] - fresh).abs().max() / fresh.abs().max()).item()
    same = int(logits[1].argmax()) == int(fresh.argmax())
    log(f"  turn 2's first-token logits against a fresh prefill of its "
        f"{len(turns[1]['ids'])}-token prompt: {rel:.3e} of the largest (limit 2e-2), "
        f"top-1 {'the same' if same else 'DIFFERENT'}")
    if not (rel <= 2e-2 and same):
        raise AssertionError("REPL turn 2: the reused cache's logits part from a fresh prefill")
    steps = sum(t["tokens"] - 1 for t in turns)
    if all(t["tokens"] == CHAT_NEW for t in turns):
        if counts["flash_decode_write_stacked"] != n * steps:
            raise AssertionError(f"REPL session: {counts['flash_decode_write_stacked']} "
                                 f"flash_decode_write launches for {steps} decode steps")
        log(f"  launches in the session: flash_decode_write {n} x {steps} decode steps")
    else:
        log(f"  a turn stopped at the end-of-generation piece: launches {counts}")
    return counts


DENSE_NEW = 24                    # new tokens a request of phase 14 (cut from 32 for phase 16)


def dense_phase(torch, eng, read):
    """Phase 14 on phase 4's engine (llama3-8b Q4_K, 32 layers): the
    batcher's dense row mode, Batcher(paged=False) at 8 rows (a bf16
    row-batched cache [32, 8, 2048, 1024]), serving phase 5's 16 prompts
    (SERVE_LENGTHS, SERVE_SAMPLED at 0.8) with DENSE_NEW new tokens each,
    submitted at once after a warm-up. Launches exact: flash_decode_write once a layer a
    fused step, the products at M = 8 on qmm_txn, the admission slices as
    phase 5's. Output tok/s; each request of ALONE_LENGTHS and the first
    sampled one served again alone on a fresh dense batcher gives its ids;
    the fused step timed (dense_step); then the REPL session (chat_phase).
    Returns (the counted runs' launch counts, the fused step's ms)."""
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.server.batcher import Batcher
    n, v = eng.cfg.n_layers, eng.cfg.n_vocab
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, v, (SERVE_LENGTHS[i % 4],), generator=gen).tolist()
               for i in range(16)]
    sps = [SamplingParams(temperature=0.8, top_k=40, seed=i) if i in SERVE_SAMPLED
           else SamplingParams(temperature=0.0) for i in range(16)]
    b = Batcher(eng, rows=8, paged=False)
    try:
        if b.paged_mode or tuple(b.cache.k.shape) != (n, 8, eng.max_seq_len, 1024):
            raise AssertionError(f"phase 14: not the dense cache ({b.paged_mode})")
        _collect_tokens(b.submit(torch.randint(3, v, (40,), generator=gen).tolist(),
                                 sps[0], 8))
        torch.cuda.synchronize()
        st0 = copy.deepcopy(b.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [b.submit(prompts[i], sps[i], DENSE_NEW) for i in range(16)]
        results = [_collect_tokens(r) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = b.stats
        if not b.alive():
            raise AssertionError("phase 14: the batcher's device thread died")
    finally:
        b.shutdown()
    n_out = sum(len(t) for t in results)
    log(f"  16 requests, {n_out} tokens out in {wall:.3f} s: {n_out / wall:.2f} output "
        f"tok/s (8 dense rows, prompts {SERVE_LENGTHS} x 4, {DENSE_NEW} new tokens)")
    delta = lambda k: {bk: c - st0[k].get(bk, 0) for bk, c in st1[k].items()}
    steps = st1["decode_steps"] - st0["decode_steps"]
    sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
    allb = {bk: sl.get(bk, 0) + fr.get(bk, 0) for bk in set(sl) | set(fr)}
    small = sum(c for bk, c in allb.items() if bk <= 32)
    big = sum(c for bk, c in allb.items() if bk >= 64)
    log(f"  batcher tallies: {steps} fused decode steps at 8 rows, admission slices by "
        f"bucket {allb} (fresh {fr})")
    check_counts(counts, {"flash_decode_write_stacked": n * steps,
                          "qmm_txn": (4 * n + 1) * steps + 4 * n * small,
                          "qmm_dequant": 4 * n * big,
                          "flash_prefill": n * sum(c for bk, c in fr.items() if bk >= 128),
                          "qmm_txn_m1": small + big}, "phase 14")
    greedy = [next(i for i in range(16) if SERVE_LENGTHS[i % 4] == m and i not in
                   SERVE_SAMPLED) for m in ALONE_LENGTHS]
    alone = Batcher(eng, rows=8, paged=False)
    try:
        for i in greedy + [SERVE_SAMPLED[0]]:
            toks = _alone_tokens(alone, prompts[i], sps[i], DENSE_NEW)
            same = toks == results[i]
            log(f"  request {i} (prompt {SERVE_LENGTHS[i % 4]}, "
                f"{'sampled' if i in SERVE_SAMPLED else 'greedy'}): alone {len(toks)} "
                f"tokens, {'the same ids' if same else 'DIFFERENT ids'} as served beside "
                "the others")
            if not same:
                raise AssertionError(f"phase 14 request {i}: {toks} alone, {results[i]}")
    finally:
        alone.shutdown()
    del b, alone
    torch.cuda.empty_cache()
    step_ms = dense_step(torch, eng, read)
    log(f"  the REPL (--chat) in process, {len(CHAT_TURNS)} turns")
    counts_chat = chat_phase(torch, eng)
    return [counts, counts_chat], step_ms


KV_NEW = 16                       # phase 15a: new tokens a run (cut from 32 for phase 16)
KV_PLAIN_TOL = 2e-2               # of the largest logit, as phase 3 holds logits
PHASE15_FORMAT = "Q2_K"           # phase 15d's file: q8b codes, per-16 scales and a bias
PHASE15_VOCAB = 8192              # phase 15d's vocabulary, cut from 128256
PHASE15_LOAD_LAYERS = 4           # phase 15e's depth, cut from 32
KNOBS = ("STACK", "ILGU", "FLASH_DECODE", "PRENORM")


def serving_counts(n):
    """expect() of serve_four for n stacked Q4_K layers of a llama with a
    fused FFN (phases 8 and 15b): decode steps d at 4 rows, admission
    slices by bucket."""
    return lambda d, small, big, fr: {
        "paged_attention": n * d,
        "qmm_txn": (4 * n + 1) * d + 4 * n * small, "qmm_dequant": 4 * n * big,
        "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
        "qmm_txn_m1": small + big}


def kv_plain_check(torch, eng, prompt, toks, kv):
    """Phase 15a's hold: every decode step of generate's tokens toks run
    again from the same cache, once through flash_decode_write and once
    through its plain version on the card (plain_kernels(products=False):
    the products on their kernels both times, deterministic), logits within
    KV_PLAIN_TOL of the largest with the same top-1; the kernel's step must
    give generate's next token. The first step is also held, within the
    same limit and with the same top-1, against the plain versions of every
    kernel (plain_kernels(): the products' too)."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.runtime.engine import attn_bucket
    from llamafile_tpu_torch.runtime.kvcache import KVCache
    dev = eng.device
    cache = eng.new_cache()
    eng.prefill(cache, prompt)
    p0 = len(prompt)
    alen = attn_bucket(p0 + len(toks) + 1, eng.max_seq_len)
    worst = 0.0
    for i in range(len(toks) - 1):
        tok = torch.tensor([[toks[i]]], dtype=torch.int32, device=dev)
        pos = torch.tensor([p0 + i], dtype=torch.int32, device=dev)
        snap = KVCache(cache.k.clone(), cache.v.clone())
        with plain_kernels(products=False):
            want, _ = forward(eng.params, eng.cfg, tok, pos, snap, attn_len=alen)
        if i == 0:
            whole_snap = KVCache(cache.k.clone(), cache.v.clone())
            with plain_kernels():
                whole, _ = forward(eng.params, eng.cfg, tok, pos, whole_snap, attn_len=alen)
            del whole_snap
        got, _ = forward(eng.params, eng.cfg, tok, pos, cache, attn_len=alen)
        a, b = got[0, -1].float(), want[0, -1].float()
        if i == 0:
            c = whole[0, -1].float()
            gap = ((a - c).abs().max() / c.abs().max()).item()
            log(f"  {kv} KV, the first decode step against the plain versions of every "
                f"kernel (the products too): max |diff| / max |logit| {gap:.3g}, top-1 "
                f"{'the same' if int(a.argmax()) == int(c.argmax()) else 'DIFFERENT'} "
                f"(tol {KV_PLAIN_TOL})")
            if int(a.argmax()) != int(c.argmax()) or gap > KV_PLAIN_TOL:
                raise AssertionError(f"phase 15a {kv}: the first step parts from the plain "
                                     f"versions of every kernel ({gap:.3g})")
            del whole
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if int(a.argmax()) != int(b.argmax()) or rel > KV_PLAIN_TOL \
                or int(a.argmax()) != toks[i + 1]:
            raise AssertionError(f"phase 15a {kv} step {i}: top-1 kernel {int(a.argmax())}, "
                                 f"plain {int(b.argmax())}, generate {toks[i + 1]}; "
                                 f"max |diff| / max |logit| = {rel:.3g}")
        del snap
    log(f"  {kv} KV, {len(toks) - 1} decode steps again from the same cache: "
        f"flash_decode_write against its plain version on the card, the same top-1 "
        f"(generate's tokens) at every step, worst max |diff| / max |logit| {worst:.3g} "
        f"(tol {KV_PLAIN_TOL})")


def kv_dtype_phase(torch, eng, read, prompt):
    """Phase 15a-b on phase 4's llama3-8b Q4_K weights (32 layers, not
    reloaded): Engine.generate of KV_NEW greedy tokens on an f16 and on an
    f32 dense cache, launches exact as in phase 4 (decode attention on
    flash_decode_write's f16 and f32 instances), each held against its plain
    version (kv_plain_check); then (15b) the HTTP server at 4 slots over an
    f16 paged pool (serve_four: paged_attention's f16 pages). Returns the
    counted runs' launch counts."""
    from llamafile_tpu_torch.runtime.engine import Engine
    n, steps = eng.cfg.n_layers, KV_NEW - 1
    out, e16 = [], None
    for kv in ("f16", "f32"):
        e = Engine(eng.cfg, eng.params, eng.tokenizer, max_seq_len=2048, kv_dtype=kv,
                   device=eng.device)
        toks, counts, ttft, decode_s = counted_generate(torch, e, prompt, KV_NEW)
        check_counts(counts, {"qmm_txn_m1": 1 + (2 * n + 1) * steps, "qmm_txn": 4 * n,
                              "qmm_moe_m1": 2 * n * steps,
                              "flash_decode_write_stacked": n * steps}, f"phase 15a {kv}")
        decode_report(torch, read, steps, ttft, decode_s,
                      f"24-token prompt, bucket 32, {kv} KV")
        kv_plain_check(torch, e, prompt, toks, kv)
        out.append(counts)
        e16 = e if kv == "f16" else e16
        del e
        torch.cuda.empty_cache()
    phase("phase 15b: the HTTP server at 4 slots over an f16 paged pool, the same weights")
    out.append(serve_four(torch, e16, "synthetic-llama3-8b-q4k", "phase 15b (f16 pool)",
                          serving_counts(n)))
    del e16
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def route_knob(name):
    """One of the reference's route knobs off, set where the port reads it:
    LLAMAFILE_TPU_STACK and _ILGU in the environment (read when an Engine is
    built and by models.loader.fuse_projections), _FLASH_DECODE and
    _PRENORM in the module constants they were read into at import
    (ops.attention.FLASH_DECODE, models.llama.PRENORM)."""
    from llamafile_tpu_torch.models import llama as LM
    from llamafile_tpu_torch.ops import attention as A
    if name in ("STACK", "ILGU"):
        key = f"LLAMAFILE_TPU_{name}"
        old = os.environ.get(key)
        os.environ[key] = "0"
        try:
            yield
        finally:
            if old is None:
                del os.environ[key]
            else:
                os.environ[key] = old
        return
    mod, attr = (A, "FLASH_DECODE") if name == "FLASH_DECODE" else (LM, "PRENORM")
    old = getattr(mod, attr)
    setattr(mod, attr, False)
    try:
        yield
    finally:
        setattr(mod, attr, old)


def knob_phase(torch, dev):
    """Phase 15c: each route knob off in turn (route_knob) at 2 layers of
    llama3-8b width (llama3-8b-2l, Q4_K, fused): Engine.generate of 8
    greedy tokens from a 40-token prompt (bucket 64: the stacked dequant
    GEMM, or under STACK=0 the unstacked planes), launches exact, then
    whole_path_check card against CPU plain under the same knob. STACK=0:
    every product unstacked (qmm_planes at the prefill, qmm_txn_m1 for all
    four at M = 1) and flash_decode_write on each layer's view, as the
    reference's unrolled loop calls its fused kernel; ILGU=0: gate|up
    concatenated, no qmm_moe_m1; FLASH_DECODE=0: no decode attention
    kernel, the einsum route a layer a step; PRENORM=0: the launches of
    the default. Returns the counted runs' launch counts."""
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import attention as A
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    n_new, n_prompt = 8, 40
    steps = n_new - 1
    out = []
    for name in KNOBS:
        phase(f"  phase 15c LLAMAFILE_TPU_{name}=0")
        with route_knob(name):
            cfg, params = make_synthetic_llama("llama3-8b-2l", "Q4_K", seed=1, fuse=True,
                                               device=dev)
            eng = Engine(cfg, params, Tokenizer({}), max_seq_len=1024, device=dev)
            del params
            n = cfg.n_layers
            prompt = torch.randint(3, cfg.n_vocab, (n_prompt,),
                                   generator=torch.Generator().manual_seed(6)).tolist()
            _, counts, _, _ = counted_generate(torch, eng, prompt, n_new)
            routes = dict(A.ROUTE_COUNTS)
            flat = name in ("STACK", "ILGU")          # no fused FFN
            want = {"qmm_txn_m1": 1 + ((4 if flat else 2) * n + 1) * steps,
                    "qmm_moe_m1": 0 if flat else 2 * n * steps,
                    "flash_decode_write_stacked": 0 if name == "FLASH_DECODE" else n * steps,
                    "qmm_planes" if name == "STACK" else "qmm_dequant": 4 * n}
            check_counts(counts, want, f"phase 15c {name}=0")
            einsum = n * steps if name == "FLASH_DECODE" else 0
            log(f"  decode attention routes: {routes} (expected einsum {einsum})")
            if routes != {"einsum": einsum, "gather": 0}:
                raise AssertionError(f"phase 15c {name}=0: routes {routes}")
            del eng
            torch.cuda.empty_cache()
            whole_path_check(torch, dev, "Q4_K", n_prompt=n_prompt, n_decode=1,
                             stack=name != "STACK")
        out.append(counts)
    return out


# phase 15f's file: IQ1_M layers (q8b g 8 with a bias: qmm_dequant at
# every M) and an IQ2_XS head (q8b g 16: qmm_q8_m1 at M = 1)
PHASE15F_FORMAT, PHASE15F_HEAD = "IQ1_M", "IQ2_XS"


def format_phase(torch, dev, tmp, quant=PHASE15_FORMAT, head_quant=None, what="phase 15d"):
    """Phases 15d and 15f: a GGUF file of `quant` (head `head_quant`, else
    quant) written by the port's writer at llama3-8b's widths
    (models.synthetic.write_synthetic_gguf: 1 layer, the vocabulary cut to
    PHASE15_VOCAB, random codes, small f16 d) and loaded by load_engine on
    the card: Engine.generate of 8 greedy tokens with exact launches, then
    the prefill and 4 decode steps card against the plain versions on the
    card (plain_kernels), logits within 2e-2 of the largest with the same
    top-1. 15d (Q2_K: q8b codes, per-16 scales and a bias) runs phase 4c's
    pattern, qmm_dequant at the prefill and qmm_q8_m1 at M = 1; 15f (IQ1_M
    layers: q8b at per-8 scales with a bias) qmm_dequant at every layer
    product, prefill and decode, and the IQ2_XS head on qmm_q8_m1. Returns
    the counted run's launches."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import write_synthetic_gguf
    from llamafile_tpu_torch.runtime.engine import bucket_len, load_engine
    path = os.path.join(tmp, f"llama3-8b-1l-{quant}.gguf")
    t0 = time.time()
    write_synthetic_gguf(path, "llama3-8b", quant, n_layers=1, n_vocab=PHASE15_VOCAB,
                         head_quant=head_quant)
    eng = load_engine(path, device=dev, max_seq_len=1024)
    torch.cuda.synchronize()
    layer = eng.params.layers[0]                  # one layer: unrolled, as the reference
    qkv = (layer.wqkv.kind, layer.wqkv.g, layer.wqkv.bias is not None)
    log(f"  wrote and loaded {os.path.getsize(path) / 1e6:.1f} MB in {time.time() - t0:.1f} s; "
        f"qkv {qkv[0]} g={qkv[1]} bias {qkv[2]}; head {eng.params.output.kind} "
        f"g={eng.params.output.g}")
    g = {"Q2_K": 16, "IQ1_M": 8}[quant]
    if qkv != ("q8b", g, True):
        raise AssertionError(f"{what}: {quant} did not repack to q8b g{g} with a bias")
    n, n_new = eng.cfg.n_layers, 8
    steps = n_new - 1
    prompt = torch.randint(3, PHASE15_VOCAB, (24,),
                           generator=torch.Generator().manual_seed(7)).tolist()
    _, counts, _, _ = counted_generate(torch, eng, prompt, n_new)
    m1 = "qmm_dequant" if g == 8 else "qmm_q8_m1"        # the layers' M = 1 kernel
    expect = {"qmm_dequant": 4 * n, "qmm_q8_m1": 1 + steps,
              "flash_decode_write_stacked": n * steps}
    expect[m1] += 4 * n * steps
    check_counts(counts, expect, what)
    caches = {k: eng.new_cache() for k in ("card", "plain")}
    toks = torch.zeros((1, bucket_len(24)), dtype=torch.int32, device=dev)
    toks[0, :24] = torch.tensor(prompt, device=dev)
    step = lambda c, t, p, **kw: forward(eng.params, eng.cfg, t, torch.tensor(
        [p], dtype=torch.int32, device=dev), caches[c], **kw)[0][0, -1].float()
    nxt, worst = None, 0.0
    for i in range(5):
        args = ((toks, 0) if i == 0 else
                (torch.tensor([[nxt]], dtype=torch.int32, device=dev), 23 + i))
        kw = (dict(fresh_prefill=True, last_idx=torch.tensor([23], device=dev)) if i == 0
              else dict(attn_len=256))
        a = step("card", *args, **kw)
        with plain_kernels():
            b = step("plain", *args, **kw)
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if int(a.argmax()) != int(b.argmax()) or rel > 2e-2:
            raise AssertionError(f"{what} step {i}: card and plain disagree ({rel:.3g})")
        nxt = int(a.argmax())
    log(f"  prefill and 4 decode steps, card against the plain versions on the card: the "
        f"same top-1, worst max |diff| / max |logit| {worst:.3g}")
    del eng, caches
    os.remove(path)
    torch.cuda.empty_cache()
    return [counts]


def repack_compare(torch, path, name="blk.0.ffn_gate.weight", runs=3):
    """One Q4_K matrix of the file (llama3-8b's gate, 14336 x 4096) through
    the native repacker and the numpy path, `runs` times each on every
    core, the outputs compared byte for byte."""
    import numpy as np
    from llamafile_tpu_torch import native
    from llamafile_tpu_torch.gguf.reader import GGUFReader
    from llamafile_tpu_torch.ops import repack as RP
    r = GGUFReader(path)
    t = r.tensors[name]
    raw = np.array(r.tensor_bytes(name))
    shape = (int(np.prod(t.shape[:-1])), t.shape[-1])
    secs, outs = {"native": [], "numpy": []}, {}
    for _ in range(runs):
        for how in secs:
            t0 = time.perf_counter()
            outs[how] = RP.repack_numpy(raw, t.type_name, shape, native=how == "native")
            secs[how].append(time.perf_counter() - t0)
    same = all((a is None and b is None) or (a.dtype == b.dtype and a.shape == b.shape
                                             and np.array_equal(a.view(np.uint8),
                                                                b.view(np.uint8)))
               for a, b in zip(outs["native"][1:4], outs["numpy"][1:4]))
    log(f"  {name} {t.type_name} {shape}, {torch.get_num_threads()} threads of "
        f"{os.cpu_count()} CPUs: native {', '.join(f'{x:.4f}' for x in secs['native'])} s, "
        f"numpy {', '.join(f'{x:.4f}' for x in secs['numpy'])} s (median "
        f"{statistics.median(secs['numpy']) / statistics.median(secs['native']):.1f}x); "
        f"outputs {'byte-identical' if same else 'DIFFERENT'}")
    print(json.dumps({"repack_one_matrix_s": {k: [round(x, 4) for x in v]
                                              for k, v in secs.items()},
                      "threads": torch.get_num_threads(), "cpus": os.cpu_count(),
                      "native_calls": native.native_repack.calls}), flush=True)
    if not same or outs["native"][0] != outs["numpy"][0]:
        raise AssertionError("phase 15e: the native repack parts from the numpy path")


def load_phase(torch, dev, tmp):
    """Phase 15e: a llama3-8b Q4_K GGUF of PHASE15_LOAD_LAYERS layers with
    the full vocabulary (write_synthetic_gguf, the port's writer; every
    matrix, the embedding and the head Q4_K), then load_engine on it with
    torch (so the native repacker's OpenMP team) on every CPU, timed by
    piece: the file's bytes read (the mmap pages copied: the file was just
    written, so the reads are warm), the native repack (ops.repack's
    repack_numpy through native.native_repack: every Q4_K matrix, asserted
    by its call count), the rest of repack() (N padding, the copy to the
    device), the embedding's and norms' host dequant with its copy, and the
    rest (config, tokenizer, fuse_projections, stack_layers). Prints the
    extrapolation of each piece to 32 layers, labelled as one; then one
    matrix through the native repacker and the numpy path side by side
    (repack_compare)."""
    from llamafile_tpu_torch import native
    from llamafile_tpu_torch.gguf import reader as RD
    from llamafile_tpu_torch.models import loader as LD
    from llamafile_tpu_torch.models.synthetic import write_synthetic_gguf
    from llamafile_tpu_torch.ops import repack as RP
    import numpy as np
    from llamafile_tpu_torch.runtime.engine import load_engine
    path = os.path.join(tmp, "llama3-8b-4l-q4k.gguf")
    t0 = time.time()
    write_synthetic_gguf(path, "llama3-8b", "Q4_K", n_layers=PHASE15_LOAD_LAYERS)
    log(f"  wrote {os.path.getsize(path) / 1e9:.3f} GB ({PHASE15_LOAD_LAYERS} layers, vocab "
        f"128256) through the port's GGUFWriter in {time.time() - t0:.1f} s")
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    t0 = time.perf_counter()
    if native.lib() is None:                    # built (or found) before the timed load
        raise AssertionError("phase 15e: no native repacker on the card's host")
    log(f"  native repacker {os.path.basename(native.lib_path())} ready in "
        f"{time.perf_counter() - t0:.2f} s; {os.cpu_count()} CPUs; card: {nvidia_smi()}")
    calls0 = native.native_repack.calls
    secs = {}                                   # (piece, layer or not) -> seconds
    add = lambda k, layer, dt: secs.__setitem__((k, layer), secs.get((k, layer), 0.0) + dt)
    orig_bytes, orig_f32 = RD.GGUFReader.tensor_bytes, RD.GGUFReader.tensor_f32
    orig_numpy, orig_repack = RP.repack_numpy, LD.repack
    cur = {"layer": False, "read": 0.0}

    def tensor_bytes(self, name):
        t = time.perf_counter()
        raw = np.array(orig_bytes(self, name))
        dt = time.perf_counter() - t
        cur["read"] += dt
        add("read", name.startswith("blk."), dt)
        cur["layer"] = name.startswith("blk.")
        return raw

    def tensor_f32(self, name):
        t, r0 = time.perf_counter(), cur["read"]
        out = orig_f32(self, name)
        add("embedding and norms (host dequant)", name.startswith("blk."),
            time.perf_counter() - t - (cur["read"] - r0))
        return out

    def repack_numpy(*a, **kw):
        t, c = time.perf_counter(), native.native_repack.calls
        out = orig_numpy(*a, **kw)
        how = "native" if native.native_repack.calls > c else "numpy"
        add(f"repack ({how})", cur["layer"], time.perf_counter() - t)
        cur["numpy"] = time.perf_counter() - t
        return out

    def repack(*a, **kw):
        t = time.perf_counter()
        out = orig_repack(*a, **kw)
        torch.cuda.synchronize()
        add("to the device", cur["layer"], time.perf_counter() - t - cur["numpy"])
        return out
    patches = [(RD.GGUFReader, "tensor_bytes", tensor_bytes),
               (RD.GGUFReader, "tensor_f32", tensor_f32),
               (RP, "repack_numpy", repack_numpy), (LD, "repack", repack)]
    for obj, name, f in patches:
        setattr(obj, name, f)
    try:
        t0 = time.perf_counter()
        eng = load_engine(path, device=dev, max_seq_len=2048)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        setattr(RD.GGUFReader, "tensor_bytes", orig_bytes)
        setattr(RD.GGUFReader, "tensor_f32", orig_f32)
        RP.repack_numpy, LD.repack = orig_numpy, orig_repack
    n_native = native.native_repack.calls - calls0
    if n_native != 7 * PHASE15_LOAD_LAYERS + 1:
        raise AssertionError(f"phase 15e: the native repacker ran {n_native} times, not on "
                             f"every Q4_K matrix ({7 * PHASE15_LOAD_LAYERS + 1})")
    pieces = {}
    for (k, layer), v in secs.items():
        pieces.setdefault(k, [0.0, 0.0])[0 if layer else 1] += v
    rest = total - sum(sum(v) for v in pieces.values())
    scale = 32 / PHASE15_LOAD_LAYERS
    log(f"  load_engine: {total:.3f} s on {PHASE15_LOAD_LAYERS} layers, by piece (layers + "
        "the rest; the read warm: the file was just written):")
    for k, (lay, other) in pieces.items():
        log(f"    {k}: {lay + other:.3f} s (layers {lay:.3f}, embedding, head and norms "
            f"{other:.3f}); extrapolated to 32 layers: {lay * scale + other:.3f} s")
    log(f"    the rest (config, tokenizer, fuse_projections, stack_layers): {rest:.3f} s")
    est = sum(l * scale + o for l, o in pieces.values()) + rest
    log(f"  EXTRAPOLATION, not a measurement: load_engine of a 32-layer file "
        f"~{est:.1f} s, of which the native repack "
        f"~{pieces['repack (native)'][0] * scale + pieces['repack (native)'][1]:.1f} s")
    print(json.dumps({"load_pieces_s": {k: [round(a, 3), round(b, 3)]
                                        for k, (a, b) in pieces.items()},
                      "load_total_s": round(total, 3), "rest_s": round(rest, 3),
                      "layers": PHASE15_LOAD_LAYERS, "native_calls": n_native,
                      "threads": torch.get_num_threads()}), flush=True)
    repack_compare(torch, path)
    torch.set_num_threads(threads)
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    toks = [t for t, _ in eng.generate("hello", max_tokens=4, stop_on_eog=False,
                                       sampling=SamplingParams(temperature=0.0))]
    if len(toks) != 4:
        raise AssertionError(f"phase 15e: the loaded engine generated {toks}")
    del eng
    os.remove(path)
    torch.cuda.empty_cache()


# phases 6 and 8-12's depths, halved for phase 15 (6, 8, 11 and 12 from 8,
# after the cuts for phases 11-14; 9 from 12 and 10 from 16)
PHASE6_LAYERS = 4      # of llama3-8b's 32 (still two formats: layers 2 and 3 Q6_K)
PHASE8_LAYERS = 4      # of Llama-3.2-3B's 28
PHASE9_LAYERS = 6      # of Gemma-2-9B's 42
PHASE10_LAYERS = 8     # of Gemma-3-27B's 62 (layer 5 global)
PHASE11_LAYERS = 4     # of Qwen3-32B's 64
PHASE12_LAYERS = 4     # of Qwen2.5-7B's 28


def q4km_phase(torch, dev, prompt, long_prompt, n_new):
    """Phase 6: llama3-8b by the Q4_K_M recipe, PHASE6_LAYERS of its 32
    layers (16 / 32 of them with Q6_K V and down), unrolled, through
    Engine.generate (24-token prompt, n_new greedy tokens; then the
    1000-token prompt's TTFT) and the HTTP server at 4 slots (4 greedy
    requests, that of the longest prompt against itself
    served alone). Launch counts
    exact, from the recipe's layer list. Returns the counted runs' counts."""
    from llamafile_tpu_torch.models.synthetic import decode_read_bytes
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.testing import make_q4_k_m_llama, use_more_bits
    t0 = time.time()
    cfg, params = make_q4_k_m_llama("llama3-8b", seed=0, device=dev, n_layers=PHASE6_LAYERS)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=2048, device=dev)
    del params
    n = cfg.n_layers
    six = [i for i in range(n) if use_more_bits(i, n)]
    n6 = len(six)
    if not isinstance(eng.params.layers, list):
        raise AssertionError("phase 6: the Q4_K_M layers were stacked")
    torch.cuda.synchronize()
    read = decode_read_bytes(eng.params, cfg)
    log(f"  built llama3-8b Q4_K_M ({n} layers, unrolled; attn_v and ffn_down Q6_K "
        f"in layers {six}, output Q6_K) in {time.time() - t0:.1f} s; decode reads "
        f"{read / 1e9:.3f} GB of weights a step")
    steps = n_new - 1
    # a step: four q4b GEMVs a layer (qkv or q and k, o, gate|up, down of the
    # Q4_K layers), the Q6_K V and down and the head on the q8b GEMV; a
    # bucket-32 prompt: the same products on qmm_txn and the dequant GEMM
    _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
    check_counts(counts, {"qmm_txn_m1": 4 * n * steps, "qmm_q8_m1": 1 + (2 * n6 + 1) * steps,
                          "flash_decode_write_stacked": n * steps, "qmm_txn": 4 * n,
                          "qmm_dequant": 2 * n6}, "phase 6")
    decode_report(torch, read, steps, ttft, decode_s, "24-token prompt, bucket 32")
    ttfts = []
    for _ in range(3):
        _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
        check_counts(counts_b, {"qmm_planes": 4 * n, "qmm_dequant": 2 * n6,
                                "flash_prefill": n, "qmm_q8_m1": 1}, "phase 6, 1000 tokens")
        ttfts.append(ttft_b * 1e3)
    log(f"  time to first token, 1000-token prompt: {statistics.median(ttfts):.2f} ms "
        f"(median of {', '.join(f'{t:.2f}' for t in ttfts)} ms)")

    log("  the HTTP server on this engine, 4 slots, 4 greedy requests")
    # a 4-row step: q4b products on qmm_txn, Q6_K ones and the head on
    # the dequant GEMM; a slice: qmm_txn (bucket <= 32) or qmm_planes
    # (>= 64) and the dequant GEMM, the head at M = 1 on the q8b GEMV
    counts_s = serve_four(torch, eng, "synthetic-llama3-8b-q4_k_m", "phase 6",
                          lambda d, small, big, fr: {
        "paged_attention": n * d,
        "qmm_txn": 4 * n * (d + small),
        "qmm_dequant": (2 * n6 + 1) * d + 2 * n6 * (small + big),
        "qmm_planes": 4 * n * big,
        "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128),
        "qmm_q8_m1": small + big})
    del eng
    torch.cuda.empty_cache()
    return [counts, counts_b, counts_s]


SERVE_NEW = 16            # new tokens a request of serve_four and phase 7c (cut from 64
                          # for phase 15, then from 32 for phase 16)


def serve_four(torch, eng, model, what, expect, serve_alone=True):
    """The port's HTTP server over eng at 4 slots: 4 greedy requests of
    SERVE_NEW new tokens (the prompts of SERVE_LENGTHS, as phase 5's
    requests Q4KM_SERVED: 2 streamed) from 4 client threads, launch counts
    exact (expect(decode steps, small slices, big slices, fresh slices by
    bucket) from the batcher's tallies), then (serve_alone) each request of
    the shortest and longest prompt on a fresh 4-row batcher, which must
    give the same ids. Returns the counted run's launch counts."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    n_vocab = eng.cfg.n_vocab
    srv = Server(Flags(model=model, slots=4, temp=0.0), eng)
    gen = torch.Generator().manual_seed(8)
    prompts = {i: torch.randint(3, n_vocab, (SERVE_LENGTHS[k],), generator=gen).tolist()
               for k, i in enumerate(Q4KM_SERVED)}
    with running_server(srv) as base:
        # warm-up (not counted), a prompt that shares no prefix with the
        # requests: a reused prefix would admit request 0 by another path
        _serve_request(base, 0, torch.randint(3, n_vocab, (40,), generator=gen).tolist(), False)
        torch.cuda.synchronize()
        st0 = copy.deepcopy(srv.batcher.stats)
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            results = dict(zip(Q4KM_SERVED, ex.map(
                lambda i: _serve_request(base, i, prompts[i], False, SERVE_NEW),
                Q4KM_SERVED)))
        wall = time.perf_counter() - t0
        counts = launch_counts()
        st1 = srv.batcher.stats
        errors = [(i, r[3]) for i, r in results.items() if r[3]]
        if errors:
            raise AssertionError(f"{what} requests failed: {errors}")
        n_out = sum(r[1]["completion_tokens"] for r in results.values())
        log(f"  4 requests (prompts {SERVE_LENGTHS}, {SERVE_NEW} new tokens), {n_out} "
            f"tokens out in {wall:.3f} s: "
            f"{n_out / wall:.2f} output tok/s")
        delta = lambda k: {b: c - st0[k].get(b, 0) for b, c in st1[k].items()}
        dsteps = st1["decode_steps"] - st0["decode_steps"]
        sl, fr = delta("slices_by_bucket"), delta("fresh_slices_by_bucket")
        allb = {b: sl.get(b, 0) + fr.get(b, 0) for b in set(sl) | set(fr)}
        small = sum(c for b, c in allb.items() if b <= 32)
        big = sum(c for b, c in allb.items() if b >= 64)
        log(f"  batcher tallies: {dsteps} fused decode steps at 4 rows, admission slices "
            f"by bucket {allb} (fresh {fr})")
        check_counts(counts, expect(dsteps, small, big, fr), f"{what} serving")
    if not serve_alone:
        del srv
        torch.cuda.empty_cache()
        return counts
    alone = Batcher(eng, rows=4)
    try:
        for i in (i for i in Q4KM_SERVED if len(prompts[i]) in ALONE_LENGTHS):
            toks = _alone_tokens(alone, prompts[i], srv._sp({"temperature": 0.0}),
                                 SERVE_NEW)
            same = toks == results[i][0]
            log(f"  request {i} (prompt {len(prompts[i])}): alone {len(toks)} tokens, "
                f"{'the same ids' if same else 'DIFFERENT ids'} as served beside the others")
            if not same:
                raise AssertionError(f"{what} request {i}: {toks} alone, "
                                     f"{results[i][0]} served")
    finally:
        alone.shutdown()
    del srv, alone
    torch.cuda.empty_cache()
    return counts


def flavour_phase(torch, eng, read, prompt, long_prompt, n_new):
    """Phase 4f: phase 4's llama3-8b Q4_K engine (stacked; its weights do not
    depend on the flavour) under LLAMAFILE_TPU_Q4B=int8, then =planes
    (qmatmul.Q4B_KERNEL set, txn restored after). Each: Engine.generate of
    n_new greedy tokens from the 24-token prompt (int8: every q4b product
    on qmm_int8, 4 a layer and the head, at the bucket-32 prefill and each
    decode step padded to M = 8, the FFN unfused; planes: the same products
    on qmm_planes), then the 1000-token prompt's TTFT, median of 3 (the
    stacked planes kernel, row 12, for the four products of each layer; the
    head at M = 1 on the flavour's decode kernel). Under int8 also the HTTP
    server at 4 slots (serve_four: a 4-row step padded to 8 on qmm_int8).
    Launch counts exact. Returns (the counted runs' counts, the int8 decode
    step in ms)."""
    n = eng.cfg.n_layers
    steps = n_new - 1
    runs, step_ms = [], {}
    for fl, kern in (("int8", "qmm_int8"), ("planes", "qmm_planes")):
        with q4b_flavour(fl):
            _, counts, ttft, decode_s = counted_generate(torch, eng, prompt, n_new)
            want = {kern: (4 * n + 1) * (1 + steps), "flash_decode_write_stacked": n * steps}
            if fl == "planes":
                # all but the unstacked head on a stacked layer's view
                want["qmm_planes_stacked"] = 4 * n * (1 + steps)
            check_counts(counts, want, f"phase 4f {fl}")
            step_ms[fl] = decode_report(torch, read, steps, ttft, decode_s,
                                        f"24-token prompt, bucket 32, LLAMAFILE_TPU_Q4B={fl}")
            ttfts = []
            for _ in range(3):
                _, counts_b, ttft_b, _ = counted_generate(torch, eng, long_prompt, 1)
                want = {"qmm_planes": 4 * n, "qmm_planes_stacked": 4 * n, "flash_prefill": n}
                want[kern] = want.get(kern, 0) + 1
                check_counts(counts_b, want, f"phase 4f {fl}, 1000 tokens")
                ttfts.append(ttft_b * 1e3)
            log(f"  time to first token, 1000-token prompt, LLAMAFILE_TPU_Q4B={fl}: "
                f"{statistics.median(ttfts):.2f} ms (median of "
                f"{', '.join(f'{t:.2f}' for t in ttfts)} ms)")
            runs += [counts, counts_b]
            if fl == "int8":
                log("  the HTTP server on this engine under int8, 4 slots, 4 greedy requests")
                # a 4-row step padded to 8 and a slice's head at M = 1 on
                # qmm_int8; a slice's products on qmm_int8 (bucket <= 32) or
                # the stacked planes kernel (>= 64)
                expect = lambda d, small, big, fr: {
                    "paged_attention": n * d,
                    "qmm_int8": (4 * n + 1) * d + 4 * n * small + small + big,
                    "qmm_planes": 4 * n * big, "qmm_planes_stacked": 4 * n * big,
                    "flash_prefill": n * sum(c for b, c in fr.items() if b >= 128)}
                runs.append(serve_four(torch, eng, "synthetic-llama3-8b-q4k", "phase 4f int8",
                                       expect))
    return runs, step_ms["int8"]


FUSED_LENGTHS = (88, 192, 564, 1064) * 2      # the phase's prompts + 64 tokens


def _row_state(torch, eng, lengths=FUSED_LENGTHS):
    """Greedy row state for one fused chunk, a row at each of lengths (8
    rows, FUSED_LENGTHS): the penalty window, the rows' knobs, their tokens
    and positions."""
    from llamafile_tpu_torch.runtime.sampling import (PenaltyWindow, SamplingParams,
                                                      row_params_from_sp)
    dev, cfg, r = eng.device, eng.cfg, len(lengths)
    z = lambda shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    pw = PenaltyWindow(torch.zeros((r, cfg.n_vocab), device=dev), z((r, 256)), z((r,)),
                       z((r,)))
    rp = row_params_from_sp([SamplingParams(temperature=0.0)] * r, cfg.n_vocab, device=dev)
    tok = torch.full((r,), 5, dtype=torch.int32, device=dev)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return pw, rp, tok, pos


def _fused_setup(torch, eng, lengths=FUSED_LENGTHS):
    """A pool, tables and row state for one fused decode chunk, a row at
    each of lengths."""
    from llamafile_tpu_torch.runtime.paged import PageAllocator, init_paged
    dev, cfg, r, ps = eng.device, eng.cfg, len(lengths), 64
    maxp = eng.max_seq_len // ps
    pool = init_paged(cfg.n_layers, cfg.n_kv_heads, 1 + r * maxp, ps, cfg.head_dim,
                      device=dev)
    alloc = PageAllocator(1 + r * maxp, ps, r, eng.max_seq_len)
    for i, n in enumerate(lengths):
        alloc.ensure(i, n + 16)
    return (pool, alloc.device_tables(r, device=dev)) + _row_state(torch, eng, lengths)


def fused_step(torch, eng, read, lengths=FUSED_LENGTHS):
    """The batcher's fused decode over the paged pool, a row at each of
    lengths (8 rows at the phase's lengths), timed by the host clock around
    synchronized 8-step chunks, against its bound: the weights plus every
    row's K/V (bf16, the model's layers and KV heads) read once a step."""
    from llamafile_tpu_torch.server.batcher import _fused_decode_paged
    cfg, r = eng.cfg, len(lengths)
    pool, tables, pw, rp, tok, pos = _fused_setup(torch, eng, lengths)
    run = lambda: _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * r, rp, 8)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / 8 * 1e3)
    step_ms = statistics.median(times)
    kv = sum(lengths) * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    bound = (read + kv) / HBM_BYTES_PER_S * 1e3
    log(f"  fused decode step at {r} rows (lengths {lengths}): {step_ms:.3f} ms "
        f"(median of {', '.join(f'{t:.3f}' for t in times)}) against a "
        f"{bound:.3f} ms bound ({read / 1e9:.3f} GB weights + {kv / 1e9:.3f} GB KV): "
        f"{bound / step_ms:.1%}; {r / step_ms * 1e3:.1f} tokens/s over {r} rows")
    return step_ms


def fused_profile(torch, eng, step_ms):
    """Device busy share of one fused 8-row decode chunk under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from llamafile_tpu_torch.server.batcher import _fused_decode_paged
    pool, tables, pw, rp, tok, pos = _fused_setup(torch, eng)
    _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fused_decode_paged(eng, tok, pos, pool, tables, pw, [None] * 8, rp, 8)
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / 8
    if busy_ms == 0:
        log("  fused step busy share: not measured (the profiler recorded no kernels)")
        return
    log(f"  fused 8-row step: device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms step "
        f"({busy_ms / step_ms:.1%}); {n_act / 8:.1f} device activities a step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 8 / 1e3:8.4f} ms/step  {name[:90]}")


ADMIT_PROMPT = 300                # admission_profile's prompt


def admission_profile(torch, eng):
    """Where a batcher admission's time goes, on a fresh Batcher over eng:
    a fresh ADMIT_PROMPT-token prompt (one bucket-512 slice), then the same
    prompt again (299 tokens of its row reused, one token fed: a decode step,
    engine.slice_len), each with max_tokens 1, so the request is its
    admission. Each admission's host time is split into the row set-up
    (_start_admission), the slice's forward (row_prefill) and the rest of
    the slice call (the penalty window, the first token, the row written
    to its pages), every piece ended by a device sync; the device's busy
    time from torch.profiler, the host's functions from cProfile on the
    device thread. Then the one-token slice alone through row_prefill, as
    a decode step and padded to bucket 16 (the non-fresh einsum route it
    took before): the median of 3 synced runs, then one under cProfile."""
    from torch.profiler import ProfilerActivity, profile
    from llamafile_tpu_torch.runtime.engine import attn_bucket
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.server.batcher import Batcher
    ids = torch.randint(3, eng.cfg.n_vocab, (ADMIT_PROMPT,),
                        generator=torch.Generator().manual_seed(21)).tolist()
    spent, prof_py = {}, [None]

    def timed(key, outer=True):
        def wrap(orig):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if outer:                 # cProfile runs once a thread: not in row_prefill
                    prof_py[0].enable()
                try:
                    return orig(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    if outer:
                        prof_py[0].disable()
                    spent[key] = spent.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            return run
        return wrap

    def top_host(prof, n=6):
        stats = pstats.Stats(prof).stats
        return "; ".join(f"{own * 1e3:.2f} ms {calls} x {fn[:40]} ({os.path.basename(path)}:{line})"
                         for (path, line, fn), (_, calls, own, _, _) in sorted(
                             stats.items(), key=lambda kv: -kv[1][2])[:n])

    def busy(prof):
        by_name, n_act = device_kernels(prof)
        return sum(by_name.values()) / 1e3, n_act

    b = Batcher(eng, rows=2)
    try:
        for what in ("fresh", "reused"):
            spent.clear()
            prof_py[0] = cProfile.Profile()
            with patched(Batcher, "_start_admission", timed("start")), \
                    patched(Batcher, "_advance_admission", timed("slice")), \
                    patched(eng, "row_prefill", timed("forward", outer=False)), \
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                req = b.submit(ids, SamplingParams(temperature=0.0), 1)
                while (ev := req.out.get(timeout=300))[0] != "done":
                    if ev[0] == "error":
                        raise AssertionError(f"admission profile: {ev[1]}")
                torch.cuda.synchronize()
            dev_ms, n_act = busy(prof)
            rest = spent.get("slice", 0.0) - spent.get("forward", 0.0)
            log(f"  admission, {what} ({b.stats['reused_tokens']} tokens reused so far): "
                f"row set-up {spent.get('start', 0.0):.3f} ms, slice forward "
                f"{spent.get('forward', 0.0):.3f} ms, the slice's rest {rest:.3f} ms (host, "
                f"each ended by a sync); device busy {dev_ms:.3f} ms in {n_act} activities")
            log(f"    host by own time: {top_host(prof_py[0])}")
    finally:
        b.shutdown()
    # the one-token slice alone on a row cache holding the prompt's KV
    cache = eng.new_row_cache(dtype=torch.bfloat16)
    dev = eng.device
    toks = torch.zeros((1, 512), dtype=torch.int32)
    toks[0, :ADMIT_PROMPT - 1] = torch.tensor(ids[:-1], dtype=torch.int32)
    at = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    eng.row_prefill(toks.to(dev), at(0), cache, fresh=True, last_idx=at(ADMIT_PROMPT - 2))
    pos0 = ADMIT_PROMPT - 1
    for t_len in (1, 16):
        one = torch.zeros((1, t_len), dtype=torch.int32)
        one[0, 0] = ids[-1]
        one = one.to(dev)
        alen = attn_bucket(pos0 + t_len + 1, eng.max_seq_len)
        run = lambda: eng.row_prefill(one, at(pos0), cache, attn_len=alen, last_idx=at(0))
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prof_py[0] = cProfile.Profile()
        prof_py[0].enable()
        run()
        torch.cuda.synchronize()
        prof_py[0].disable()
        log(f"  one-token slice at pos {pos0}, T = {t_len} "
            f"({'a decode step' if t_len == 1 else 'bucket 16, the einsum'}): "
            f"{statistics.median(times):.3f} ms (median of "
            f"{', '.join(f'{x:.3f}' for x in times)})")
        log(f"    host by own time: {top_host(prof_py[0])}")
    del cache
    torch.cuda.empty_cache()


def device_kernels(prof):
    """(device time in us by kernel name, number of device activities)."""
    from torch.autograd import DeviceType
    by_name, n_act = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            n_act += 1
    return by_name, n_act


def prefill_profile(torch, eng, prompt):
    """Device time by kernel of one prefill, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    cache = eng.new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.prefill(cache, prompt)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3
    if busy_ms == 0:
        log("  prefill device time: not measured (the profiler recorded no kernels)")
        return
    log(f"  prefill under the profiler: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, "
        f"{n_act} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3:8.4f} ms  {name[:90]}")


PROFILE_STEPS = 2                 # decode steps a profiled chunk (device_busy)


def device_busy(torch, eng, prompt, sp, step_ms):
    """Kernel time of one PROFILE_STEPS-step decode chunk from a profiler
    trace, against the unprofiled step time: the device's busy share of a
    decode step; then the host's time by function over as many steps."""
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_STEPS
    cache = eng.new_cache()
    last, cache = eng.prefill(cache, prompt)
    tok = last.argmax()[None].to(torch.int32)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=tok.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.decode(tok, pos, cache, None, sp, n, attn_len=256)
        torch.cuda.synchronize()
    by_name, n_act = device_kernels(prof)
    busy_ms = sum(by_name.values()) / 1e3 / n
    if busy_ms == 0:
        log("  device busy share: not measured (the profiler recorded no kernels)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  device busy {busy_ms:.3f} ms of a {step_ms:.3f} ms decode step "
        f"({busy_ms / step_ms:.1%}); idle {1 - busy_ms / step_ms:.1%}")
    fdw = sum(us for name, us in by_name.items() if "fdw_kernel" in name)
    if fdw:
        log(f"  flash_decode_write: {fdw / n / 1e3:.4f} ms/step of device time")
    log(f"  {n_act / n:.1f} device activities (kernels, copies, fills) a step: "
        f"{step_ms * 1e3 / (n_act / n):.1f} us of step time each")
    for name, us in top:
        log(f"    {us / n / 1e3:8.4f} ms/step  {name[:90]}")
    # the host side: the next n steps under cProfile, by function's own time
    prof_py = cProfile.Profile()
    t0 = time.perf_counter()
    prof_py.enable()
    eng.decode(tok, pos, cache, None, sp, n, attn_len=256)
    torch.cuda.synchronize()
    prof_py.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    stats = pstats.Stats(prof_py).stats
    log(f"  host time by function, cProfile on ({wall_ms:.3f} ms a step with it):")
    for (path, line, fn), (_, calls, own, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"    {own / n * 1e3:8.4f} ms/step {calls / n:7.1f} calls  "
            f"{fn[:60]} ({os.path.basename(path)}:{line})")



EOG_PIECE = 128001         # the grammar tokenizer's end-of-generation piece
# an item is one "<1dd>" piece of grammar_tokenizer, or its bytes one by one
ITEM = 'item ::= "<1" [0-9] [0-9] ">"'
ITEMS_RE = r"(<1\d\d>){0,8}(<(1(\d\d?)?)?)?"      # a prefix of GRAMMAR_8's language
GRAMMAR_8 = "root ::= " + " ".join(["item"] * 8) + "\n" + ITEM
GRAMMAR_LIST = 'root ::= "[" item ' + " ".join(['"," item'] * 5) + "\n" + ITEM
JSON_SCHEMA = {"type": "object", "properties": {"n": {"type": "integer"}}}
MU_TOL = 1e-5              # mirostat's mu, card against CPU on the same logits
STATEFUL_CASES = (
    ("penalties", dict(temperature=0.8, top_k=40, repeat_penalty=1.3,
                       presence_penalty=0.5, seed=11)),
    ("mirostat v2 with penalties", dict(mirostat=2, repeat_penalty=1.3,
                                        presence_penalty=0.5, seed=12)),
    ("mirostat v1", dict(mirostat=1, seed=13)))


@functools.lru_cache(maxsize=1)
def grammar_tokenizer(n_vocab):
    """A Tokenizer made from metadata with n_vocab pieces: 256 single-byte
    pieces (ids 0-255, so JSON can be spelled), one end-of-generation piece
    (EOG_PIECE, a control piece of no text), and "<t>" for every other id t
    (the text Tokenizer({}) gives an id), so "<1dd>" is one piece. Made
    once: phase 3 and phase 13 share it, and its grammar trie."""
    from llamafile_tpu_torch.runtime.tokenizer import (TOKEN_TYPE_BYTE, TOKEN_TYPE_CONTROL,
                                                       TOKEN_TYPE_NORMAL, Tokenizer)
    tokens = [f"<0x{i:02X}>" for i in range(256)] + [f"<{t}>" for t in range(256, n_vocab)]
    types = [TOKEN_TYPE_BYTE] * 256 + [TOKEN_TYPE_NORMAL] * (n_vocab - 256)
    tokens[EOG_PIECE], types[EOG_PIECE] = "<|eot_id|>", TOKEN_TYPE_CONTROL
    return Tokenizer({"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
                      "tokenizer.ggml.token_type": types,
                      "tokenizer.ggml.eos_token_id": EOG_PIECE})


def small_engine(torch, dev, tokenizer=None):
    """Two layers of llama3-8b width, Q4_K fused and stacked, on the card."""
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    cfg, params = make_synthetic_llama("llama3-8b-2l", "Q4_K", seed=1, fuse=True, device=dev)
    return Engine(cfg, params, tokenizer or Tokenizer({}), max_seq_len=1024, device=dev)


@contextlib.contextmanager
def patched(obj, name, make):
    """obj.name replaced by make(original) while the block runs."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def stateful_sampling_check(torch, dev, n_new=10):
    """Engine.generate on the card at two layers of llama3-8b width with
    penalties (repeat 1.3, presence 0.5, sampled at 0.8, top-k 40), with
    mirostat v2 over the same penalties and with mirostat v1: every draw's
    Gumbel noise comes from one CPU generator and goes to the card, and
    every call of the sampler is recorded (its logits, penalty counts, token
    and new mu). The CPU then runs the plain chain on the card's logits with
    the same noise, carrying its own penalty window and mu from its own
    tokens: the same token at every step, the same counts, mu within
    MU_TOL."""
    import llamafile_tpu_torch.runtime.engine as E
    from llamafile_tpu_torch.runtime import sampling as S
    eng = small_engine(torch, dev)
    v = eng.cfg.n_vocab
    prompt = torch.randint(3, v, (24,), generator=torch.Generator().manual_seed(2)).tolist()
    for what, kw in STATEFUL_CASES:
        sp = S.SamplingParams(**kw)
        rec, drawn = [], []
        g = torch.Generator().manual_seed(1234)

        def noise(shape, gen, device):
            u = torch.rand(shape, generator=g)
            drawn.append(-torch.log(-torch.log(u.clamp(min=1e-20))))
            return drawn[-1].to(device)

        def recording(orig):
            def run(logits, gen, sp_, counts, mu):
                tok, mu2 = orig(logits, gen, sp_, counts, mu)
                # copies: the engine pushes its window into counts in place
                rec.append((logits.float().cpu().clone(),
                            None if counts is None else counts.cpu().clone(),
                            int(tok[0]), None if mu2 is None else mu2.cpu().clone()))
                return tok, mu2
            return run
        with patched(S, "_gumbel", lambda _: noise), \
                patched(E, "sample_stateful", recording):
            toks = [t for t, _ in eng.generate("", max_tokens=n_new, sampling=sp,
                                               stop_on_eog=False, prompt_ids=prompt)]
        if toks != [r[2] for r in rec] or len(toks) != n_new:
            raise AssertionError(f"{what}: {toks} emitted, {[r[2] for r in rec]} drawn")
        pw = (S.penalty_window_init(prompt, v, sp.penalty_last_n, device="cpu")
              if sp.penalized else None)
        mu = S.mirostat_init(sp, 1, device="cpu") if sp.mirostat else None
        replay = iter(drawn)
        worst = 0.0
        with patched(S, "_gumbel", lambda _: lambda shape, gen, device: next(replay)):
            for i, (logits, counts, tok, mu_card) in enumerate(rec):
                if pw is not None and not torch.equal(pw.counts, counts):
                    raise AssertionError(f"{what} step {i}: penalty counts differ")
                t_cpu, mu = S.sample_stateful(logits, None, sp,
                                              pw.counts if pw is not None else None, mu)
                if int(t_cpu[0]) != tok:
                    raise AssertionError(f"{what} step {i}: card {tok}, cpu {int(t_cpu[0])}")
                if mu is not None:
                    worst = max(worst, (mu - mu_card).abs().max().item())
                if pw is not None:
                    S.penalty_window_push(pw, t_cpu)
        mus = " ".join(f"{r[3][0].item():.4f}" for r in rec) if sp.mirostat else "-"
        log(f"  {what}: {n_new} tokens, the same at every step on the card and the CPU "
            f"({len(drawn)} noise draws); mu {mus}; max |mu card - mu cpu| = {worst:.3g} "
            f"(tol {MU_TOL})")
        if worst > MU_TOL:
            raise AssertionError(f"{what}: mu parts by {worst}")
    del eng
    torch.cuda.empty_cache()


def grammar_path_check(torch, dev):
    """The server's grammar path (`_generate_grammar_sync`: Engine.prefill,
    one M = 1 forward a token, the mask sent as packed bits and unpacked on
    the card) at two layers of llama3-8b width over grammar_tokenizer's
    128256 pieces: a greedy decode of 12 tokens under GRAMMAR_LIST (a
    bracket and six comma-separated items, an item one piece or up to five
    single-byte ones). Each step's
    host mask, logits and device-masked logits are recorded; the CPU then
    walks the same grammar: its masks equal the card's host masks, the
    card's device mask keeps exactly the allowed tokens; and the plain
    model on the CPU, one fresh prefill over the prompt and the card's
    tokens, gives logits within 2e-2 of the card's (relative to their max)
    whose greedy choice under the CPU's mask is the card's token at every
    step."""
    import numpy as np
    import llamafile_tpu_torch.models.llama as M
    import llamafile_tpu_torch.runtime.engine as E
    from llamafile_tpu_torch.runtime import grammar as G
    from llamafile_tpu_torch.runtime import sampling as S
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    tok = grammar_tokenizer(128256)
    eng = small_engine(torch, dev, tok)
    srv = Server(Flags(model="synthetic-llama3-8b-2l", slots=1, temp=0.0), eng)
    masks, logits, masked, out = [], [], [], []

    def rec_fwd(orig):
        def run(*a, **kw):
            lg, cache = orig(*a, **kw)
            logits.append(lg[0, -1].float().cpu())
            return lg, cache
        return run

    def rec_mask(orig):
        def run(self):
            masks.append(orig(self))
            return masks[-1]
        return run

    def rec_sample(orig):
        def run(lg, gen, sp, counts=None):
            masked.append(lg[0].cpu())
            return orig(lg, gen, sp, counts)
        return run
    sp = S.SamplingParams(temperature=0.0)
    prompt = torch.randint(256, 128256, (24,), generator=torch.Generator().manual_seed(5)).tolist()
    try:
        with patched(M, "forward", rec_fwd), patched(E, "forward", rec_fwd), \
                patched(G.GrammarSampler, "allowed_tokens", rec_mask), \
                patched(S, "sample", rec_sample):
            usage = srv._generate_grammar_sync(prompt, sp, 12, out.append,
                                               G.Grammar.from_gbnf(GRAMMAR_LIST))
    finally:
        srv.shutdown()
    toks = [o["token"] for o in out]
    text = "".join(o["piece"] for o in out)
    if len(toks) != 12 and usage["finish_reason"] != "stop":
        raise AssertionError(f"grammar path gave {text!r} ({usage})")
    # the plain model on the CPU: one fresh prefill over the prompt and the
    # card's tokens gives every step's logits
    seq = prompt + toks[:-1]
    cpu_tokens = torch.zeros((1, E.bucket_len(len(seq))), dtype=torch.int64)
    cpu_tokens[0, :len(seq)] = torch.tensor(seq)
    cache = M.init_cache(eng.cfg, 1, cpu_tokens.shape[1], "bf16", device="cpu")
    plain, _ = M.forward(_to(eng.params, "cpu"), eng.cfg, cpu_tokens,
                         torch.zeros(1, dtype=torch.int32), cache, fresh_prefill=True)
    plain = plain[0, len(prompt) - 1:len(seq)].float()
    gs = G.GrammarSampler(G.Grammar.from_gbnf(GRAMMAR_LIST), tok)
    worst = 0.0
    for i, t in enumerate(toks):
        want = gs.allowed_tokens()
        if not np.array_equal(want, masks[i]):
            raise AssertionError(f"grammar step {i}: the host masks differ")
        keep = torch.from_numpy(want)
        if not torch.equal(masked[i] > -1e29, keep):
            raise AssertionError(f"grammar step {i}: the device mask keeps other tokens")
        rel = ((logits[i] - plain[i]).abs().max() / plain[i].abs().max()).item()
        worst = max(worst, rel)
        t_cpu = int(torch.where(keep, plain[i], torch.tensor(-1e30)).argmax())
        if t_cpu != t or rel > 2e-2:
            raise AssertionError(f"grammar step {i}: card {t}, cpu plain {t_cpu}, max |diff| "
                                 f"/ max |logit| = {rel:.3g} (limit 2e-2)")
        gs.accept(t)
    log(f"  grammar path: {text} ({len(toks)} tokens, {usage['finish_reason']}); masks "
        f"equal at every step ({', '.join(str(int(m.sum())) for m in masks)} tokens "
        f"allowed), the device mask the CPU's; the CPU's plain model over the same "
        f"tokens makes the same greedy choice at every step, logits within {worst:.3g} "
        f"of its max (limit 2e-2)")
    del eng, srv
    torch.cuda.empty_cache()


def linear_mask(gs):
    """gs's allowed-token mask as the reference computes it
    (llamafile_tpu/runtime/grammar.py:346-363): every piece's text tried
    from the live stacks, codepoint by codepoint."""
    import numpy as np
    from llamafile_tpu_torch.runtime.grammar import _token_text
    mask = np.zeros(gs.tok.n_vocab, bool)
    live = [st for st in gs.stacks if st]
    for tid, data in enumerate(gs._token_bytes):
        cur, text = live, _token_text(data) if data else ""
        for ch in text:
            cur = gs._advance_cp(cur, ord(ch))
            if not cur:
                break
        mask[tid] = bool(text and cur)
    if any(len(st) == 0 for st in gs.stacks):
        mask[list(gs.tok.eog_ids)] = True
    return mask


def _completion(base, body, path="/v1/completions"):
    """One non-streamed request; the response's JSON (an HTTP error raises)."""
    import urllib.request
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return json.loads(r.read())


def _reused_metric(base):
    import urllib.request
    text = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
    return int(re.search(r"llamafile_tpu_prefix_tokens_reused_total (\d+)", text).group(1))


NPZ_LAYERS = 4             # npz_report's slice of the saved row


def npz_report(tmp, path):
    """Write time of np.savez (the port's) and np.savez_compressed (the JAX
    package's) on the same NPZ_LAYERS layers of a saved row, and the port's
    load_state of each file: the same history and K/V."""
    import numpy as np
    from llamafile_tpu_torch.runtime.state import load_state
    z = dict(np.load(path))
    part = {k: (a[:NPZ_LAYERS] if k.startswith("leaf") else a) for k, a in z.items()}
    mb = sum(a.nbytes for k, a in part.items() if k.startswith("leaf")) / 1e6
    out, loaded = {}, []
    for save in (np.savez, np.savez_compressed):
        f = os.path.join(tmp, f"{save.__name__}.npz")
        t = time.perf_counter()
        save(f, **part)
        out[save.__name__] = ((time.perf_counter() - t) * 1e3, os.path.getsize(f))
        loaded.append(load_state(f))
    (c0, h0), (c1, h1) = loaded
    same = h0 == h1 and all(bool((a == b).all()) for a, b in ((c0.k, c1.k), (c0.v, c1.v)))
    log(f"  the row's {NPZ_LAYERS} first layers ({mb:.1f} MB of bf16 K/V): " + ", ".join(
        f"{name} {ms:.1f} ms ({mb / ms * 1e3:.1f} MB/s), {size} bytes"
        for name, (ms, size) in out.items()) + f"; load_state of both {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("phase 13: the compressed and plain files load differently")


def state_phase(torch, eng, prompt, step_q4):
    """Phase 13 on phase 4's engine (llama3-8b Q4_K, 32 layers), given
    grammar_tokenizer's 128256 pieces, under an HTTP server with 8 slots and
    --state-dir: a GRAMMAR_8 request and a json_schema request (JSON_SCHEMA)
    of up to 16 tokens, each alone (launches exact: the prefill at bucket
    32, one M = 1 forward a token), then together beside 4 plain greedy
    requests (launches not counted: two threads launch), every text equal
    to its own alone (the plain ones alone on a fresh batcher: served again
    on the same server they would reuse their rows' prefixes, whose other
    prefill route parts in numerics); then a 300-token greedy request twice (the second
    reuses the row's prefix), its row saved (npz_report), erased and
    restored, and the prompt again: prefix_reused rises by 299 or more, its
    text equals the reuse without the restore and its TTFT is below the
    fresh request's. Then Engine.generate of 64 tokens with mirostat v2 and
    penalties (launches as phase 4's), and a 300-token prompt twice with a
    prompt_cache file (the second feeds one token, a decode step). Returns
    the counted runs' launch counts."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime import grammar as G
    from llamafile_tpu_torch.runtime import state as ST
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.server.batcher import Batcher
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    n, v = eng.cfg.n_layers, eng.cfg.n_vocab
    decode = lambda steps: {"qmm_txn_m1": 65 * steps, "qmm_moe_m1": 64 * steps,
                            "flash_decode_write_stacked": n * steps}
    plus = lambda a, b: {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}
    runs = []
    held_tok = eng.tokenizer
    t0 = time.perf_counter()
    eng.tokenizer = grammar_tokenizer(v)
    t1 = time.perf_counter()
    G._vocab(eng.tokenizer)
    t2 = time.perf_counter()
    log(f"  card: {nvidia_smi()}")
    log(f"  tokenizer of {v} pieces in {(t1 - t0) * 1e3:.1f} ms, the grammar trie of its "
        f"texts in {(t2 - t1) * 1e3:.1f} ms (both made once: 0 if phase 3 made them)")
    for what, grammar in (("item x 8", G.Grammar.from_gbnf(GRAMMAR_8)),
                          ("json_schema", G.Grammar.from_json_schema(JSON_SCHEMA))):
        gs = G.GrammarSampler(grammar, eng.tokenizer)
        t = time.perf_counter()
        trie = gs.allowed_tokens()
        t_trie = time.perf_counter() - t
        t = time.perf_counter()
        every = linear_mask(gs)
        t_every = time.perf_counter() - t
        log(f"  first mask of {what}: the trie walk {t_trie * 1e3:.3f} ms, every piece tried "
            f"(the reference's loop) {t_every * 1e3:.1f} ms; "
            f"{'equal' if np.array_equal(trie, every) else 'DIFFERENT'} ({int(trie.sum())} "
            "pieces allowed)")
        if not np.array_equal(trie, every):
            raise AssertionError(f"phase 13: the trie's mask of {what} parts from the loop's")
    mask_s = []

    def timed_mask(orig):
        def run(self):
            t = time.perf_counter()
            m = orig(self)
            mask_s.append(time.perf_counter() - t)
            return m
        return run
    tmp = tempfile.TemporaryDirectory()
    srv = Server(Flags(model="synthetic-llama3-8b-q4k", slots=8, temp=0.0,
                       state_dir=tmp.name), eng)
    body = lambda ids, **kw: {"prompt": ids, "max_tokens": 16, "temperature": 0.0, **kw}
    constrained = (("grammar item x 8", {"grammar": GRAMMAR_8}),
                   ("json_schema", {"response_format": {"type": "json_schema", "json_schema": {
                       "name": "n", "schema": JSON_SCHEMA}}}))
    gen = torch.Generator().manual_seed(13)
    plain = [torch.randint(256, v, (length,), generator=gen).tolist()
             for length in (24, 64, 128, 200)]
    try:
        with running_server(srv) as base, patched(G.GrammarSampler, "allowed_tokens",
                                                  timed_mask):
            _completion(base, body(prompt, grammar=GRAMMAR_8))       # warm-up
            _completion(base, body(torch.randint(256, v, (40,), generator=gen).tolist()))
            alone = {}
            for what, extra in constrained:
                mask_s.clear()
                torch.cuda.synchronize()
                reset_launch_counts()
                t = time.perf_counter()
                out = _completion(base, body(prompt, **extra))
                wall = time.perf_counter() - t
                counts = launch_counts()
                u, text = out["usage"], out["choices"][0]["text"]
                k = u["completion_tokens"]
                # one forward after each token but the last, unless EOG
                # ended the request (sampled by a forward after the last):
                # the item grammar ends by max_tokens or complete with no
                # live stack, the JSON one also by EOG (JSON is spelled in
                # single-byte pieces, so the host replays its text)
                steps = k - 1
                if what == "json_schema" and out["choices"][0]["finish_reason"] == "stop":
                    gs = G.GrammarSampler(G.Grammar.from_json_schema(JSON_SCHEMA),
                                          eng.tokenizer)
                    for t in text.encode():
                        gs.accept(t)
                    steps = k if any(len(st) for st in gs.stacks) else k - 1
                check_counts(counts, plus({"qmm_txn": 4 * n, "qmm_txn_m1": 1}, decode(steps)),
                             f"phase 13 {what} alone")
                runs.append(counts)
                ok = (re.fullmatch(ITEMS_RE, text) if what.startswith("grammar")
                      else re.fullmatch(r'\{ ?"n" ?: ?-?\d*[ }]*', text))
                if not ok or (what == "json_schema" and text.rstrip().endswith("}")
                              and not isinstance(json.loads(text)["n"], int)):
                    raise AssertionError(f"phase 13 {what}: {text!r} breaks its grammar")
                alone[what] = text
                step_ms = (wall * 1e3 - u["ttft_ms"]) / max(1, steps)
                log(f"  {what} alone: {text!r} ({k} tokens, {out['choices'][0]['finish_reason']}); "
                    f"mask {sum(mask_s) / len(mask_s) * 1e3:.3f} ms a token over {v} pieces "
                    f"({len(mask_s)} masks); TTFT {u['ttft_ms']:.2f} ms; {step_ms:.3f} ms a "
                    f"constrained step against phase 4's {step_q4:.3f} ms a decode step")
            # no row holds a prefix of the plain prompts (random ids: their
            # first tokens differ), so each admission prefills fresh
            reused0 = srv.batcher.stats["reused_tokens"]
            with ThreadPoolExecutor(6) as ex:
                futs = ([(w, ex.submit(_completion, base, body(prompt, **x))) for w, x in constrained]
                        + [(len(ids), ex.submit(_completion, base, body(ids))) for ids in plain])
                together = {w: f.result()["choices"][0]["text"] for w, f in futs}
            if srv.batcher.stats["reused_tokens"] != reused0:
                raise AssertionError("phase 13: a plain request reused another's prefix")
            # the plain ones alone, one after another on a fresh batcher
            fresh = Batcher(eng, rows=8)
            try:
                for ids in plain:
                    req = fresh.submit(ids, SamplingParams(temperature=0.0), 16)
                    got = []
                    while (ev := req.out.get(timeout=900))[0] != "done":
                        if ev[0] == "error":
                            raise AssertionError(f"phase 13 alone: {ev[1]}")
                        got.append(ev[1])
                    alone[len(ids)] = "".join(eng.tokenizer.decode_token(t).decode(
                        "utf-8", errors="replace") for t in got)
            finally:
                fresh.shutdown()
            bad = [w for w in together if together[w] != alone[w]]
            log(f"  2 constrained requests beside 4 plain greedy ones (prompts "
                f"{[len(p) for p in plain]}): {'each text as alone' if not bad else bad}")
            if bad:
                raise AssertionError(f"phase 13: {bad} differ served together from alone")
            # slot save / erase / restore
            long = torch.randint(256, v, (300,), generator=gen).tolist()
            first = _completion(base, body(long))
            reuse = _completion(base, body(long))        # the reuse without a restore
            row = next(i for i, r in enumerate(srv.batcher.rows) if r.history[:300] == long)
            t = time.perf_counter()
            saved = _completion(base, {"filename": "row.npz"}, f"/slots/{row}?action=save")
            save_ms = (time.perf_counter() - t) * 1e3
            size = os.path.getsize(os.path.join(tmp.name, "row.npz"))
            npz_report(tmp.name, os.path.join(tmp.name, "row.npz"))
            t = time.perf_counter()
            _completion(base, {}, f"/slots/{row}?action=erase")
            erase_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            restored = _completion(base, {"filename": "row.npz"}, "/slots/0?action=restore")
            restore_ms = (time.perf_counter() - t) * 1e3
            m0 = _reused_metric(base)
            again = _completion(base, body(long))
            reused = _reused_metric(base) - m0
            texts = [r["choices"][0]["text"] for r in (first, reuse, again)]
            ttfts = [r["usage"]["ttft_ms"] for r in (first, reuse, again)]
            log(f"  slots: row {row} saved ({saved['tokens']} tokens, {size} bytes) in "
                f"{save_ms:.1f} ms, erased in {erase_ms:.1f} ms, restored into row "
                f"{restored['row']} in {restore_ms:.1f} ms; the prompt again reused "
                f"{reused} tokens (prefix_reused); TTFT {ttfts[0]:.2f} ms fresh, "
                f"{ttfts[1]:.2f} ms reused, {ttfts[2]:.2f} ms after the restore; text after "
                f"the restore {'=' if texts[2] == texts[1] else '!='} the reuse without it, "
                f"{'=' if texts[2] == texts[0] else '!='} the fresh one")
            if reused < 299 or texts[2] != texts[1]:
                raise AssertionError("phase 13: the restored row was not reused as saved")
            # the TTFT gate on medians of three: two more fresh 300-token
            # admissions (random ids: no row holds a prefix of them) and two
            # more restores, each after the rows holding the prompt are erased
            fresh_ms, restored_ms = [ttfts[0]], [ttfts[2]]
            for _ in range(2):
                m0 = _reused_metric(base)
                other = torch.randint(256, v, (300,), generator=gen).tolist()
                fresh_ms.append(_completion(base, body(other))["usage"]["ttft_ms"])
                if _reused_metric(base) != m0:
                    raise AssertionError("phase 13: a fresh 300-token prompt reused a prefix")
                for r, held in enumerate(srv.batcher.rows):
                    if held.history[:300] == long:
                        _completion(base, {}, f"/slots/{r}?action=erase")
                _completion(base, {"filename": "row.npz"}, "/slots/0?action=restore")
                m0 = _reused_metric(base)
                out = _completion(base, body(long))
                if _reused_metric(base) - m0 < 299 or out["choices"][0]["text"] != texts[1]:
                    raise AssertionError("phase 13: a restored row was not reused as saved")
                restored_ms.append(out["usage"]["ttft_ms"])
            med_f, med_r = statistics.median(fresh_ms), statistics.median(restored_ms)
            log(f"  TTFT at 300 tokens: fresh {', '.join(f'{t:.2f}' for t in fresh_ms)} ms "
                f"(median {med_f:.2f}), after a restore "
                f"{', '.join(f'{t:.2f}' for t in restored_ms)} ms (median {med_r:.2f})")
            if med_r >= med_f:
                raise AssertionError(f"phase 13: median TTFT after a restore {med_r:.2f} ms, "
                                     f"not below the fresh median {med_f:.2f} ms")
        # Engine.generate: mirostat v2 and the penalty window, 64 tokens
        sp = SamplingParams(mirostat=2, repeat_penalty=1.3, presence_penalty=0.5, seed=3)
        toks, counts, ttft, decode_s = counted_generate(torch, eng, prompt, 64, sp)
        check_counts(counts, plus({"qmm_txn": 4 * n, "qmm_txn_m1": 1}, decode(63)),
                     "phase 13 mirostat and penalties")
        runs.append(counts)
        log(f"  Engine.generate, mirostat v2 with penalties: {63 / decode_s:.2f} tok/s "
            f"({decode_s / 63 * 1e3:.3f} ms a step) against phase 4's greedy "
            f"{1e3 / step_q4:.2f} tok/s ({step_q4:.3f} ms); {len(set(toks))} distinct of 64")
        # --prompt-cache: a 300-token prompt twice
        path = os.path.join(tmp.name, "session.npz")
        spent = {"save": [], "load": []}

        def timed(kind):
            def wrap(orig):
                def run(*a, **kw):
                    t = time.perf_counter()
                    r = orig(*a, **kw)
                    spent[kind].append((time.perf_counter() - t) * 1e3)
                    return r
                return run
            return wrap
        greedy = SamplingParams(temperature=0.0)
        cache_runs = []
        with patched(ST, "save_state", timed("save")), patched(ST, "load_state", timed("load")):
            for i in range(2):
                torch.cuda.synchronize()
                reset_launch_counts()
                t = time.perf_counter()
                got, t_first = [], None
                for tid, _ in eng.generate("", max_tokens=8, sampling=greedy, stop_on_eog=False,
                                           prompt_ids=long, prompt_cache=path):
                    t_first = t_first or time.perf_counter()
                    got.append(tid)
                counts = launch_counts()
                cache_runs.append((got, (t_first - t) * 1e3, eng.last_prompt_reuse))
                # run 2 feeds one token past the kept 299: a decode step
                pre = (plus({"qmm_dequant": 4 * n, "flash_prefill": n}, {"qmm_txn_m1": 1})
                       if i == 0 else decode(1))
                check_counts(counts, plus(pre, decode(7)), f"phase 13 prompt_cache run {i + 1}")
                runs.append(counts)
        (a, ttft_a, keep_a), (b, ttft_b, keep_b) = cache_runs
        log(f"  prompt_cache, 300-token prompt: run 1 prefilled 300 (kept {keep_a}), TTFT "
            f"{ttft_a:.2f} ms with the save {spent['save'][0]:.1f} ms "
            f"({os.path.getsize(path)} bytes); run 2 kept {keep_b} and prefilled "
            f"{300 - keep_b}, TTFT {ttft_b:.2f} ms with the load {spent['load'][0]:.1f} ms "
            f"and the save {spent['save'][1]:.1f} ms; tokens "
            f"{'the same' if a == b else 'not the same'}")
        if keep_a != 0 or keep_b != 299:
            raise AssertionError("phase 13: prompt_cache did not resume")
    finally:
        eng.tokenizer = held_tok
        tmp.cleanup()
    return runs


def phase3_checks():
    """Phase 3's checks: (what, check, args, kwargs, q4b flavour)."""
    # each check runs its CPU side through the plain versions at two layers
    # of full width: its depth (decode steps, prompts) is cut to what drives
    # and holds each route once; the bucket-512 grouped MoE prefill
    # (qmm_planes_g) is held on the Q4_K_M Mixtral, the planes flavour's
    # bucket-512 prefill (qmm_planes, stacked) under int8, which runs the
    # same kernel there
    mix = dict(preset="mixtral-8x7b-2l", n_decode=1)
    return (
        # the sampling state Engine.generate carries (the penalty window,
        # mirostat's mu) and the server's grammar path, on the card's logits
        ("penalties and mirostat in Engine.generate", stateful_sampling_check, (), {},
         "txn"),
        ("grammar-constrained decode", grammar_path_check, (), {}, "txn"),
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "txn"),
        ("Q4_K, 300-token prompt", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1), "txn"),
        ("Q4_K, 300-token prompt, int8 prefill", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1, i8p=True), "txn"),
        ("head_dim 64 (TinyLlama widths)", head_dim_64_check, (), dict(n_decode=2), "txn"),
        ("Llama-3.2-3B widths (G = 3)", decode_model_check, (), dict(n_decode=1), "txn"),
        # head_dim 256: flash_decode_write, flash_decode and
        # paged_attention at D = 256 on a model's path
        ("head_dim 256 (Gemma-2B widths, G = 8)", decode_model_check, (),
         dict(preset="gemma-2b-widths-2l", n_decode=1, paged_prompts=(24, 200)), "txn"),
        # gemma2 at Gemma-2-9B's widths: the window and softcap of
        # flash_decode_write (stacked, bf16) and flash_decode (unrolled,
        # int8) on the model's path, against the plain versions on the card
        ("Gemma-2-9B widths (gemma2)", gemma_path_check, (), {}, "txn"),
        # gemma at Gemma-7B's widths (16 over 16 heads at D = 256: a head
        # group of 1 in flash_prefill and the decode kernels), then through
        # the HTTP server (paged_attention at 16/16); gemma3 at
        # Gemma-3-27B's (K = 5376 and 21504; the window of 1024 on five
        # layers of six: all six on flash_prefill at 600 tokens, past the
        # window at 1100)
        ("Gemma-7B widths (gemma)", gemma_path_check, (),
         dict(preset="gemma-7b-2l", prompts=(24, 300), recipes=(("Q4_K", "bf16"),),
              max_len=2048, serve=True), "txn"),
        ("Gemma-3-27B widths (gemma3)", gemma_path_check, (),
         dict(preset="gemma-3-27b-6l", prompts=(24, 600, 1100), n_decode=2, max_len=2048),
         "txn"),
        # qwen2 at Qwen2.5-7B's widths (q/k/v biases, G = 7, gate|up
        # concatenated) and qwen3 at Qwen3-32B's (q/k norms, G = 8, H * D != d,
        # the fused FFN), stacked bf16 and Q4_K_M unrolled int8, then the HTTP
        # server at 4 slots: the paged decode with biases and with q/k norms
        ("Qwen2.5-7B widths (qwen2)", gemma_path_check, (),
         dict(preset="qwen2.5-7b-2l", prompts=(24, 300), n_decode=2, max_len=2048,
              serve=True, vocab_hi=150000), "txn"),
        ("Qwen3-32B widths (qwen3)", gemma_path_check, (),
         dict(preset="qwen3-32b-2l", prompts=(24, 300), n_decode=2, max_len=2048,
              serve=True, vocab_hi=150000), "txn"),
        # the LayerNorm families, unrolled: Pythia-6.9B's widths (a fused
        # qkv with its bias, rope on 32 of 128 dims, the parallel residual
        # with an FFN norm: flash_prefill and flash_decode_write at D =
        # 128) and Phi-2's (head_dim 80: every attention on the einsum; a
        # shared norm, the head's bias), Q4_K, prompts of 24 and 300 tokens
        # (qmm_planes, rounded to bf16 once the bias term is in); Falcon-7B's
        # (71 query heads over 1 KV head of 64: flash_prefill at G = 71, D =
        # 64; K = 4544: every product on the dequant GEMM), Q8_0; then a Q4_K
        # prefill from 256 rows against the exact product (planes_exact_check)
        ("Pythia-6.9B widths (gptneox)", gemma_path_check, (),
         dict(preset="pythia-6.9b-2l", prompts=(24, 300), n_decode=2, max_len=2048,
              recipes=(("Q4_K", "bf16"),), vocab_hi=50000), "txn"),
        ("Phi-2 widths (phi2)", gemma_path_check, (),
         dict(preset="phi-2-2l", prompts=(24, 300), n_decode=2, max_len=2048,
              recipes=(("Q4_K", "bf16"),), vocab_hi=50000), "txn"),
        ("Falcon-7B widths (falcon)", gemma_path_check, (),
         dict(preset="falcon-7b-2l", prompts=(24, 300), n_decode=2, max_len=2048,
              recipes=(("Q8_0", "bf16"),), vocab_hi=50000), "txn"),
        ("q4b planes from 256 rows against the exact product, Pythia-6.9B widths",
         planes_exact_check, (), {}, "txn"),
        ("Q8_0", whole_path_check, ("Q8_0",), dict(n_prompt=24, n_decode=1), "txn"),
        ("paged decode, 4 rows", paged_path_check, (), dict(n_decode=1), "txn"),
        ("Q4_K_M", whole_path_check, ("Q4_K_M",), dict(n_prompt=300, n_decode=1), "txn"),
        ("int8 KV", whole_path_check, ("Q4_K",),
         dict(n_prompt=32, n_decode=1, kv_dtype="int8"), "txn"),
        # --kv-dtype f16 and f32: flash_decode_write's f16 and f32 instances
        # on the whole path (the prefill's rows written in the cache's dtype)
        ("f16 KV", whole_path_check, ("Q4_K",),
         dict(n_prompt=32, n_decode=1, kv_dtype="f16"), "txn"),
        ("f32 KV", whole_path_check, ("Q4_K",),
         dict(n_prompt=32, n_decode=1, kv_dtype="f32"), "txn"),
        ("Mixtral Q4_K stacked", moe_path_check, ("Q4_K",),
         dict(runs=((24, 1),)), "txn"),
        ("Mixtral Q4_K_M unrolled", moe_path_check, ("Q4_K_M",),
         dict(runs=((300, 1),)), "txn"),
        ("Mixtral paged decode, 4 rows", paged_path_check, (),
         dict(prompts=(24, 64, 200, 300), **mix), "txn"),
        ("Mixtral paged decode, 8 rows", paged_path_check, (),
         dict(prompts=(24, 64, 200, 300) * 2, **mix), "txn"),
        # the q4b flavours (LLAMAFILE_TPU_Q4B): int8 runs qmm_int8 at
        # padded M <= 32 and the stacked planes kernel above (bf16 out
        # at bucket 512), planes the planes kernel for every q4b
        # product; Q8_0 decode leaves qmm_q8_m1 for the dequant GEMM;
        # the paged decode's 4 rows pad to 8 on qmm_int8; Mixtral's
        # decode takes _routed_fallback
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "int8"),
        ("Q4_K, 300-token prompt", whole_path_check, ("Q4_K",),
         dict(n_prompt=300, n_decode=1), "int8"),
        ("Q4_K, 32-token prompt", whole_path_check, (), dict(n_decode=1), "planes"),
        ("Q8_0", whole_path_check, ("Q8_0",), dict(n_prompt=24, n_decode=1), "int8"),
        ("paged decode, 4 rows", paged_path_check, (), dict(n_decode=1), "int8"),
        ("Mixtral Q4_K stacked", moe_path_check, ("Q4_K",),
         dict(runs=((24, 1),)), "int8"))


def main_prompts(torch, n_vocab):
    """Phase 4's 24-token and 1000-token prompts."""
    return ([int(t) for t in torch.randint(3, n_vocab, (24,),
                                           generator=torch.Generator().manual_seed(3))],
            [int(t) for t in torch.randint(3, n_vocab, (1000,),
                                           generator=torch.Generator().manual_seed(4))])


def profile_run(torch, dev):
    """`chip_smoke.py --profiles`: the profiles alone, apart from the
    timed run, on phase 4's engine (llama3-8b Q4_K, 32 layers, stacked):
    phase 4's decode step and 4f's under LLAMAFILE_TPU_Q4B=int8, phase 5's
    fused 8-row step and phase 14's dense one, each timed first; then
    under torch.profiler the decode chunks (device_busy, with cProfile's
    host time by function), one 1000-token prefill (prefill_profile), the
    fused and dense steps (fused_profile, dense_profile) and an admission
    (admission_profile)."""
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=0.0)
    eng, read = build_engine(torch, dev, "Q4_K")
    prompt, long_prompt = main_prompts(torch, eng.cfg.n_vocab)
    steps = {}
    for fl in ("txn", "int8"):
        with q4b_flavour(fl):
            _, _, ttft, decode_s = counted_generate(torch, eng, prompt, 32)
            steps[fl] = decode_report(torch, read, 31, ttft, decode_s,
                                      f"24-token prompt, bucket 32, LLAMAFILE_TPU_Q4B={fl}")
    step_fused, step_dense = fused_step(torch, eng, read), dense_step(torch, eng, read)
    for fl in ("txn", "int8"):
        log(f"  decode chunk, LLAMAFILE_TPU_Q4B={fl}:")
        with q4b_flavour(fl):
            device_busy(torch, eng, prompt, sp, steps[fl])
    prefill_profile(torch, eng, long_prompt)
    fused_profile(torch, eng, step_fused)
    dense_profile(torch, eng, step_dense)
    admission_profile(torch, eng)
    del eng
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: chip_smoke.py needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from llamafile_tpu_torch import resolve_device
        from llamafile_tpu_torch.ops import _build
    except ImportError as e:
        print(f"error: llamafile_tpu_torch is not beside chip_smoke.py ({e})",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    t0 = time.time()
    lib_s = _build.build_all()
    build_s = time.time() - t0
    log(f"built {len(_build.SOURCES)} kernel libraries in {build_s:.1f} s; nvcc seconds by "
        f"library: {lib_s}")
    if sys.argv[1:] == ["--profiles"]:
        phase("profiles of phase 4's engine: decode, prefill, fused and dense steps, admission")
        profile_run(torch, dev)
        phase("done")
        print(smi)
        return 0

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    phase("phase 2: kernels against their plain versions at the main path's shapes")
    rows = kernel_phases(torch, dev, gen)
    phase("phase 3: whole paths, llama3-8b width, 2 layers: card vs CPU plain")
    for what, check, args, kw, fl in phase3_checks():
        phase(f"  phase 3 {what}{'' if fl == 'txn' else ', LLAMAFILE_TPU_Q4B=' + fl}")
        with q4b_flavour(fl):
            check(torch, dev, *args, **kw)
    phase("phase 4: main path, llama3-8b Q4_K, 32 layers, Engine.generate")
    runs = main_path(torch, dev)
    launched = {name: sum(c[name] for c in runs) for name in runs[0]}
    for r in rows:
        key = "flash_decode_write_stacked" if r["name"] == "flash_decode_write" else r["name"]
        r["launches"] = launched[key]
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was launched by no main-path run")
        if r["name"] == "qmm_planes":
            # row 12's share: the launches on a stacked layer's view
            r["stacked_launches"] = launched["qmm_planes_stacked"]
            if r["stacked_launches"] == 0:
                raise AssertionError("qmm_planes ran on no stacked layer in the main paths")
    from llamafile_tpu_torch.ops import kernel_wrappers
    if len(rows) != len(kernel_wrappers()):
        raise AssertionError(f"{len(rows)} kernels measured, {len(kernel_wrappers())} wrapped")
    phase("done")
    print(json.dumps({"phase_seconds": {m: round(t1 - t0, 1) for (m, t0), (_, t1)
                                        in zip(PHASE_TIMES, PHASE_TIMES[1:])}}))
    print(json.dumps({"launches": launched}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
