#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card, ``nvcc`` and the repository around it; imports neither
``jax`` nor the JAX package. Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``src/repro_torch/csrc`` (timed) and print each kernel
   instance's registers, shared memory and spills (``-Xptxas -v``); with
   ``--parent DIR`` (a checkout of the commit before the f32 flash_prefill
   at D 256 and f32 paged_matmul redesign, refused unless its C entries
   take the arguments this script passes them and both are still its
   scalar kernels) also build that commit's two kernels into a second
   library, at the same time, to time old and new in this run;
2. hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, and time kernel, plain version and, where one
   exists, one PyTorch library call (SDPA, cuBLAS) -- kernel and library
   call as device time (calls captured in a CUDA graph and replayed
   between CUDA events), the plain version per call with CUDA events;
   the decode kernel (both modes), the f32 and the D 256 flash_prefill
   instances, the SSD scan and paged_matmul (all four tensor-core and f32
   instances) must be bit-identical run to run over 50 repeats; the
   bf16, f32 and both D 256 prefill instances, the SSD scan and
   paged_matmul are also timed at the other plans of their sweeps (rows
   per CTA x stages, or stages; spans per (row, head);
   K-splits or block tiles x stages). In turn: the two attention kernels
   in bf16 (atol = rtol = 2e-2) at qwen3-1.7b's heads (Hkv 8, 2 query
   heads each, D 128), at zamba2-2.7b's (Hkv = H = 32, D 80), at
   granite-moe-1b-a400m's (Hkv 8, 2 query heads each, D 64),
   musicgen-large's (Hkv = H = 32, D 64, over 1024-token slots) and
   llama-3.2-vision-11b's (Hkv 8, 4 query heads each, D 128; the decode
   runs its 8-row instance, half of whose rows are padding, recorded)
   and, the decode kernel, at gemma-2b's (one kv head of 8 query heads,
   D 256); both kernels at glm4-9b's heads (Hkv 2 of 16 query heads
   each) and starcoder2-15b's (Hkv 4 of 12), D 128, the decode in both
   modes, its group split over two CTAs per kv head; the decode's m / l
   output (``return_ml``: f32 o, base-2 m, l) in both modes on each of
   two ranks' views of a cache (a rank with no token: m -inf, l 0) at
   qwen3's heads, at G 16 and 12 and at the tp paths' other heads
   (granite's D 64; zamba2's D 80 / G 1; musicgen's D 64 / G 1 over
   1024-token slots; the VLM's G 4), against the plain versions (f32
   1e-4), the two ranks combined against the one-rank decode (TOL), timed
   at a rank's view of each tp path (bf16; qwen3's int8 too), and at the
   dp path's rank view (mesh (2, 2): 4 of 8 slots, 1024 of 2048 tokens);
   the decode kernel's int8 mode at qwen3's heads and at gemma-2b's (bf16
   2e-2, int8 pages with their scales, the new row at full precision; its
   yardstick is dequantize + SDPA); the attention kernels' edge shapes
   (bf16 2e-2, f32 1e-4): flash_prefill at a ragged 37-token chunk near
   the cache's end, G = 1, 2, 4 and 8, D 64 and 256, softcap 30, in bf16
   and in f32 (the 3xTF32 kernels: at D 80, 128 and 64, and at 256);
   paged_decode, both modes, at lengths 1, 255, 256, 257 and Smax around
   a split, G = 1, 4, 8, 12 and 16, the int8 fresh row on a tile's first and last
   row and past the cache; the f32 flash_prefill instance (3xTF32 tensor
   cores) at the int8 path's chunk, timed beside f32 SDPA; the bf16 D 256
   instance (tensor cores, two warps per 16 rows) at gemma-2b's chunk,
   timed beside SDPA; the f32 D 256 instance (3xTF32, two key groups of
   four warps on the head dim's quarters) there in f32 (1e-4), timed
   beside f32 SDPA and the parent's scalar kernel; the scalar instance
   (D 16 and 32 only) at that chunk's geometry with D 32; the SSD scan in
   f32 (atol = rtol = 1e-4, ``y`` and ``h_last``) at zamba2's 80 heads
   and at a rank's 40 (the tp path's),
   P = N = 64, from a nonzero and a zero state, over a 256-token chunk
   and a ragged 44-token one; the C entries of the three refusing, before
   any launch, each plan that ``check_plan`` refuses (rows, stages,
   tiles or splits the kernel does not take, too little shared memory,
   the wrong kernel or instance, spans that miss tokens, K tiles across
   pages); the paged weight-streaming matmul at qwen3's MLP width (x
   [8, 2048] on the skinny instances and [256, 2048] on the tile ones, 8
   of 16 pages of [256, 6144]; bf16 2e-2, f32 3e-5; no path of the
   reference calls it), timed with the weight cold in L2 (four pools in
   turn) beside cuBLAS (f32 beside the parent's scalar instance too) at
   the same L2 state, warm times beside, and the scalar instance over
   pages of 32 rows. Then run the smoke-size qwen3-1.7b, zamba2-2.7b,
   granite-moe-1b-a400m, musicgen-large, llama-3.2-vision-11b (its cross
   gates set away from 0 and its vision K/V written from random
   embeddings) and xlstm-125m (f32), and qwen3-1.7b with int8 pages,
   through chunked prefill and ragged decode on the card and on the CPU
   from the same weights, and hold logits and caches together (int8
   codes equal but for steps of one, counted);
3. serve qwen3-1.7b at full width, cut to 6 of its 28 layers (random
   bf16 weights drawn on the card from a seed; 8 slots, 2048-token slots, 256-token prefill chunks, a
   DRAM + SSD CXL tier, greedy): 8 requests of 300-1000 prompt tokens and
   32 new tokens, then 4 of the same prompts again under new rids, served
   by prefix restore; check that every request finished, both attention
   kernels ran on that path and no other kernel did, the restores
   happened and stalled on the tier, and each restored request's greedy
   tokens equal its first run's;
4. zamba2-2.7b at full width, cut to 12 of its 54 layers (2 groups of 6
   Mamba2 layers; random bf16 weights from the same seed): one 256-token
   prompt through one chunked prefill against 256
   ``decode_step`` calls -- with the weights widened to f32, logits within
   1e-3 and the prompt's greedy token equal; in bf16 the difference is
   reported -- then serve it on the engine of phase 3 (8 requests of
   300-1000 prompt tokens, 32 new tokens; the hybrid is never restored
   from the tier, as in the reference) and check that every request
   finished, pages were flushed, and all three kernels ran on that path
   and no other kernel did;
5. serve qwen3-1.7b at full width (6 of 28 layers) with int8 KV pages
   on the engine and
   traffic of phase 3; check that every request finished, the int8 decode
   kernel ran once per layer per tick and flash_prefill ran, every
   resubmit was restored with its first token and its prompt's full pages
   bit for bit, and a stored entry is under 0.55 of phase 3's bf16 entry,
   and that the prefill ran on the f32 (3xTF32) flash_prefill instance
   and no other kernel ran;
   then restore the same prompts from entries stored right after prefill
   and check that their greedy tokens equal the first run's;
6. serve gemma-2b at full width, cut to 9 of its 18 layers (MQA with one
   kv head, head_dim 256, geglu, tied embeddings; random bf16 weights
   from the seed) on the
   engine and traffic of phase 3; check that every request finished, the
   restores stalled on the tier and gave their first run's greedy tokens,
   the D 256 flash_prefill instance ran once per layer per chunk and the
   bf16 paged_decode once per layer per tick, and no other kernel ran;
7. serve gemma-2b at full width (9 of 18 layers) with int8 KV pages on
   the engine and
   traffic of phase 3, with phase 5's gates at gemma's shape: every
   request finished, the int8 decode ran once per layer per tick and the
   f32 D 256 flash_prefill instance once per layer per chunk, no other
   kernel ran, every resubmit was restored with its first token and its
   prompt's full pages bit for bit, restores from post-prefill entries
   gave the first run's tokens, and the entry is under 0.55 of phase 6's
   bf16 entry;
8. serve granite-moe-1b-a400m at full width, cut to 6 of its 24 MoE
   layers (32 experts top-8 at capacity ``round(1.25 t k / E)``, which
   drops pairs at decode too on one device, as the reference does; 8 kv
   heads of 2 query heads, D 64) on the engine and traffic of phase 3; check that every request
   finished, the restores stalled on the tier and each gave its first
   run's first token and its prompt's full pages bit for bit (the tokens
   after it may part: a tick routes every slot's row together, so a
   restored request's neighbours change its drops), flash_prefill (bf16
   D 64) ran once per layer per chunk and the bf16 paged_decode once per
   layer per tick, and no other kernel ran; print the share of (token,
   expert) pairs dropped at decode and at prefill;
9. serve musicgen-large at full width, cut to 6 of its 48 layers (32 kv
   heads = heads, D 64, 4 codebooks fed one token, sinusoidal positions;
   a 48 MiB entry) on phase 3's
   engine with 1024-token slots: 3 requests of 300-600 prompt tokens and
   32 new tokens, then 2 of them again (prefix restores); phase 3's gates
   (restored greedy tokens equal the first run's) and phase 8's kernels,
   once per layer per step;
10. serve llama-3.2-vision-11b at full width, cut to 10 of its 40 layers
   (2 groups of 4 self-attention layers and one gated cross-attention
   layer over 1601 vision tokens; 32 query heads over 8 kv heads, D 128,
   SwiGLU d_ff 14336, vocab 128256; ~3.2 B random bf16 weights drawn on
   the card) on
   phase 3's engine: 4 requests of 300-1000 prompt tokens and 32 new
   tokens, none resubmitted (the family is never restored, as in the
   reference); check that every request finished and its pages were
   flushed as one entry of the 8 self-attention layers (64 MiB),
   flash_prefill ran once per self-attention layer per chunk and the
   bf16 paged_decode once per self-attention layer per tick, no other
   kernel ran, and the vision K/V are still the cache's zeros (the
   serving path has no vision input; the reference's engine never
   writes them either);
11. serve xlstm-125m at full width, cut to 6 of its 12 layers (one group
   of 5 mLSTM
   layers and one sLSTM layer, d_model 768, 4 heads, vocab 50304) on
   phase 3's engine: 8 requests of 300-1000 prompt tokens and 32 new
   tokens, its prefill each layer over the whole chunk (memory updates and
   cells token by token, as the reference's scan of ``decode_step``;
   projections once a chunk);
   check that every request finished, no kernel launched (the family has
   none) and nothing was flushed (its cache has no pages); print the
   tick's ms and the prefill's ms per token;
12. serve glm4-9b (cut to 10 of its 40 layers, 32 query heads over 2 kv
   heads, d_ff 13696, vocab 151552; ~3.1 B random bf16 weights) and
   starcoder2-15b (10 of 40 layers, d_model 6144, 48 over 4, tanh-gelu
   d_ff 24576, vocab 49152; ~4.5 B) at full width on phase 3's engine: 4
   requests and 2 prefix
   restores each; phase 3's gates, and flash_prefill once per layer per
   chunk and the bf16 paged_decode (two CTAs per kv head) once per layer
   per tick;
13. serve on two ranks: two processes on the one card joined by gloo
   (``launch.mesh.spawn``, started once), each holding its shard of the
   weights (``parallel.sharding.param_specs``: attention and MLP columns
   / rows, the vocabulary, the experts) and half of every slot's pages,
   4 requests of 300-1000 tokens and 2 restores (through the
   ShardedTier's peer lanes): first qwen3-1.7b (cut to ``TP_LAYERS``
   layers, bf16 weights) with bf16 and with int8 pages, held step by step
   to the one-rank engine on the card over the same traffic: every
   greedy step's logits within a bound of the one-rank engine's (and of
   its f32 twin's, the same weights widened), the bound ``TP_NOISE_X``
   times the one-rank engine's own distance from that twin plus TOL's
   atol; the tokens equal but where the two argmaxes part at a near tie
   (the one-rank logits of the two tokens within the bound; the gap
   printed; a restore starts from its entry's first token, its source's
   on each engine, so where that token parted at a near tie the restore
   is conditioned on another token from its first step: its first token
   must be its source's on both engines, and each engine's restore is
   held instead to its own source's rows at the matching steps); its
   bf16 tick and chunk timed again with the row-parallel products taken
   from f32 copies; then granite-moe-1b-a400m at full width (cut to 2
   of 24 layers, ``TP_CUT``; bf16 pages), its MoE expert-parallel
   (``all_to_all`` dispatch at prefill, the last prompt's odd final chunk
   on the one-device fallback, a sum all-reduce at decode): the ranks'
   tokens,
   stats and tier traces equal, layer 0's MoE on each rank within TOL of
   ``moe_apply_ep_ref`` and of ``moe_apply_ep_loop`` (whole experts, on
   the card; the loop shares no helper with the form under test, and
   their dropped pairs must agree) at every prefill chunk and the first
   tick, 2 ``all_to_all``s per MoE layer per even chunk and none at
   decode; then the families of ``TP_FAMILIES`` at full width, cut to
   ``TP_CUT`` (zamba2-2.7b 6 of 54 layers: one group with its shared
   block; musicgen-large 2 of 48 with 1024-token slots and 2 restores;
   llama-3.2-vision-11b 5 of 40: four self-attention layers and a cross
   layer; xlstm-125m 6 of 12: one group), each held as qwen3 is to its
   one-rank engine
   and f32 twin run first (per-slot states whole on every rank; Mamba2's
   scan at a rank's 40 heads), and the VLM also on a direct prefill chunk
   and tick with vision K/V written from random embeddings and both
   cross gates away from 0, within the bound measured on the one-rank
   calls and their f32 twins (its served cross layers add 0). On every
   path: each rank holds the whole
   model's bytes less half of its split leaves', the decode (its m / l
   output), the prefill and the SSD scan run once per attention or
   Mamba2 layer per step and no other kernel (xLSTM: none); a rank that
   fails or outlives ``TP_TIMEOUT_S`` fails the
   script; print each rank's parameter bytes, peak memory, wall, tick and
   chunk ms (CUDA events) and collectives per step beside one rank's, and
   the ShardedTier counters;
14. serve over the data and model axes, mesh (2, 2): four processes on
   the one card joined by gloo (``launch.mesh.spawn`` with
   ``mesh_shape``, started once), each holding its shard of qwen3-1.7b's
   weights (``TP_LAYERS`` layers) on the POOL tier (``core.hdm.HDMStore``:
   its model-axis shard cut again on the data axis), its data row's 4
   slots and its half of their pages; every step gathers each layer over
   the data axis (the speculative read, one layer ahead) and the
   embedding once. 6 requests of 300-1000 tokens (4 on data row 0, 2 on
   row 1) and 2 restores, one of them into the other row, held step by
   step to the one-rank engine on the same traffic as the tp phase holds
   its ranks (the bound from the one-rank engine and its f32 twin; each
   request's steps on the ranks of the row that serves it); layer 0
   gathered equal bit for bit to the whole model's model-axis shard of
   it; every rank's tokens, stats and tier traces alike; the decode once
   per layer per tick and the prefill once per layer per chunk of the
   rank's row, no other kernel; each rank's bytes its share by the
   specs. Prints the parameter bytes against the whole, the gathered
   layer's bytes, the tick and chunk ms at SR depth 1 and 0 (in turns:
   1 0, 0 1), a gather's ms alone (a layer, the embedding), the collectives
   per step by axis, the rank walls and peaks; the decode kernel at this
   rank view (4 of 8 slots, 1024 of 2048 tokens, m / l) is checked and
   timed beside SDPA in phase 2;
15. train: flash_prefill at the training loss's shape (one layer's 4096-
   token sequence as one chunk at position 0 against its own K/V; bf16
   2e-2) against its plain version, timed beside causal SDPA; one
   training step of the smoke-size qwen3-1.7b, granite-moe-1b-a400m,
   musicgen-large, zamba2-2.7b and llama-3.2-vision-11b in f32 on the
   card and on the CPU (loss and gradients 3e-5, the hybrid's 1e-4;
   masters within 2 lr); ``launch/train.py`` at smoke size on the card
   with its checkpoint written from CUDA tensors, restored equal and
   resumed; then qwen3-1.7b at full width (random bf16 weights from the
   seed, f32 master, m and v; 8 sequences of train_4k's 4096 tokens from
   the port's ``SyntheticLM``, the batch cut from 256 for one card): the
   forward loss under ``no_grad`` with ``use_pallas`` (flash_prefill once
   a layer, 28 launches, no other kernel) within 2e-3 of the plain
   ``chunked_attention`` loss, a step with ``use_pallas`` refused (the
   kernel has no backward), then 4 steps on the repeated batch at lr 3e-4
   without warmup: every loss finite, the first within 1.5 of ln V, the
   last below the first, no kernel launched under grad; prints the step
   ms (CUDA events), tokens/s, the MFU against 989 TFLOP/s (6 x active
   params x tokens, remat's recompute not counted) and the peak memory;
16. train xlstm-125m at full width (12 layers; random bf16 weights from
   the seed; 8 sequences of 512 tokens, ``XLSTM_TRAIN_*``): the training
   form ``mlstm_apply`` against a loop of the serving form ``mlstm_step``
   over the same 512 tokens in f32 (``XLSTM_FORMS_TOL``); the bf16 leaf
   rule (``bf16_limit``) on the first 6 layers at 2 x 256 tokens and
   numpy weights, where the reference's own bf16 errors were measured on
   the CPU (``XLSTM_GATE_*``); the first step's bf16 loss (TOL) against
   an f32 twin at the same weights, each gradient's distance from the
   twin's reported; then 3 steps:
   every loss finite, the first within 1.5 of ln V, no kernel launched (the
   family has none); prints the step ms and the peak memory;
17. train qwen3-1.7b at full width cut to 4 layers on a (2, 1) mesh: two
   rank processes on the one card joined by gloo, each holding its POOL
   shard of the weights and of m, v and the f32 master (``steps.
   init_state(mesh=)``) and 2 of the global batch's 4 sequences of 1024
   tokens; each layer gathered in its remat'd body, its gradients
   reduce-scattered by the deterministic store. Held: the ranks' loss and
   gradients (shards put together) within ``TP_NOISE_X`` times the
   one-rank port's own distance from its f32 twin on the same global
   batch (the loss plus TOL's atol), a whole step with the deterministic
   store off bit for bit the step with it on, the ranks' losses alike, no
   kernel launched. Prints the step ms with the store on and off in
   turns, the collectives of a step by axis, a layer's gather ms, a
   layer's and the embedding's f32 gradient reduce-scattered (DS on) and
   all-reduced (DS off) ms, the bytes of params, m, v and master a rank
   against one rank's, and the peak memory; then one step with DEVICE
   weights beside POOL m, v and masters (``steps.state_moves``: each rank
   updates its FSDP shard of the state and the new weights are gathered),
   its loss and its first moments within ``TP_NOISE_X`` times the one
   rank's own distance from its f32 twin after one step;
18. train the same model and batch at mesh (1, 2): two rank processes
   on the one card, each on its model-axis shard (Megatron's split:
   ``param_specs``' "M" leaves halved, each rank's heads, d_ff columns
   and vocabulary columns, the activations whole between blocks) and the
   whole batch. Held by the same rule: the loss, every gradient leaf (the
   ranks' parts put together) and the first moments after one AdamW
   step; the ranks' losses and clip norms alike, no kernel launched.
   Prints a rank's step ms over ``TP_TRAIN_STEPS`` steps, the
   collectives of a step by axis, the bytes of params, m, v and master a
   rank against one rank's (and the model-split leaves'), the peak;
   then, the same way, the families of ``TPF_TRAIN`` at full width cut to
   whole groups, each beside its own one rank and f32 twin run first:
   zamba2-2.7b at 12 of 54 layers (its Mamba2 heads split, the shared
   block's attention and MLP) on 2 x 1024 tokens, llama-3.2-vision-11b at
   5 of 40 (four self-attention layers and a cross layer: a rank's q and
   kv heads of the 1601 vision tokens) on 2 x 1024 tokens, xlstm-125m
   whole (each layer whole on every rank from its gathered leaves) on 2 x
   512 tokens, ``TPF_TRAIN_STEPS`` steps each, one spawn for the three;
19. serve qwen3-1.7b (7 of 28 layers, ``HOST_SERVE_LAYERS``) with its
   weights on the HOST tier
   (``param_tier="host"``, ``enable_host_tier``: every leaf in pinned
   host memory, each step's reads copied onto the card on a side stream,
   ``sr_prefetch_depth`` layers ahead) beside the DEVICE engine on the
   same traffic (4 requests, 2 restores, 8 new tokens): every HOST leaf
   pinned, the greedy tokens, the restores and the tier's ops and op_ns
   equal, no weight left on the card between steps and no more than the
   stream's window (the leaves outside the stream and two layers) during
   one, both kernels launched, a pageable leaf's copy refused; prints
   the tick and chunk ms at SR depth 1 and 0 in turns (1 0, 0 1, 1 0),
   the copies of a tick alone and the share of them the prefetch hides;
20. train glm4-9b at full width on one rank with its weights, m, v and
   master on the HOST tier: (a) 4 layers, 2 steps of 2 x 1024 tokens,
   then the DEVICE twin from the same weights and batch, the card freed
   between: every parameter, moment and master equal bit for bit, the
   losses and gradient norms equal, the forward loss at depth 0 and 1
   equal bit for bit; (b) as deep as the host can pin (the full 40
   layers if ~132 GB is at most 60% of the smaller of MemAvailable and
   the cgroup's limit, else the deepest cut that leaves 16 GiB of
   MemAvailable, reported against the 21 layers whose state at 16 bytes a
   parameter passes the card's memory): 3 steps at SR depths 1, 0, 1,
   every loss finite, the first within 0.5 of ln V + d (0.02)^2 / 2, the
   card's peak under its total, no kernel launched; prints the step and
   optimizer ms, the bytes copied each way, the copy rates, the share of
   the layer copies the prefetch hides, the pinned bytes against the
   bytes held;
21. serve qwen3-1.7b open loop: full width cut to ``OPEN_LAYERS`` of its
   28 layers (random bf16 weights from the seed) on phase 3's engine with
   async tier I/O (``cxl_async``), ``OPEN_LOAD``'s seeded arrival trace
   (``serving.loadgen``: 24 bursty arrivals at 8000 a simulated second,
   6 zipf-shared prompts of 256-1024 tokens, 8-32 new tokens, a quarter
   interactive) played on the simulated clock by ``drive_open_loop``, once
   with swap and once with recompute preemption (the main path: the
   kernels' counts from 0 before the two runs, read after). First the
   same arrivals served closed (all submitted at once, no preemption) and
   by its f32 twin (the weights widened), their greedy logits captured:
   the bound of a near tie, ``TP_NOISE_X`` times the closed run's distance
   from the twin plus TOL's atol. Gates on each run: every arrival
   completed and none lost, at least one preemption and one prefix hit,
   swap's bytes in equal to its bytes out, the tier's op_ns within
   ``OPEN_REPLAY_RTOL`` of the scalar oracle's replay of its ops (in a
   worker process beside the card's work), every request's greedy tokens
   equal to the closed run's but where they part at a near tie (the
   closed run's logits of the two tokens within the bound), the decode
   once per layer per tick and the prefill once per layer per chunk (a
   recompute's re-prefill and its ragged last chunk included), no other
   kernel; prints the simulated TTFT / TPOT p50 / p99, goodput, queue
   depth and restore stall (``LoadMetrics``), the wall, ticks, launches
   a tick and the tick and chunk ms (CUDA events);
22. print the measured numbers, the seconds of each phase, one
   ``kernels`` JSON line, the card line
   and last ``{"ok": true, "device": {...}}``.
   ``chiprun_out/chip_smoke.json`` keeps the full record.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

ARCH = "qwen3-1.7b"
HYBRID = "zamba2-2.7b"
GEMMA = "gemma-2b"
GRANITE = "granite-moe-1b-a400m"
MUSICGEN = "musicgen-large"
VLM = "llama-3.2-vision-11b"
XLSTM = "xlstm-125m"
GLM4 = "glm4-9b"               # 32 query heads over 2 kv heads: G 16
STARCODER2 = "starcoder2-15b"  # 48 over 4: G 12
TP_PATH, TP8_PATH = f"{ARCH} tp2", f"{ARCH} tp2 int8"
TPG_PATH = f"{GRANITE} tp2"
DP_PATH = f"{ARCH} dp2xtp2"
N_SLOTS, MAX_SEQ, CHUNK = 8, 2048, 256
N_REQUESTS, N_RESUBMIT, MAX_NEW = 8, 4, 32
N_HYBRID_REQUESTS = 8
# musicgen's 384 MiB entry (1024-token slots) costs the Python tier ~9 s a
# flush or restore (H100 80GB HBM3 host, PERF.md section 5): fewer
# requests and shorter slots than phase 3's, for the script's time limit
MUSICGEN_MAX_SEQ, MUSICGEN_PROMPT_LENS = 1024, (300, 601)
N_MUSICGEN_REQUESTS, N_MUSICGEN_RESUBMIT = 3, 2
# the VLM's 64 MiB entries (8 self-attention layers) and xLSTM's token-
# by-token prefill (its reference's form): fewer VLM requests than phase
# 3's, never resubmitted (neither family is restored from the tier)
N_VLM_REQUESTS, N_XLSTM_REQUESTS = 4, 8
# glm4-9b's 20 MiB and starcoder2-15b's 40 MiB entries: 4 requests and 2
# restores each
N_GROUP_REQUESTS, N_GROUP_RESUBMIT = 4, 2
# the tp phase: two ranks (processes) on the one card, qwen3-1.7b in bf16
# and with int8 pages against the one-rank engine on the same traffic,
# then granite-moe-1b-a400m; 4 requests and 2 restores each
TP_RANKS, N_TP_REQUESTS, N_TP_RESUBMIT = 2, 4, 2
TP_TIMEOUT_S = 600.0
# the dp phase: mesh (2, 2), four ranks (processes) on the one card,
# qwen3-1.7b's weights on the POOL tier; 6 requests (the first 4 fill
# data row 0's slots, the next 2 row 1's) and 2 restores (the last
# request's first: it crosses from row 1 to row 0), 8 new tokens each;
# the tick and chunk timed at SR depth 1 and 0 in DP_ORDERS' turns (the
# first set a rank times runs slow, PERF.md section 7)
DP_MESH, N_DP_REQUESTS, DP_MAX_NEW = (2, 2), 6, 8
DP_ORDERS = ((1, 0), (0, 1))
DP_TIMEOUT_S = 600.0
# qwen3's tp gate holds the ranks' bf16 logits to the one-rank engine's
# within this many times the one-rank engine's own distance from its f32
# twin (the same weights widened), plus TOL's atol: the multiple the
# training gate allows a bf16 gradient over the reference's own error
TP_NOISE_X = 3.0
# xLSTM's prefill (a recurrence a token in every layer) is timed over a
# chunk of this many tokens
XLSTM_TIMED_TOKENS = 32
# Depth cuts, for the script's time budget: the kernels' shapes and the
# per-layer gates do not depend on depth, the Python tier's charge (~24-32
# ms per MiB of entry on the host of an H100 80GB HBM3 at 700 W, PERF.md
# section 5) and the eager steps do. Widths, heads, vocabularies and
# traffic stay the full models'. zamba2 runs at two of its nine groups,
# granite at a quarter and musicgen at an eighth of their depth (for the
# tp phase's granite path and the dp phase), the VLM, glm4-9b and
# starcoder2-15b at a quarter and gemma-2b (both page formats: the int8
# entry is held to the bf16 one) and xLSTM at half for the tp phase's
# other families, qwen3-1.7b (both page formats) at 6 of 28 for the time
# of the dp and HOST phases (PERF.md section 4)
CUT_LAYERS = {ARCH: 6, HYBRID: 12, GRANITE: 6, MUSICGEN: 6, VLM: 10,
              GLM4: 10, STARCODER2: 10, GEMMA: 9, XLSTM: 6}
# the tp phase's qwen3-1.7b (and the dp phase's), cut to 2 of 28 layers
# for the same reason: each rank charges its replica of the tier with the
# whole entry, and the phase runs the one-rank engine and the two ranks
# in both page formats (at 2 layers the int8 ranks' first token of rid 0
# parts from the one-rank engine's at a near tie, and its restore, rid
# 1000, takes each engine's own first token: tp_logits_gate's sources)
TP_LAYERS = 2
# the tp phase's other families, each beside its one-rank engine and f32
# twin: zamba2 at one group of 6 Mamba2 layers with its shared block,
# musicgen at 2 of 48 layers (1024-token slots; 4 before the tp2-train
# phase), the VLM at 5 of 40 (4
# self-attention layers and one cross layer), xLSTM at one group of 6 of
# its 12 layers (5 mLSTM layers and an sLSTM layer), the last two cut for
# the HOST phases; and the tp phase's granite at 2 of 24 layers (6 before
# the open-loop phase)
TP_FAMILIES = (HYBRID, MUSICGEN, VLM, XLSTM)
TP_CUT = {HYBRID: 6, MUSICGEN: 2, VLM: 5, XLSTM: 6, GRANITE: 2}
TPF_PATHS = {arch: f"{arch} tp2" for arch in TP_FAMILIES}
# the VLM's direct tp gate: 2 rows, one prefill chunk then one tick, the
# cross gates set to these values and the vision K/V written by each
# cross layer from random embeddings
VLM_GATES = {"attn_gate": 0.7, "mlp_gate": -0.4}
# the training phase: full-width qwen3-1.7b on train_4k's 4096-token
# sequences, its batch cut from 256 to 8 for one card; 4 steps on one
# repeated batch at AdamWConfig(learning_rate=3e-4, warmup_steps=0) (the
# form of tests/test_models.py:55), then the smoke families' steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4096, 4
# launch/train.py's own loop at the same width, a batch from its pipeline
# each step
TRAIN_DRIVER_STEPS = 2
TRAIN_LR = 3e-4
TRAIN_SMALL = (ARCH, GRANITE, MUSICGEN, HYBRID, VLM)
TRAIN_PATH = f"{ARCH} train"
# the xLSTM training phase: full-width xlstm-125m (12 layers: 2 groups of
# 5 mLSTM layers and an sLSTM layer) on one rank, train_4k's 4096-token
# sequences cut to 512 (its sLSTM cells run token by token, as the
# reference's scan does: a Python loop of 512 cells a layer, recomputed
# and differentiated) and its batch from 256 to 8; a few steps at
# TRAIN_LR without warmup
XLSTM_TRAIN_PATH = f"{XLSTM} train"
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 8, 512, 3
# mlstm_apply (chunkwise) against a loop of mlstm_step (recurrent) in f32
# at full width: two 256-token chunks of 2 sequences, the forms' f32 sums
# taken in other orders over d_in 1536 and 384-wide heads
XLSTM_FORMS_TOKENS = 512
XLSTM_FORMS_TOL = dict(atol=1e-4, rtol=1e-4)
# the bf16 leaf rule of tests/test_torch_train.py (PR 20's): each bf16
# gradient leaf, against the f32 twin's (the same weights widened),
# within 2e-2 of the leaf's norm plus three times the reference's own
# bf16 error there (bf16_limit). The card has no reference, so the rule
# runs at inputs the reference can run at on the CPU, where
# tests/test_torch_xlstm_card_gate.py measures its errors (run it as a
# script to print them) and holds them to XLSTM_GATE_REF_ERR: xlstm-125m
# at full width cut to its first group (6 layers: 5 mLSTM, 1 sLSTM), its
# drawn leaves redrawn by numpy from SEED (xlstm_gate_model; the sha256
# of their bf16 bytes is XLSTM_GATE_SHA on both), a batch of 2 x 256
# tokens from the pipeline. A zeroed, mis-cast or wrong leaf is off by
# about its whole norm.
XLSTM_GATE_LAYERS, XLSTM_GATE_BATCH, XLSTM_GATE_SEQ = 6, 2, 256
XLSTM_GATE_SHA = ("f51fbe4549daeaee28bec931534b1a5c"
                  "9435de4fa5508d7bd58227a89c062ec7")
# the reference's bf16 gradient, leaf by leaf, off its f32 one in that
# leaf's norm
XLSTM_GATE_REF_ERR = {
    "embed.embedding": 0.005627, "mlstm.0.0.w_up1": 0.01747,
    "mlstm.0.0.w_up2": 0.01323, "mlstm.0.0.conv_w": 0.01974,
    "mlstm.0.0.w_qkv": 0.01824, "mlstm.0.0.w_gates": 0.01398,
    "mlstm.0.0.gate_bias": 0.01185, "mlstm.0.0.w_down2": 0.01265,
    "mlstm.0.0.ln.scale": 0.01695, "mlstm.0.0.ln_head.scale": 0.01264,
    "mlstm.0.1.w_up1": 0.01073, "mlstm.0.1.w_up2": 0.01224,
    "mlstm.0.1.conv_w": 0.01342, "mlstm.0.1.w_qkv": 0.01087,
    "mlstm.0.1.w_gates": 0.01559, "mlstm.0.1.gate_bias": 0.01508,
    "mlstm.0.1.w_down2": 0.01181, "mlstm.0.1.ln.scale": 0.01163,
    "mlstm.0.1.ln_head.scale": 0.01344, "mlstm.0.2.w_up1": 0.01487,
    "mlstm.0.2.w_up2": 0.01308, "mlstm.0.2.conv_w": 0.01804,
    "mlstm.0.2.w_qkv": 0.01494, "mlstm.0.2.w_gates": 0.009831,
    "mlstm.0.2.gate_bias": 0.007189, "mlstm.0.2.w_down2": 0.01311,
    "mlstm.0.2.ln.scale": 0.01338, "mlstm.0.2.ln_head.scale": 0.01364,
    "mlstm.0.3.w_up1": 0.01094, "mlstm.0.3.w_up2": 0.01217,
    "mlstm.0.3.conv_w": 0.01265, "mlstm.0.3.w_qkv": 0.01095,
    "mlstm.0.3.w_gates": 0.01281, "mlstm.0.3.gate_bias": 0.01041,
    "mlstm.0.3.w_down2": 0.01215, "mlstm.0.3.ln.scale": 0.01008,
    "mlstm.0.3.ln_head.scale": 0.01268, "mlstm.0.4.w_up1": 0.01526,
    "mlstm.0.4.w_up2": 0.01226, "mlstm.0.4.conv_w": 0.01882,
    "mlstm.0.4.w_qkv": 0.0168, "mlstm.0.4.w_gates": 0.01899,
    "mlstm.0.4.gate_bias": 0.02174, "mlstm.0.4.w_down2": 0.01135,
    "mlstm.0.4.ln.scale": 0.01572, "mlstm.0.4.ln_head.scale": 0.01275,
    "slstm.0.conv_w": 0.006899, "slstm.0.w_gates": 0.003041,
    "slstm.0.r_gates": 0.002651, "slstm.0.gate_bias": 0.001627,
    "slstm.0.w_out": 0.002739, "slstm.0.ln.scale": 0.002801,
    "slstm.0.ln_ff.scale": 0.008738, "slstm.0.ffn.w_up": 0.008254,
    "slstm.0.ffn.w_down": 0.008036, "slstm.0.ffn.w_gate": 0.008511,
    "ln_f.scale": 0.004116}


def bf16_limit(leaf: str) -> float:
    """The bf16 leaf rule's bound on ``leaf``'s distance from the f32
    twin, over that leaf's norm."""
    return 2e-2 + 3 * XLSTM_GATE_REF_ERR[leaf]


# the dp-train phase: qwen3-1.7b at full width cut to 4 of its 28 layers
# on a (2, 1) mesh, two rank processes sharing the card over gloo, the
# weights and AdamW state on the POOL tier; a global batch of 4
# sequences of 1024 tokens (train_4k's 256 x 4096 cut for one card and
# the phase's time), 2 rows a rank; the steps timed with the
# deterministic store on and off in DP_TRAIN_ORDERS' turns (the first
# step a rank times runs slow, PERF.md section 7; one turn since the
# open-loop phase, two before)
DP_TRAIN_PATH = f"{ARCH} dp2 train"
DP_TRAIN_MESH, DP_TRAIN_LAYERS = (2, 1), 4
DP_TRAIN_BATCH, DP_TRAIN_SEQ = 4, 1024
DP_TRAIN_ORDERS = ((True, False),)
DP_TRAIN_TIMEOUT_S = 600.0
# the tp2-train phase: the dp-train phase's model and batch at mesh (1, 2),
# two ranks on the one card, each on its model-axis shard; 3 steps timed
TP_TRAIN_PATH = f"{ARCH} tp2 train"
TP_TRAIN_MESH, TP_TRAIN_STEPS = (1, 2), 3
# the tp2-train-families phase: the hybrid, VLM and xLSTM families at full
# width, each cut in depth to whole groups, at mesh (1, 2) beside its one
# rank and f32 twin, held by the tp2-train phase's rule: {arch: (layers,
# batch, tokens)} -- zamba2-2.7b at 2 of its 9 groups (12 of 54 layers:
# 12 Mamba2 layers and 2 calls of the shared block), llama-3.2-vision-11b
# at 1 of 8 (5 of 40: 4 self-attention layers and a cross layer over its
# 1601 vision tokens), xlstm-125m whole (its sLSTM cells token by token);
# TPF_TRAIN_STEPS steps timed a family
TPF_TRAIN_PATH = "tp2 train families"
TPF_TRAIN = {HYBRID: (12, 2, 1024), VLM: (5, 2, 1024), XLSTM: (12, 2, 512)}
TPF_TRAIN_STEPS = 2
# the HOST tier (pinned host memory streamed onto the card by the
# speculative read): "host-serve" serves qwen3-1.7b (HOST_SERVE_LAYERS)
# with its weights on the HOST tier beside the same traffic on the DEVICE
# engine, 4 requests and 2 restores of 8 new tokens each, the tick and
# chunk timed at SR depth 1 and 0 in HOST_ORDERS' turns (the first
# timed set runs slow, PERF.md section 7); "host-train" trains glm4-9b at
# full width on one rank with its weights, m, v and master on the HOST
# tier: (a) HOST_GATE_LAYERS layers, HOST_GATE_STEPS steps bit for bit
# against the DEVICE twin; (b) as deep as the host's memory can pin (at
# least HOST_MIN_LAYERS, where the state at 16 bytes a parameter passes
# the card's memory), a step at each SR depth of HOST_TRAIN_DEPTHS, a
# batch of 2 x 1024 tokens
HOST_SERVE_PATH, HOST_TRAIN_PATH = f"{ARCH} host", f"{GLM4} host train"
HOST_SERVE_LAYERS = 7
N_HOST_REQUESTS, N_HOST_RESUBMIT, HOST_MAX_NEW = 4, 2, 8
HOST_ORDERS = ((1, 0), (0, 1), (1, 0))
HOST_BATCH, HOST_SEQ = 2, 1024
HOST_GATE_LAYERS, HOST_GATE_STEPS = 4, 2
HOST_MIN_LAYERS, HOST_TRAIN_DEPTHS = 21, (1, 0, 1)
# the full depth runs if its pinned bytes are at most this share of the
# smaller of MemAvailable and the cgroup's limit; a cut must leave this
# much of MemAvailable unpinned for the rest of the process
HOST_FULL_SHARE, HOST_HEADROOM = 0.6, 16 << 30
# the use_pallas loss against the plain one (tests/test_models.py:154)
PALLAS_LOSS_TOL = 2e-3
# flash_prefill at the loss shape: row n of a causal 4096-key attention over
# random values averages n of them, so late rows are ~sqrt(e / n) ~ 0.03 in
# size and TOL's atol would hide a lost key tile there; bf16 rounding of
# such an output is ~1e-4, and rtol keeps TOL's 2e-2 for the early rows
TRAIN_PREFILL_TOL = dict(atol=2e-3, rtol=2e-2)
# an int8 entry over a bf16 one: the reference's gate is 1/itemsize + 0.05
# (tests/test_kv_quant.py:233)
INT8_ENTRY_RATIO = 0.55
# paged_matmul at qwen3-1.7b's MLP width: K = d_model, N = d_ff, 8 logical
# pages of 256 rows drawn from a pool of 16
MATMUL_K, MATMUL_N, MATMUL_PAGE_K, MATMUL_POOL = 2048, 6144, 256, 16
# pools the cold-L2 timings rotate through: 25 MB of pages a call, 75 MB
# of others between two uses of one pool, against the card's 50 MB of L2
MATMUL_POOLS = 4
F32_TOL = dict(atol=3e-5, rtol=3e-5)    # tests/test_kernel_parity.py
PROMPT_LENS = (300, 1001)
TOPOLOGY = ("dram", "ssd-fast")
SEED = 0
# the open-loop phase: qwen3-1.7b at full width cut to OPEN_LAYERS layers
# on phase 3's engine with async tier I/O, played a seeded open-loop
# arrival trace (serving.loadgen) once with each preemption policy of
# OPEN_POLICIES; 24 bursty arrivals at the reference CLI's 8000 requests
# a simulated second (~0.8 an engine tick of 100 us, against the ~0.35 a
# tick that 8 slots serve at these lengths, so the queue builds) over 6
# zipf-shared prompts of 256-1024 tokens and 8-32 new tokens, a quarter of
# them interactive (priority 1); held to the same arrivals served closed.
# The simulated schedule hangs on the trace and the entries' bytes, not on
# the weights: trace seed 0 preempts no request at 2 or 4 layers, seed 1
# twice with each policy. Depth: the Python tier's charges of a 2048-token
# slot's entry (8 MiB a layer; PERF.md section 5) set the phase's time
OPEN_PATH = f"{ARCH} open-loop"
OPEN_LAYERS = 4
OPEN_POLICIES = ("swap", "recompute")
OPEN_LOAD = dict(n_arrivals=24, rate_rps=8000.0, arrival="bursty",
                 burst_factor=8.0, burst_len=8, n_prompts=6, zipf_s=1.1,
                 prompt_len_choices=(256, 512, 1024),
                 max_new_choices=(8, 16, 32), hi_prio_frac=0.25, seed=1)
# the tier's op_ns against the scalar oracle's replay of its ops
# (tests/test_faults.py:371)
OPEN_REPLAY_RTOL = 0.01
TOL = dict(atol=2e-2, rtol=2e-2)        # bf16, tests/test_kernel_parity.py
SSD_TOL = dict(atol=1e-4, rtol=1e-4)    # f32, tests/test_kernels.py
# full-width zamba2, chunked vs stepwise prefill in f32: 10x the smoke-size
# f32 bound of tests/test_torch_hybrid.py, for sums over a 54-layer stack
FULL_F32_TOL = dict(atol=1e-3, rtol=1e-3)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 and TF32
# flop/s (tensor cores), f32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# an f32 product in error-compensated 3xTF32 is three TF32 products
TF32_PRODUCTS = 3


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


PHASE_S = {}


@contextlib.contextmanager
def phase(name: str):
    """Host seconds of one phase of the script, logged and kept in
    ``PHASE_S``."""
    t0 = time.time()
    yield
    PHASE_S[name] = time.time() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f}s")


def free_card() -> None:
    """Drop the last phase's model and cache from the card: collect the
    engine's reference cycles (its scheduler and handles point back at
    it), then return the cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"card memory allocated after the phase: "
        f"{torch.cuda.memory_allocated()} bytes")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    that the host's dispatch of each call (Python checks, ctypes) is not
    in the time. For a kernel or library call that syncs with nothing."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, tol=TOL):
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"{name}: max abs err {err} beyond {tol}")
    return err


def check_repeatable(name, call, other, n=50):
    """``call``'s output is bit-identical run to run, each run after one
    of ``other`` (the same plan and workspace, other values)."""
    import torch
    first = call().clone()
    for _ in range(n):
        other()
        if not torch.equal(call(), first):
            fail(f"{name}: output differs from run to run")
    return n


# ---------------------------------------------------------------- phase 2

def launch_plans():
    """The kernels' launch plans (grid, tiles, stages, splits, dynamic
    shared memory) at the serving paths' shapes: 8 slots x 2048 tokens in
    pages of 256, 256-token chunks; paged_matmul at qwen3's MLP width."""
    import dataclasses
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hdm_stream import ops as hops
    from repro_torch.kernels.mamba2_scan import ops as sops
    plans = {}
    for arch, h, hkv, d, smax in ((ARCH, 16, 8, 128, MAX_SEQ),
                                  (HYBRID, 32, 32, 80, MAX_SEQ),
                                  (GRANITE, 16, 8, 64, MAX_SEQ),
                                  (MUSICGEN, 32, 32, 64, MUSICGEN_MAX_SEQ),
                                  (VLM, 32, 8, 128, MAX_SEQ)):
        plans[f"paged_decode {arch} bf16"] = dops.plan(
            N_SLOTS, h, hkv, smax, 256, d, torch.bfloat16)
        plans[f"flash_prefill {arch} bf16"] = fops.plan(
            1, CHUNK, h, hkv, d, torch.bfloat16)
    plans[f"paged_decode {ARCH} int8"] = dops.plan(
        N_SLOTS, 16, 8, MAX_SEQ, 256, 128, torch.int8)
    for arch, h, hkv in ((GLM4, 32, 2), (STARCODER2, 48, 4)):
        for dt in (torch.bfloat16, torch.int8):
            plans[f"paged_decode {arch} {str(dt)[6:]}"] = dops.plan(
                N_SLOTS, h, hkv, MAX_SEQ, 256, 128, dt)
        plans[f"flash_prefill {arch} bf16"] = fops.plan(
            1, CHUNK, h, hkv, 128, torch.bfloat16)
    # the tp phase's decode: each rank's 1024 tokens of a slot
    plans[f"paged_decode {TP_PATH} rank"] = dops.plan(
        N_SLOTS, 16, 8, MAX_SEQ // TP_RANKS, 256, 128, torch.bfloat16)
    plans[f"flash_prefill {ARCH} f32"] = fops.plan(
        1, CHUNK, 16, 8, 128, torch.float32)
    plans[f"ssd_scan {HYBRID}"] = sops.plan(1, CHUNK, 80, 64, 64)
    plans[f"paged_decode {GEMMA} bf16"] = dops.plan(
        N_SLOTS, 8, 1, MAX_SEQ, 256, 256, torch.bfloat16)
    plans[f"flash_prefill {GEMMA} bf16"] = fops.plan(
        1, CHUNK, 8, 1, 256, torch.bfloat16)
    plans[f"paged_decode {GEMMA} int8"] = dops.plan(
        N_SLOTS, 8, 1, MAX_SEQ, 256, 256, torch.int8)
    plans[f"flash_prefill {GEMMA} f32"] = fops.plan(
        1, CHUNK, 8, 1, 256, torch.float32)
    for m in (8, CHUNK):
        for dt in (torch.bfloat16, torch.float32):
            plans[f"paged_matmul M={m} {str(dt)[6:]}"] = hops.plan(
                m, MATMUL_K, MATMUL_N, MATMUL_PAGE_K, dt)
    return {k: dataclasses.asdict(p) for k, p in plans.items()}



def ptxas_report(text: str):
    """Each kernel instance's ``-Xptxas -v`` lines from ``build.log``:
    registers and static shared memory ("Used ...") and spills, under
    the demangled kernel name (``c++filt`` where the toolkit has it)."""
    import re
    import shutil
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows.append({"kernel": name, "used": "", "spill": ""})
        elif rows and "Used" in line:
            rows[-1]["used"] = line.split(":", 1)[-1].strip()
        elif rows and "spill" in line:
            rows[-1]["spill"] = line.split(":", 1)[-1].strip()
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r["kernel"]
                                                     for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "")
    return rows



def check_decode(dev, hkv, g, d, smax=MAX_SEQ):
    """paged_decode at ``hkv`` kv heads of ``g`` query heads, head_dim
    ``d``, over the serving path's 8 slots of ``smax`` tokens (lengths
    past ``smax`` cut to it); f32 too where the decode kernel has an f32
    instance (a row of at most 32 16-byte chunks: D <= 128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    b, p, page = N_SLOTS, smax // 256, 256
    h = hkv * g
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    kp = torch.randn((b, p, page, hkv, d), generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn((b, p, page, hkv, d), generator=gen,
                     device=dev).bfloat16()
    lens = [min(n, smax) for n in (1, smax, 300, 777, 1024, 1500, 64,
                                   smax - 1)]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    res = {}
    for cap in (0.0, 30.0):
        got = ops.paged_decode(q, kp, vp, kv_len, logit_softcap=cap)
        want = ref.paged_decode_ref(q, kp, vp, kv_len, cap)
        torch.cuda.synchronize()
        res[f"err_softcap{cap:g}"] = check_close(f"paged_decode cap={cap}",
                                                 got, want)
    if d * 4 <= 32 * 16:
        got32 = ops.paged_decode(q.float(), kp.float(), vp.float(), kv_len)
        res["err_f32"] = float((got32 - ref.paged_decode_ref(
            q.float(), kp.float(), vp.float(), kv_len)).abs().max())
        if res["err_f32"] > 1e-4:
            fail(f"paged_decode f32 max abs err {res['err_f32']}")
    res["bitwise_repeats"] = check_repeatable(
        "paged_decode", lambda: ops.paged_decode(q, kp, vp, kv_len),
        lambda: ops.paged_decode(q, kp, vp, kv_len, logit_softcap=30.0))
    # SDPA yardstick: the same function, per-slot length as a boolean mask
    # and the kv heads expanded to the query heads beforehand (untimed)
    mask = (torch.arange(smax, device=dev)[None] < kv_len[:, None].long()
            )[:, None, None, :]
    qs = q.transpose(1, 2)                                  # [B, H, 1, D]
    ks, vs = (t.view(b, smax, hkv, d).transpose(1, 2)
              .repeat_interleave(g, dim=1) for t in (kp, vp))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    got = ops.paged_decode(q, kp, vp, kv_len)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = device_ms(lambda: ops.paged_decode(q, kp, vp, kv_len), 50)
    res["call_ms"] = time_ms(lambda: ops.paged_decode(q, kp, vp, kv_len), 50)
    res["plain_ms"] = time_ms(
        lambda: ref.paged_decode_ref(q, kp, vp, kv_len), 10)
    res["library_ms"] = device_ms(sdpa, 50)
    tokens = sum(min(n, smax) for n in lens)
    n_bytes = (2 * tokens * hkv * d * 2 + 2 * q.numel() * 2
               + kv_len.numel() * 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * tokens * h * d)
    res["max_abs_err"] = res["err_softcap0"]
    # the instance runs ``group_pad`` query rows per CTA, ``group_chunks``
    # CTAs per kv head: g of those rows real, the rest padding (G 4 runs
    # the 8-row instance; G 12 two CTAs of 6 rows on it)
    pl = ops.plan(b, h, hkv, smax, page, d, torch.bfloat16)
    res["group_pad"], res["group_chunks"] = pl.group_pad, pl.group_chunks
    res["padded_rows_share"] = 1 - g / (pl.group_pad * pl.group_chunks)
    res["shape"] = (f"q [{b},1,{h},{d}] bf16, pages [{b},{p},{page},{hkv},"
                    f"{d}], kv_len {lens}")
    return res


def check_decode_int8(dev, hkv, g, d):
    """paged_decode's int8 mode at ``hkv`` kv heads of ``g`` query heads,
    head_dim ``d``, over the serving path's 8 slots of 2048 tokens: codes
    quantized from random bf16 K/V with ``kv_quant.requantize_pages``, the
    new token's K/V at ``pos = kv_len - 1``. Also times the bf16 mode at the
    same shapes, and dequantize + SDPA as the library yardstick (no single
    PyTorch call reads int8 pages)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import kv_quant
    b, p, page = N_SLOTS, MAX_SEQ // 256, 256
    h, smax = hkv * g, p * page
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    init = torch.full((b, p, hkv), kv_quant.INIT_SCALE, device=dev)
    pages, new = {}, {}
    for name in ("k", "v"):
        x = torch.randn((b, p, page, hkv, d), generator=gen,
                        device=dev).bfloat16()
        pages[name] = kv_quant.requantize_pages(x, init)
        new[name] = torch.randn((b, 1, hkv, d), generator=gen,
                                device=dev).bfloat16()
    (kc, ks), (vc, vs) = pages["k"], pages["v"]
    lens = [1, smax, 300, 777, 1024, 1500, 64, smax - 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = kv_len - 1
    args = dict(k_scale=ks, v_scale=vs, new_k=new["k"], new_v=new["v"],
                pos=pos)
    res = {}
    for cap in (0.0, 30.0):
        got = ops.paged_decode(q, kc, vc, logit_softcap=cap, **args)
        want = ref.paged_decode_int8_ref(q, kc, vc, ks, vs, new["k"],
                                         new["v"], pos, cap)
        torch.cuda.synchronize()
        res[f"err_softcap{cap:g}"] = check_close(
            f"paged_decode int8 cap={cap}", got, want)
    a32 = dict(args, new_k=new["k"].float(), new_v=new["v"].float())
    got32 = ops.paged_decode(q.float(), kc, vc, **a32)
    res["err_f32"] = float((got32 - ref.paged_decode_int8_ref(
        q.float(), kc, vc, ks, vs, a32["new_k"], a32["new_v"], pos)
                            ).abs().max())
    if res["err_f32"] > 1e-4:
        fail(f"paged_decode int8 f32 max abs err {res['err_f32']}")
    res["bitwise_repeats"] = check_repeatable(
        "paged_decode int8", lambda: ops.paged_decode(q, kc, vc, **args),
        lambda: ops.paged_decode(q, kc, vc, logit_softcap=30.0, **args))

    rows = torch.arange(b, device=dev)
    mask = (torch.arange(smax, device=dev)[None] < kv_len[:, None].long()
            )[:, None, None, :]
    qs = q.transpose(1, 2)                                  # [B, H, 1, D]

    def deq_sdpa():
        kv = []
        for c, sc, nw in ((kc, ks, new["k"]), (vc, vs, new["v"])):
            x = kv_quant.dequantize_pages(c, sc, torch.bfloat16).view(
                b, smax, hkv, d)
            x[rows, pos.long()] = nw[:, 0]
            kv.append(x.transpose(1, 2))
        return F.scaled_dot_product_attention(qs, kv[0], kv[1],
                                               attn_mask=mask,
                                               enable_gqa=True)
    got = ops.paged_decode(q, kc, vc, **args)
    res["library_err"] = float((deq_sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = device_ms(lambda: ops.paged_decode(q, kc, vc, **args), 50)
    res["call_ms"] = time_ms(lambda: ops.paged_decode(q, kc, vc, **args), 50)
    res["plain_ms"] = time_ms(lambda: ref.paged_decode_int8_ref(
        q, kc, vc, ks, vs, new["k"], new["v"], pos), 10)
    kb, vb = (kv_quant.dequantize_pages(c, sc, torch.bfloat16)
              for c, sc in ((kc, ks), (vc, vs)))
    res["bf16_mode_ms"] = device_ms(lambda: ops.paged_decode(q, kb, vb,
                                                             kv_len), 50)
    res["library_ms"] = device_ms(deq_sdpa, 20)
    res["library"] = "dequantize_pages + SDPA (two calls)"
    # codes of the visible tokens (1 byte each) and the scales of their
    # pages, read once; q, the new rows and the output in bf16
    tokens = sum(min(n, smax) for n in lens)
    pages_read = sum(-(-min(n, smax) // page) for n in lens)
    n_bytes = (2 * tokens * hkv * d + 2 * pages_read * hkv * 4
               + 2 * q.numel() * 2 + 2 * new["k"].numel() * 2
               + pos.numel() * 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * tokens * h * d)
    res["max_abs_err"] = res["err_softcap0"]
    res["shape"] = (f"q [{b},1,{h},{d}] bf16, codes [{b},{p},{page},{hkv},"
                    f"{d}] int8, scales [{b},{p},{hkv}], pos "
                    f"{[n - 1 for n in lens]}")
    return res


def rank_views(pos, n_ranks, span):
    """Each rank's ``(kv_len, fresh)`` for per-slot ``pos`` over pages of
    ``span`` tokens a rank, as ``models.attention``'s page-sharded decode
    gives them to the kernel."""
    import torch
    out = []
    for r in range(n_ranks):
        off = pos.long() - r * span
        out.append(((off + 1).clamp(0, span).to(torch.int32),
                    torch.where((off >= 0) & (off < span), off, -1)
                    .to(torch.int32)))
    return out


# the rank views check_decode_ml times (Hkv, G, D, slot tokens) -> the
# key of their result: the tp paths' heads (qwen3; granite; zamba2's
# shared block; musicgen over 1024-token slots; the VLM at G 4)
ML_TIMED = {(8, 2, 128, MAX_SEQ): "", (8, 2, 64, MAX_SEQ): " d64",
            (32, 1, 80, MAX_SEQ): " d80",
            (32, 1, 64, MUSICGEN_MAX_SEQ): " d64 s1024",
            (8, 4, 128, MAX_SEQ): " g4"}


def check_decode_ml(dev):
    """paged_decode's ``return_ml`` output (f32 o, base-2 m, l), both
    modes, against the plain versions' on each rank's view of a cache
    split over two ranks (its pages, its local length, 0 after the owner;
    the int8 new row only on the owner): at the tp paths' heads (qwen3's
    Hkv 8, G 2, D 128; granite's D 64; zamba2's Hkv 32, G 1, D 80;
    musicgen's D 64, G 1 over 1024-token slots; the VLM's G 4) and at G
    16 and G 12, bf16 q; o at f32's 1e-4, m and l at 1e-4
    relative (m = -inf and l = 0 where a rank sees no token). The two
    ranks' partials combined as ``models.attention.combine_partials``
    does must give the one-rank decode (TOL). Timed at the tp paths'
    shapes (``ML_TIMED``: a rank's half of 8 slots; qwen3's heads in both
    modes, the others in bf16), beside SDPA over the same keys (output
    only: no PyTorch call returns m and l)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import kv_quant
    b, page = N_SLOTS, 256
    gen = torch.Generator(device=dev).manual_seed(9)
    f32_tol = dict(atol=1e-4, rtol=1e-4)
    res = {"errs": {}}
    for hkv, g, d, smax in ((8, 2, 128, MAX_SEQ), (2, 16, 128, MAX_SEQ),
                            (4, 12, 128, MAX_SEQ), (8, 2, 64, MAX_SEQ),
                            (32, 1, 80, MAX_SEQ),
                            (32, 1, 64, MUSICGEN_MAX_SEQ),
                            (8, 4, 128, MAX_SEQ)):
        p = smax // page
        span = smax // TP_RANKS
        local = slice(0, p // TP_RANKS)
        pos = torch.tensor([0, 1, 300, span - 1, span, span + 476,
                            smax - 2, smax - 1], dtype=torch.int32,
                           device=dev)
        res.setdefault("pos", {})[smax] = pos.tolist()
        h = hkv * g
        tag = f"g{g}" if d == 128 else f"g{g} d{d}"
        q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
        kp, vp = (torch.randn((b, p, page, hkv, d), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        nk, nv = (torch.randn((b, 1, hkv, d), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        init = torch.full((b, p, hkv), kv_quant.INIT_SCALE, device=dev)
        (kc, ks), (vc, vs) = (kv_quant.requantize_pages(x, init)
                              for x in (kp, vp))
        views = rank_views(pos, TP_RANKS, span)
        for mode in ("bf16", "int8"):
            parts = []
            for r, (kv_len, fresh) in enumerate(views):
                pages = slice(r * p // TP_RANKS, (r + 1) * p // TP_RANKS)
                if mode == "bf16":
                    args = (q, kp[:, pages].contiguous(),
                            vp[:, pages].contiguous(), kv_len)
                    got = ops.paged_decode(*args, return_ml=True)
                    want = ref.paged_decode_ref(*args, return_ml=True)
                else:
                    cut = [t[:, pages].contiguous() for t in (kc, vc, ks, vs)]
                    got = ops.paged_decode(
                        q, cut[0], cut[1], kv_len, k_scale=cut[2],
                        v_scale=cut[3], new_k=nk, new_v=nv, fresh=fresh,
                        return_ml=True)
                    want = ref.paged_decode_int8_ref(
                        q, cut[0], cut[1], cut[2], cut[3], nk, nv, None,
                        kv_len=kv_len, fresh=fresh, return_ml=True)
                torch.cuda.synchronize()
                name = f"{tag} {mode} rank {r}"
                (o, m, l), (wo, wm, wl) = got, want
                live = torch.isfinite(wm)
                if not (torch.equal(torch.isfinite(m), live)
                        and not l[~live].any()
                        and not o.reshape(b, h, d)[~live].any()):
                    fail(f"paged_decode ml {name}: a rank without a token "
                         f"must give m -inf, l 0, o 0")
                res["errs"][name] = check_close(f"paged_decode ml {name} o",
                                                o, wo, f32_tol)
                check_close(f"paged_decode ml {name} m", m[live], wm[live],
                            f32_tol)
                check_close(f"paged_decode ml {name} l", l[live] / wl[live],
                            torch.ones_like(wl[live]), f32_tol)
                parts.append(got)
            m_g = torch.maximum(parts[0][1], parts[1][1])
            w = [pl_ * torch.exp2(pm - m_g) for _, pm, pl_ in parts]
            comb = (sum(po * wi[:, None, :, None] for (po, _, _), wi
                        in zip(parts, w)) / sum(w)[:, None, :, None])
            one = (ops.paged_decode(q, kp, vp, (pos + 1).to(torch.int32))
                   if mode == "bf16" else
                   ops.paged_decode(q, kc, vc, k_scale=ks, v_scale=vs,
                                    new_k=nk, new_v=nv, pos=pos))
            res["errs"][f"{tag} {mode} combined"] = check_close(
                f"paged_decode ml {tag} {mode}: two ranks combined vs one",
                comb.to(one.dtype), one)
        key = ML_TIMED.get((hkv, g, d, smax))
        if key is None:
            continue
        # timings at the tp paths' shapes: rank 0's pages
        kv_len, fresh = views[0]
        mask = (torch.arange(span, device=dev)[None]
                < kv_len[:, None].long())[:, None, None, :]
        qs = q.transpose(1, 2)
        for mode in ("bf16", "int8") if key == "" else ("bf16",):
            if mode == "bf16":
                kl, vl = (t[:, local].contiguous() for t in (kp, vp))

                def call():
                    return ops.paged_decode(q, kl, vl, kv_len,
                                            return_ml=True)

                def plain():
                    return ref.paged_decode_ref(q, kl, vl, kv_len,
                                                return_ml=True)
                ks_, vs_ = (t.view(b, span, hkv, d).transpose(1, 2)
                            .repeat_interleave(g, dim=1) for t in (kl, vl))

                def library():
                    return F.scaled_dot_product_attention(
                        qs, ks_, vs_, attn_mask=mask)
                kv_bytes = kp.element_size()
            else:
                cut = [t[:, local].contiguous() for t in (kc, vc, ks, vs)]

                def call():
                    return ops.paged_decode(
                        q, cut[0], cut[1], kv_len, k_scale=cut[2],
                        v_scale=cut[3], new_k=nk, new_v=nv, fresh=fresh,
                        return_ml=True)

                def plain():
                    return ref.paged_decode_int8_ref(
                        q, cut[0], cut[1], cut[2], cut[3], nk, nv, None,
                        kv_len=kv_len, fresh=fresh, return_ml=True)

                def library():
                    kv = [kv_quant.dequantize_pages(c, sc, q.dtype)
                          .view(b, span, hkv, d).transpose(1, 2)
                          for c, sc in ((cut[0], cut[2]), (cut[1], cut[3]))]
                    return F.scaled_dot_product_attention(
                        qs, kv[0], kv[1], attn_mask=mask, enable_gqa=True)
                kv_bytes = 1
            tokens = int(kv_len.sum())
            n_bytes = (2 * tokens * hkv * d * kv_bytes
                       + q.numel() * q.element_size() + q.numel() * 4
                       + b * h * 8 + 2 * b * 4)
            if mode == "int8":
                n_bytes += (2 * nk.numel() * nk.element_size() + 2 * sum(
                    -(-int(n) // page) for n in kv_len) * hkv * 4)
            out = {"ms": device_ms(call, 50), "plain_ms": time_ms(plain, 10),
                   "library_ms": device_ms(library, 20),
                   "library": ("SDPA" if mode == "bf16" else
                               "dequantize_pages + SDPA (two calls)")
                   + " over the rank's keys, output only"}
            out["bound_ms"], out["bound_by"] = bound(n_bytes,
                                                     4 * tokens * h * d)
            out["max_abs_err"] = max(v for k, v in res["errs"].items()
                                     if k.startswith(f"{tag} {mode} rank"))
            out["shape"] = (f"q [{b},1,{h},{d}] bf16, a rank's pages "
                            f"[{b},{p // TP_RANKS},{page},{hkv},{d}] "
                            f"{mode}, kv_len {kv_len.tolist()}; out f32 + "
                            f"m, l")
            res[mode + key] = out
    return res


def check_decode_dp_view(dev):
    """paged_decode's ``return_ml`` output at a rank's view of the dp
    path, mesh (2, 2): its data row's 4 of the 8 slots and its model
    rank's half of their pages (qwen3's Hkv 8, G 2, D 128, 1024 of 2048
    tokens), bf16 q, against the plain version (o at f32's 1e-4, m and l
    at 1e-4 relative); the two model ranks' partials combined as
    ``models.attention.combine_partials`` does give the one-rank decode
    of the row's slots (TOL). Timed beside SDPA over the same keys
    (output only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    hkv, g, d, page = 8, 2, 128, 256
    b, h, p = N_SLOTS // DP_MESH[0], hkv * g, MAX_SEQ // page
    span, n = MAX_SEQ // DP_MESH[1], DP_MESH[1]
    gen = torch.Generator(device=dev).manual_seed(10)
    f32_tol = dict(atol=1e-4, rtol=1e-4)
    pos = torch.tensor([1, 300, span + 476, MAX_SEQ - 1], dtype=torch.int32,
                       device=dev)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    kp, vp = (torch.randn((b, p, page, hkv, d), generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    views, parts, errs = rank_views(pos, n, span), [], []
    for r, (kv_len, _) in enumerate(views):
        pages = slice(r * p // n, (r + 1) * p // n)
        args = (q, kp[:, pages].contiguous(), vp[:, pages].contiguous(),
                kv_len)
        got = ops.paged_decode(*args, return_ml=True)
        (o, m, l), (wo, wm, wl) = got, ref.paged_decode_ref(
            *args, return_ml=True)
        live = torch.isfinite(wm)
        if not torch.equal(torch.isfinite(m), live):
            fail(f"paged_decode dp view rank {r}: m's dead rows differ")
        errs.append(check_close(f"paged_decode dp view rank {r} o", o, wo,
                                f32_tol))
        check_close(f"paged_decode dp view rank {r} m", m[live], wm[live],
                    f32_tol)
        check_close(f"paged_decode dp view rank {r} l", l[live] / wl[live],
                    torch.ones_like(wl[live]), f32_tol)
        parts.append(got)
    m_g = torch.maximum(parts[0][1], parts[1][1])
    w = [pl_ * torch.exp2(pm - m_g) for _, pm, pl_ in parts]
    comb = (sum(po * wi[:, None, :, None] for (po, _, _), wi
                in zip(parts, w)) / sum(w)[:, None, :, None])
    one = ops.paged_decode(q, kp, vp, (pos + 1).to(torch.int32))
    combined = check_close("paged_decode dp view: two ranks combined vs one",
                           comb.to(one.dtype), one)
    kv_len = views[0][0]
    kl, vl = (t[:, :p // n].contiguous() for t in (kp, vp))
    mask = (torch.arange(span, device=dev)[None]
            < kv_len[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)
    ks_, vs_ = (t.view(b, span, hkv, d).transpose(1, 2)
                .repeat_interleave(g, dim=1) for t in (kl, vl))
    tokens = int(kv_len.sum())
    n_bytes = (2 * tokens * hkv * d * kp.element_size()
               + q.numel() * q.element_size() + q.numel() * 4 + b * h * 8
               + b * 4)
    out = {"ms": device_ms(lambda: ops.paged_decode(q, kl, vl, kv_len,
                                                    return_ml=True), 50),
           "plain_ms": time_ms(lambda: ref.paged_decode_ref(
               q, kl, vl, kv_len, return_ml=True), 10),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               qs, ks_, vs_, attn_mask=mask), 20),
           "library": "SDPA over the rank's keys, output only",
           "max_abs_err": max(errs), "combined_err": combined,
           "shape": (f"q [{b},1,{h},{d}] bf16, a rank's pages "
                     f"[{b},{p // n},{page},{hkv},{d}] bf16, kv_len "
                     f"{kv_len.tolist()}; out f32 + m, l")}
    out["bound_ms"], out["bound_by"] = bound(n_bytes, 4 * tokens * h * d)
    return out


def check_prefill(dev, hkv, g, d, smax=MAX_SEQ):
    """flash_prefill at ``hkv`` kv heads of ``g`` query heads, head_dim
    ``d``: one 256-token chunk against an ``smax``-token cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    c = CHUNK
    h = hkv * g
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, c, h, d), generator=gen, device=dev).bfloat16()
    kc = torch.randn((1, smax, hkv, d), generator=gen, device=dev).bfloat16()
    vc = torch.randn((1, smax, hkv, d), generator=gen, device=dev).bfloat16()
    res = {}
    for p0 in (0, 300):
        pos = torch.tensor([p0], dtype=torch.int32, device=dev)
        for cap in (0.0, 30.0):
            got = ops.flash_prefill(q, kc, vc, pos, logit_softcap=cap)
            want = ref.flash_prefill_ref(q, kc, vc, pos, cap)
            torch.cuda.synchronize()
            res[f"err_pos{p0}_softcap{cap:g}"] = check_close(
                f"flash_prefill pos={p0} cap={cap}", got, want)
    # ragged chunk and cache length, f32 instantiation
    qr, kr, vr = q[:, :37].float(), kc[:, :1000].float(), vc[:, :1000].float()
    pr = torch.tensor([951], dtype=torch.int32, device=dev)
    res["err_ragged_f32"] = float((ops.flash_prefill(qr, kr, vr, pr)
                                   - ref.flash_prefill_ref(qr, kr, vr, pr)
                                   ).abs().max())
    if res["err_ragged_f32"] > 1e-4:
        fail(f"flash_prefill ragged f32 err {res['err_ragged_f32']}")
    # timings at the mid-prompt chunk (offset 300, not a block multiple)
    p0 = 300
    pos = torch.tensor([p0], dtype=torch.int32, device=dev)
    got = ops.flash_prefill(q, kc, vc, pos)
    mask = (torch.arange(smax, device=dev)[None]
            <= p0 + torch.arange(c, device=dev)[:, None])   # [C, Smax]
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["call_ms"] = time_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = device_ms(sdpa, 20)
    # other plans of the tensor-core kernel on the same inputs: rows per
    # CTA (CTAs) and ring depth against the plan's choice
    want = ref.flash_prefill_ref(q, kc, vc, pos)
    res["plans_ms"] = {}
    for rows, stages in ((16, 2), (16, 3), (16, 4), (32, 3), (64, 3)):
        alt = ops.mma_plan(1, c, h, hkv, d, rows, stages)
        check_close(f"flash_prefill rows={rows} stages={stages}",
                    ops.launch(q, kc, vc, pos, 0.0, alt), want)
        res["plans_ms"][f"rows{rows} stages{stages} ctas{alt.grid[0] * hkv}"
                        ] = device_ms(lambda p=alt: ops.launch(
                            q, kc, vc, pos, 0.0, p), 20)
    visible = sum(p0 + i + 1 for i in range(c))          # (query, key) pairs
    n_bytes = (2 * (p0 + c) * hkv * d * 2 + 2 * q.numel() * 2 + 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * visible * h * d)
    res["max_abs_err"] = res["err_pos300_softcap0"]
    res["shape"] = (f"q [1,{c},{h},{d}] bf16, cache [1,{smax},{hkv},{d}], "
                    f"pos {p0} (also 0)")
    return res


def check_decode_edges(dev):
    """paged_decode's split and tile edges, both modes: slots of length
    (or pos + 1) 1, 255, 256, 257 and Smax around the 256-token split at
    G = 1 and G = 8 (MAX_GROUP) query heads per kv head, D 128; bf16 at
    TOL and f32 at 1e-4. The int8 mode also puts the fresh row on the
    first and the last row of a tile (the plan's tile) and past the cache
    (pos >= Smax, clamped to its last row). Also G = 4 (the VLM's group,
    on the 8-row instance with half its rows padding), and G 12 and 16
    (starcoder2-15b's and glm4-9b's groups, split over two CTAs)."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import kv_quant
    p, page, d = MAX_SEQ // 256, 256, 128
    smax = p * page
    gen = torch.Generator(device=dev).manual_seed(6)
    f32_tol = dict(atol=1e-4, rtol=1e-4)
    res = {}
    lens = [1, 255, 256, 257, smax]
    for hkv, g in ((8, 1), (8, 4), (2, ops.MAX_GROUP), (4, 12), (2, 16)):
        h = hkv * g
        tile = ops.plan(1, h, hkv, smax, page, d, torch.int8).tile
        pos8 = [0, 254, 255, 256, smax - 1, 3 * tile, 3 * tile - 1, smax,
                smax + 7]
        b = max(len(lens), len(pos8))
        q = torch.randn((b, 1, h, d), generator=gen, device=dev)
        kp, vp = (torch.randn((b, p, page, hkv, d), generator=gen,
                              device=dev) for _ in range(2))
        kv_len = torch.tensor(lens + [smax] * (b - len(lens)),
                              dtype=torch.int32, device=dev)
        for name, dt, tol in (("bf16", torch.bfloat16, TOL),
                              ("f32", torch.float32, f32_tol)):
            qd, kd, vd = q.to(dt), kp.to(dt), vp.to(dt)
            for cap in (0.0, 30.0):
                got = ops.paged_decode(qd, kd, vd, kv_len, logit_softcap=cap)
                want = ref.paged_decode_ref(qd, kd, vd, kv_len, cap)
                torch.cuda.synchronize()
                res[f"g{g}_{name}_softcap{cap:g}"] = check_close(
                    f"paged_decode edges G={g} {name} cap={cap}", got, want,
                    tol)
        init = torch.full((b, p, hkv), kv_quant.INIT_SCALE, device=dev)
        (kc, ks), (vc, vs) = (kv_quant.requantize_pages(x.bfloat16(), init)
                              for x in (kp, vp))
        nk, nv = (torch.randn((b, 1, hkv, d), generator=gen, device=dev)
                  for _ in range(2))
        pos = torch.tensor(pos8 + [smax - 1] * (b - len(pos8)),
                           dtype=torch.int32, device=dev)
        for name, dt, tol in (("bf16", torch.bfloat16, TOL),
                              ("f32", torch.float32, f32_tol)):
            qd, nkd, nvd = q.to(dt), nk.to(dt), nv.to(dt)
            got = ops.paged_decode(qd, kc, vc, k_scale=ks, v_scale=vs,
                                   new_k=nkd, new_v=nvd, pos=pos)
            want = ref.paged_decode_int8_ref(qd, kc, vc, ks, vs, nkd, nvd,
                                             pos)
            torch.cuda.synchronize()
            res[f"g{g}_int8_{name}"] = check_close(
                f"paged_decode int8 edges G={g} {name}", got, want, tol)
        res[f"g{g}_int8_pos"] = pos8
    res["kv_len"] = lens
    return res


def check_prefill_edges(dev):
    """flash_prefill's edges in bf16 (TOL) on the tensor-core instances: a
    ragged 37-token chunk with pos near Smax - C (ending at Smax, and 5
    tokens past it, where the limit clamps to Smax - 1) beside a row at
    pos 0, at G = 1 (zamba2's D 80), G = 2 (qwen3's D 128), G = 4 (the
    VLM's D 128), G = 8 (MAX_GROUP), D 64, and D 256 at G = 1 and 8
    (gemma-2b's, on the D 256
    instance); softcap 30; and f32 at the same shapes (1e-4): the 3xTF32
    tensor-core kernels, at D 256 the one with four warps on the head
    dim's quarters."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    smax = MAX_SEQ
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}
    for hkv, g, d in ((32, 1, 80), (8, 2, 128), (8, 4, 128), (2, 8, 128),
                      (8, 2, 64), (8, 1, 256), (1, 8, 256)):
        h = hkv * g
        kc, vc = (torch.randn((2, smax, hkv, d), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        for c, p0 in ((37, smax - 37), (37, smax - 32), (37, 1000),
                      (CHUNK, 300)):
            q = torch.randn((2, c, h, d), generator=gen,
                            device=dev).bfloat16()
            pos = torch.tensor([p0, 0], dtype=torch.int32, device=dev)
            for cap in (0.0, 30.0):
                got = ops.flash_prefill(q, kc, vc, pos, logit_softcap=cap)
                want = ref.flash_prefill_ref(q, kc, vc, pos, cap)
                torch.cuda.synchronize()
                res[f"g{g}_d{d}_c{c}_pos{p0}_softcap{cap:g}"] = check_close(
                    f"flash_prefill edges G={g} D={d} C={c} pos={p0} "
                    f"cap={cap}", got, want)
            if c == 37:
                q32, k32, v32 = q.float(), kc.float(), vc.float()
                res[f"g{g}_d{d}_c{c}_pos{p0}_f32"] = check_close(
                    f"flash_prefill edges f32 G={g} D={d} C={c} pos={p0}",
                    ops.flash_prefill(q32, k32, v32, pos),
                    ref.flash_prefill_ref(q32, k32, v32, pos),
                    dict(atol=1e-4, rtol=1e-4))
    return res


# the parent's C entries as parent_prefill and parent_matmul call them
# (P pointer, I int, F float): the commit before the f32 redesign, whose
# paged_matmul takes a plan (instance 0: the scalar kernel)
PARENT_SIGNATURES = {"repro_flash_prefill": "PPPPPIIIIIIIFFIIIIP",
                     "repro_paged_matmul": "PPPPPPIIIIIIIIIIIIIP"}


def parent_signatures(build_py):
    """The ``_SIGNATURES`` table of a checkout's ``kernels/build.py``, read
    with ``ast`` (not imported), as strings of P / I / F."""
    import ast
    from pathlib import Path
    tree = ast.parse(Path(build_py).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_SIGNATURES"
                for t in node.targets):
            table = eval(compile(ast.Expression(node.value), str(build_py),
                                 "eval"), {"__builtins__": {}},
                         {"_P": "P", "_I": "I", "_F": "F"})
            return {name: "".join(args) for name, args in table.items()}
    fail(f"{build_py}: no _SIGNATURES table")


def parent_library(parent):
    """The flash_prefill and paged_matmul kernels of the commit before
    their f32 redesign (the scalar flash_prefill instance at f32 D 256, the
    scalar paged_matmul instance in f32), built from ``parent`` -- a
    checkout of that commit (``--parent DIR``) -- into a second library so
    that this run times old and new on the same card. None without it.
    Fails unless the checkout's C entries take the arguments that
    ``parent_prefill`` and ``parent_matmul`` pass and both f32 instances
    are still its scalar kernels."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import build
    if parent is None:
        return None
    pkg = Path(parent) / "src" / "repro_torch"
    csrc = pkg / "csrc"
    if not (csrc / "paged_matmul.cu").exists():
        fail(f"--parent {parent}: no src/repro_torch/csrc/paged_matmul.cu")
    sigs = parent_signatures(pkg / "kernels" / "build.py")
    for name, want in PARENT_SIGNATURES.items():
        if sigs.get(name) != want:
            fail(f"--parent {parent}: {name} takes {sigs.get(name)}, not "
                 f"{want}: not the commit before the redesign")
    prefill = (csrc / "flash_prefill.cu").read_text()
    if "REPRO_SCALAR(256)" not in prefill or "tf32_256" in prefill:
        fail(f"--parent {parent}: its f32 prefill at D 256 is not the "
             f"scalar kernel")
    if "_f32_kernel" in (csrc / "paged_matmul.cu").read_text():
        fail(f"--parent {parent}: its f32 paged_matmul is not the scalar "
             f"instance")
    lib = ctypes.CDLL(str(build.build(csrc, ("flash_prefill",
                                             "paged_matmul"))))
    ctype = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    for name, args in PARENT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctype[a] for a in args]
        fn.restype = ctypes.c_int
    return lib


def parent_prefill(lib, q, kc, vc, pos):
    """The parent's flash_prefill at f32 D 256: the scalar kernel's 64-row
    CTAs."""
    import torch
    from repro_torch.kernels import build
    b, c, h, d = q.shape
    _, smax, hkv, _ = kc.shape
    out = torch.empty_like(q)
    rows = 64
    smem = (3 * rows * (d + 1) + rows * (64 + 1)) * 4
    rc = lib.repro_flash_prefill(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, c, h, hkv, smax, d, build.DTYPE_CODES[q.dtype],
        1.0 / d ** 0.5, 0.0,
        -(-c * (h // hkv) // rows), rows, 1, smem,
        build.stream_ptr(q.device))
    build.check(rc, "parent flash_prefill")
    return out


def parent_matmul(lib, x, pool, ids):
    """The parent's f32 paged_matmul: its scalar instance (scalar f32 FMAs
    on 64 x 64 tiles, 32-deep K slices; instance code 0)."""
    import torch
    from repro_torch.kernels import build
    m, k = x.shape
    n_pages, page_k, n = pool.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.repro_paged_matmul(x.data_ptr(), pool.data_ptr(),
                                ids.data_ptr(), y.data_ptr(), 0, 0, m, k, n,
                                page_k, n_pages, build.DTYPE_CODES[x.dtype],
                                0, 64, 64, 32, 1, 1, 0,
                                build.stream_ptr(x.device))
    build.check(rc, "parent paged_matmul")
    return y


def check_prefill_f32(dev):
    """The f32 flash_prefill instance (the 3xTF32 tensor-core kernel the
    int8 path's prefill runs) at the int8 path's chunk, q [1,256,16,128]
    against a 2048-token cache at pos 300 (1e-4): bit-identical over 50
    repeats, timed beside f32 SDPA (TF32 off) as its library time and at
    every plan of the sweep (rows per CTA x stages)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    c, smax, hkv, g, d, p0 = CHUNK, MAX_SEQ, 8, 2, 128, 300
    h = hkv * g
    tol = dict(atol=1e-4, rtol=1e-4)
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, c, h, d), generator=gen, device=dev)
    kc, vc = (torch.randn((1, smax, hkv, d), generator=gen, device=dev)
              for _ in range(2))
    pos = torch.tensor([p0], dtype=torch.int32, device=dev)
    want = ref.flash_prefill_ref(q, kc, vc, pos)
    got = ops.flash_prefill(q, kc, vc, pos)
    res = {"plan": str(ops.plan(1, c, h, hkv, d, torch.float32)),
           "max_abs_err": check_close("flash_prefill f32", got, want, tol)}
    if ops.plan(1, c, h, hkv, d, torch.float32).kernel != "tf32":
        fail("flash_prefill f32 at D 128 is not planned on the TF32 kernel")
    res["err_softcap30"] = check_close(
        "flash_prefill f32 cap=30", ops.flash_prefill(
            q, kc, vc, pos, logit_softcap=30.0),
        ref.flash_prefill_ref(q, kc, vc, pos, 30.0), tol)
    q2 = torch.randn_like(q)
    res["bitwise_repeats"] = check_repeatable(
        "flash_prefill f32", lambda: ops.flash_prefill(q, kc, vc, pos),
        lambda: ops.flash_prefill(q2, kc, vc, pos))
    mask = (torch.arange(smax, device=dev)[None]
            <= p0 + torch.arange(c, device=dev)[:, None])
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    res["library_err"] = float((sdpa().transpose(1, 2) - got).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = device_ms(sdpa, 20)
    res["plans_ms"] = {}
    for rows in (16, 32, 64):
        for stages in (2, 3):
            alt = ops.tf32_plan(1, c, h, hkv, d, rows, stages)
            check_close(f"flash_prefill f32 rows={rows} stages={stages}",
                        ops.launch(q, kc, vc, pos, 0.0, alt), want, tol)
            res["plans_ms"][f"rows{rows} stages{stages} ctas"
                            f"{alt.grid[0] * hkv}"] = device_ms(
                lambda p=alt: ops.launch(q, kc, vc, pos, 0.0, p), 20)
    visible = sum(p0 + i + 1 for i in range(c))
    n_bytes = 4 * (2 * (p0 + c) * hkv * d + 2 * q.numel()) + 4
    flops = 4 * visible * h * d
    res["bound_ms"], res["bound_by"] = bound(
        n_bytes, TF32_PRODUCTS * flops, TF32_FLOPS)
    res["bound_f32_fma_ms"] = bound(n_bytes, flops, F32_FLOPS)[0]
    res["shape"] = (f"q [1,{c},{h},{d}] f32, cache [1,{smax},{hkv},{d}], "
                    f"pos {p0}")
    return res


def gemma_chunk(dev, dtype, seed=8, d=256):
    """gemma-2b's prefill chunk: q [1,256,8,d] over one kv head (d 256,
    its head_dim), a 2048-token cache, pos 300; with SDPA on the same
    inputs (the kv head expanded beforehand, untimed)."""
    import torch
    import torch.nn.functional as F
    c, smax, hkv, g, p0 = CHUNK, MAX_SEQ, 1, 8, 300
    h = hkv * g
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, c, h, d), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((1, smax, hkv, d), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    pos = torch.tensor([p0], dtype=torch.int32, device=dev)
    mask = (torch.arange(smax, device=dev)[None]
            <= p0 + torch.arange(c, device=dev)[:, None])
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    visible = sum(p0 + i + 1 for i in range(c))
    n_bytes = dtype.itemsize * (2 * (p0 + c) * hkv * d + 2 * q.numel()) + 4
    shape = (f"q [1,{c},{h},{d}] {str(dtype)[6:]}, cache "
             f"[1,{smax},{hkv},{d}], pos {p0}")
    return q, kc, vc, pos, sdpa, n_bytes, 4 * visible * h * d, shape


def check_prefill_d256(dev):
    """The bf16 flash_prefill instance at D 256 (two warps per 16 rows,
    each on half of the head dim), which gemma-2b's prefill runs, at its
    chunk (bf16 2e-2): softcap 0 and 30, pos 0 and 300; bit-identical over
    50 repeats; timed beside SDPA and at every plan of the sweep (rows per
    CTA x stages). Its edge shapes are in ``check_prefill_edges``."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, kc, vc, pos, sdpa, n_bytes, flops, shape = gemma_chunk(
        dev, torch.bfloat16)
    _, c, h, d = q.shape
    hkv = kc.shape[2]
    p = ops.plan(1, c, h, hkv, d, torch.bfloat16)
    if p.kernel != "mma256":
        fail(f"flash_prefill bf16 at D 256 is planned on {p.kernel}")
    res = {"plan": str(p)}
    for p0 in (0, 300):
        pp = torch.tensor([p0], dtype=torch.int32, device=dev)
        for cap in (0.0, 30.0):
            got = ops.flash_prefill(q, kc, vc, pp, logit_softcap=cap)
            want = ref.flash_prefill_ref(q, kc, vc, pp, cap)
            torch.cuda.synchronize()
            res[f"err_pos{p0}_softcap{cap:g}"] = check_close(
                f"flash_prefill D256 pos={p0} cap={cap}", got, want)
    q2 = torch.randn_like(q)
    res["bitwise_repeats"] = check_repeatable(
        "flash_prefill D256", lambda: ops.flash_prefill(q, kc, vc, pos),
        lambda: ops.flash_prefill(q2, kc, vc, pos))
    got = ops.flash_prefill(q, kc, vc, pos)
    want = ref.flash_prefill_ref(q, kc, vc, pos)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = device_ms(sdpa, 20)
    res["plans_ms"] = {}
    for rows, stages in ((16, 2), (16, 3), (32, 2), (32, 3), (64, 2)):
        alt = ops.d256_plan(1, c, h, hkv, rows, stages)
        check_close(f"flash_prefill D256 rows={rows} stages={stages}",
                    ops.launch(q, kc, vc, pos, 0.0, alt), want)
        res["plans_ms"][f"rows{rows} stages{stages} ctas{alt.grid[0]}"] = \
            device_ms(lambda pl=alt: ops.launch(q, kc, vc, pos, 0.0, pl), 20)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, BF16_FLOPS)
    res["max_abs_err"] = res["err_pos300_softcap0"]
    res["shape"] = shape
    return res


def check_prefill_tf32_256(dev, parent):
    """The f32 flash_prefill instance at D 256 (3xTF32; two key groups of
    four warps, each warp on a quarter of the head dim), which gemma-2b's
    prefill over int8 pages runs, at its chunk in f32 (1e-4): softcap 0
    and 30, pos 0 and 300; bit-identical over 50 repeats; timed beside f32
    SDPA (TF32 off), at every plan of the sweep (stages), and beside the
    parent's scalar kernel where ``parent`` is built. Its
    edge shapes are in ``check_prefill_edges``."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, kc, vc, pos, sdpa, n_bytes, flops, shape = gemma_chunk(
        dev, torch.float32)
    _, c, h, d = q.shape
    hkv = kc.shape[2]
    tol = dict(atol=1e-4, rtol=1e-4)
    p = ops.plan(1, c, h, hkv, d, torch.float32)
    if p.kernel != "tf32_256":
        fail(f"flash_prefill f32 at D 256 is planned on {p.kernel}")
    res = {"plan": str(p)}
    for p0 in (0, 300):
        pp = torch.tensor([p0], dtype=torch.int32, device=dev)
        for cap in (0.0, 30.0):
            got = ops.flash_prefill(q, kc, vc, pp, logit_softcap=cap)
            want = ref.flash_prefill_ref(q, kc, vc, pp, cap)
            torch.cuda.synchronize()
            res[f"err_pos{p0}_softcap{cap:g}"] = check_close(
                f"flash_prefill f32 D256 pos={p0} cap={cap}", got, want, tol)
    q2 = torch.randn_like(q)
    res["bitwise_repeats"] = check_repeatable(
        "flash_prefill f32 D256", lambda: ops.flash_prefill(q, kc, vc, pos),
        lambda: ops.flash_prefill(q2, kc, vc, pos))
    got = ops.flash_prefill(q, kc, vc, pos)
    want = ref.flash_prefill_ref(q, kc, vc, pos)
    res["library_err"] = float((sdpa().transpose(1, 2) - got).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = device_ms(sdpa, 20)
    res["plans_ms"] = {}
    for stages in (2, 3):
        alt = ops.tf32_256_plan(1, c, h, hkv, ops.TQ_ROWS, stages)
        check_close(f"flash_prefill f32 D256 stages={stages}",
                    ops.launch(q, kc, vc, pos, 0.0, alt), want, tol)
        res["plans_ms"][f"stages{stages} ctas{alt.grid[0]}"] = device_ms(
            lambda pl=alt: ops.launch(q, kc, vc, pos, 0.0, pl), 20)
    res["parent_ms"] = None
    if parent is not None:
        res["parent_err"] = check_close(
            "parent flash_prefill f32 D256",
            parent_prefill(parent, q, kc, vc, pos), want, tol)
        res["parent_ms"] = device_ms(
            lambda: parent_prefill(parent, q, kc, vc, pos), 20)
        res["ms_again"] = device_ms(
            lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["bound_ms"], res["bound_by"] = bound(
        n_bytes, TF32_PRODUCTS * flops, TF32_FLOPS)
    res["bound_f32_fma_ms"] = bound(n_bytes, flops, F32_FLOPS)[0]
    res["max_abs_err"] = res["err_pos300_softcap0"]
    res["shape"] = shape
    return res


def check_prefill_scalar(dev):
    """The scalar flash_prefill instance, which only the head dims without
    a tensor-core instance run (D 16 and 32, the smoke models'), at
    gemma-2b's chunk geometry with D 32 in f32 (1e-4), timed beside f32
    SDPA (TF32 off). No full-width path runs it."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, kc, vc, pos, sdpa, n_bytes, flops, shape = gemma_chunk(
        dev, torch.float32, d=32)
    _, c, h, d = q.shape
    if ops.plan(1, c, h, kc.shape[2], d, torch.float32).kernel != "scalar":
        fail("flash_prefill f32 at D 32 is not planned on the scalar "
             "kernel")
    got = ops.flash_prefill(q, kc, vc, pos)
    res = {"max_abs_err": check_close(
        "flash_prefill scalar f32 D=32", got,
        ref.flash_prefill_ref(q, kc, vc, pos), dict(atol=1e-4, rtol=1e-4))}
    res["library_err"] = float((sdpa().transpose(1, 2) - got).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = device_ms(sdpa, 20)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, F32_FLOPS)
    res["shape"] = shape
    return res


def check_ssd(dev, h=80, sweep=True):
    """ssd_scan at zamba2-2.7b's widths (B 1, H 80, P = N = 64; H 40 is a
    rank's heads on the tp 2 path) from a
    nonzero state: a 256-token prefill chunk and a ragged 44-token one,
    ``y`` and ``h_last`` against the plain chunked form at the kernel's
    own sub-chunk (f32, 1e-4), and from a zero state; the chain
    bit-identical over 50 repeats; timed at the plan and, with ``sweep``,
    at the other split counts. No
    single PyTorch call computes the SSD, so there is no library time."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops, ref
    b, p, n = 1, 64, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    h0 = torch.randn((b, h, p, n), generator=gen, device=dev)
    res, inputs = {"plan": str(ops.plan(b, CHUNK, h, p, n))}, {}
    for s in (CHUNK, 44):
        xdt = torch.randn((b, s, h, p), generator=gen, device=dev)
        bm = torch.randn((b, s, n), generator=gen, device=dev) * 0.5
        cm = torch.randn((b, s, n), generator=gen, device=dev) * 0.5
        la = -torch.rand((b, s, h), generator=gen, device=dev) * 0.2
        inputs[s] = (xdt, bm, cm, la)
        y, h_last = ops.ssd(xdt, bm, cm, la, h0=h0)
        y_ref, h_ref = ref.ssd_chunked_ref(xdt, bm, cm, la, h0,
                                           chunk=ops.KERNEL_CHUNK)
        torch.cuda.synchronize()
        res[f"err_y_s{s}"] = check_close(f"ssd_scan y S={s}", y, y_ref,
                                         SSD_TOL)
        res[f"err_h_s{s}"] = check_close(f"ssd_scan h_last S={s}", h_last,
                                         h_ref, SSD_TOL)
    xdt, bm, cm, la = inputs[CHUNK]
    y_ref, h_ref = ref.ssd_chunked_ref(xdt, bm, cm, la, h0,
                                       chunk=ops.KERNEL_CHUNK)
    y0, h00 = ops.ssd(xdt, bm, cm, la)                  # h0 = None: zero
    z_ref = ref.ssd_chunked_ref(xdt, bm, cm, la, None,
                                chunk=ops.KERNEL_CHUNK)
    res["err_y_zero_h0"] = check_close("ssd_scan y h0=0", y0, z_ref[0],
                                       SSD_TOL)
    res["err_h_zero_h0"] = check_close("ssd_scan h_last h0=0", h00,
                                       z_ref[1], SSD_TOL)
    h0b = torch.randn_like(h0)
    res["bitwise_repeats"] = check_repeatable(
        "ssd_scan", lambda: torch.cat([t.flatten() for t in ops.ssd(
            xdt, bm, cm, la, h0=h0)]),
        lambda: ops.ssd(xdt, bm, cm, la, h0=h0b))
    res["ms"] = device_ms(lambda: ops.ssd(xdt, bm, cm, la, h0=h0), 50)
    res["plain_ms"] = time_ms(lambda: ref.ssd_chunked_ref(
        xdt, bm, cm, la, h0, chunk=ops.KERNEL_CHUNK), 10)
    res["library_ms"] = None
    res["plans_ms"] = {}
    for splits in (1, 2, 4) if sweep else ():
        alt = ops.split_plan(b, CHUNK, h, p, n, splits)
        y, h_last = ops.launch(xdt, bm, cm, la, h0, alt)
        check_close(f"ssd_scan y splits={splits}", y, y_ref, SSD_TOL)
        check_close(f"ssd_scan h_last splits={splits}", h_last, h_ref,
                    SSD_TOL)
        res["plans_ms"][f"splits{alt.splits} ctas{alt.splits * h}"] = \
            device_ms(lambda pl=alt: ops.launch(xdt, bm, cm, la, h0, pl), 50)
    # each input read once, each output written once (f32); the
    # recurrence's 4 P N flops per (token, head) as 3 TF32 products
    n_bytes = 4 * (2 * xdt.numel() + bm.numel() + cm.numel() + la.numel()
                   + 2 * h0.numel())
    flops = 4 * b * CHUNK * h * p * n
    res["bound_ms"], res["bound_by"] = bound(
        n_bytes, TF32_PRODUCTS * flops, TF32_FLOPS)
    res["bound_f32_fma_ms"] = bound(n_bytes, flops, F32_FLOPS)[0]
    res["bound_peak"] = (f"{HBM_BYTES_PER_S:.3g} B/s, {TF32_FLOPS:.3g} "
                         f"TF32 flop/s x {TF32_PRODUCTS} products")
    res["max_abs_err"] = max(res["err_y_s256"], res["err_h_s256"])
    res["shape"] = (f"xdt [{b},{CHUNK},{h},{p}] f32 (also S=44), b/c "
                    f"[{b},{CHUNK},{n}], h0 [{b},{h},{p},{n}]")
    return res


def check_refusals(dev):
    """The C entries of flash_prefill, ssd_scan and paged_matmul refuse
    the plans that ``check_plan`` refuses, called directly past it, so
    that the Python and the C limits cannot part unnoticed; nothing is
    launched. Each refused plan is inside the block's shared memory, so
    that only the rule it breaks refuses it."""
    import dataclasses
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hdm_stream import ops as hops
    from repro_torch.kernels.mamba2_scan import ops as sops
    lib = build.library()
    stream = build.stream_ptr(dev)
    out = {}
    tf32 = fops.tf32_plan(1, 256, 16, 8, 64, 32, 2)
    prefill = {   # name: (plan, dtype, D) at q [1,256,16,D]
        "tf32 rows 48": (fops.Plan("tf32", (11, 8, 1), 48, 2,
                                   tf32.smem_bytes), torch.float32, 64),
        "tf32 stages 4": (fops.tf32_plan(1, 256, 16, 8, 64, 32, 4),
                          torch.float32, 64),
        "tf32 smem short": (dataclasses.replace(
            tf32, smem_bytes=tf32.smem_bytes - 16), torch.float32, 64),
        "mma stages 5": (fops.mma_plan(1, 256, 16, 8, 64, 16, 5),
                         torch.bfloat16, 64),
        "mma on f32": (fops.mma_plan(1, 256, 16, 8, 64, 16, 3),
                       torch.float32, 64),
        "scalar rows 32": (fops.Plan("scalar", (16, 8, 1), 32, 1,
                                     fops.scalar_plan(
                                         1, 256, 16, 8, 32).smem_bytes),
                           torch.float32, 32),
        "mma256 rows 48": (fops.Plan("mma256", (11, 8, 1), 48, 2,
                                     fops.d256_plan(1, 256, 16, 8, 64,
                                                    2).smem_bytes),
                           torch.bfloat16, 256),
        "mma256 stages 4": (dataclasses.replace(
            fops.d256_plan(1, 256, 16, 8, 16, 3), stages=4),
            torch.bfloat16, 256),
        "mma256 smem short": (dataclasses.replace(
            fops.d256_plan(1, 256, 16, 8, 16, 3),
            smem_bytes=fops.d256_plan(1, 256, 16, 8, 16, 3).smem_bytes - 16),
            torch.bfloat16, 256),
        "mma256 on f32": (fops.d256_plan(1, 256, 16, 8, 16, 3),
                          torch.float32, 256),
        "scalar at f32 D 256": (fops.scalar_plan(1, 256, 16, 8, 256),
                                torch.float32, 256),
        "tf32_256 rows 32": (fops.tf32_256_plan(1, 256, 16, 8, 32, 2),
                             torch.float32, 256),
        "tf32_256 stages 4": (dataclasses.replace(
            fops.tf32_256_plan(1, 256, 16, 8, 16, 3), stages=4),
            torch.float32, 256),
        "tf32_256 smem short": (dataclasses.replace(
            fops.tf32_256_plan(1, 256, 16, 8, 16, 2),
            smem_bytes=fops.tf32_256_plan(1, 256, 16, 8, 16, 2
                                          ).smem_bytes - 16),
            torch.float32, 256),
        "tf32_256 on bf16": (fops.tf32_256_plan(1, 256, 16, 8, 16, 2),
                             torch.bfloat16, 256)}
    for name, (pl, dtype, d) in prefill.items():
        q = torch.zeros((1, 256, 16, d), dtype=dtype, device=dev)
        kc = torch.zeros((1, MAX_SEQ, 8, d), dtype=dtype, device=dev)
        pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        try:
            fops.check_plan(pl, 1, 256, 16, 8, d, dtype)
            fail(f"flash_prefill check_plan takes plan {name}: {pl}")
        except ValueError:
            pass
        if pl.smem_bytes > fops.MAX_SMEM:
            fail(f"flash_prefill plan {name} does not fit: {pl}")
        out[f"flash_prefill {name}"] = rc = lib.repro_flash_prefill(
            q.data_ptr(), kc.data_ptr(), kc.data_ptr(), pos.data_ptr(),
            torch.empty_like(q).data_ptr(), 1, 256, 16, 8, MAX_SEQ, d,
            build.DTYPE_CODES[dtype], 1.0 / d ** 0.5, 0.0, pl.grid[0],
            pl.rows, pl.stages, pl.smem_bytes, stream)
        if rc == 0:
            fail(f"the flash_prefill C entry takes plan {name}: {pl}")
    good = sops.plan(1, 256, 80, 64, 64)
    ssd = {"spans short": dataclasses.replace(good, splits=3, span=1),
           "a span past S": dataclasses.replace(good, splits=4, span=2)}
    x = torch.zeros((1, 256, 80, 64), device=dev)
    bm = torch.zeros((1, 256, 64), device=dev)
    la = torch.zeros((1, 256, 80), device=dev)
    h = torch.zeros((1, 80, 64, 64), device=dev)
    for name, pl in ssd.items():
        try:
            sops.check_plan(pl, 1, 256, 80, 64, 64)
            fail(f"ssd_scan check_plan takes plan {name}: {pl}")
        except ValueError:
            pass
        part_h = torch.zeros((1, 80, pl.splits, 64, 64), device=dev)
        part_l = torch.zeros((1, 80, pl.splits), device=dev)
        sync = torch.zeros((1, 80, 2 + pl.splits), dtype=torch.int32,
                           device=dev)
        out[f"ssd_scan {name}"] = rc = lib.repro_ssd_scan(
            x.data_ptr(), bm.data_ptr(), bm.data_ptr(), la.data_ptr(),
            h.data_ptr(), torch.empty_like(x).data_ptr(),
            torch.empty_like(h).data_ptr(), part_h.data_ptr(),
            part_l.data_ptr(), sync.data_ptr(), 1, 256, 80, 64, 64,
            pl.splits, pl.span, pl.smem_bytes, stream)
        if rc == 0:
            fail(f"the ssd_scan C entry takes plan {name}: {pl}")
    m, k, n = 8, MATMUL_K, MATMUL_N
    sk = hops.plan(m, k, n, MATMUL_PAGE_K, torch.bfloat16)
    tl = hops.plan(256, k, n, MATMUL_PAGE_K, torch.bfloat16)
    skf = hops.plan(m, k, n, MATMUL_PAGE_K, torch.float32)
    tlf = hops.plan(256, k, n, MATMUL_PAGE_K, torch.float32)
    matmul = {   # name: (plan, M, page_k, dtype)
        "skinny M 17": (sk, 17, MATMUL_PAGE_K, torch.bfloat16),
        "skinny stages 5": (dataclasses.replace(
            sk, stages=5, smem_bytes=sk.smem_bytes // 4 * 5), m,
            MATMUL_PAGE_K, torch.bfloat16),
        "skinny smem short": (dataclasses.replace(
            sk, smem_bytes=sk.smem_bytes - 16), m, MATMUL_PAGE_K,
            torch.bfloat16),
        "skinny splits past tiles": (dataclasses.replace(
            sk, splits=k // sk.tile_k * 2), m, MATMUL_PAGE_K,
            torch.bfloat16),
        "skinny tiles across pages": (sk, m, 32, torch.bfloat16),
        "skinny on f32": (sk, m, MATMUL_PAGE_K, torch.float32),
        "tile on M 8": (tl, m, MATMUL_PAGE_K, torch.bfloat16),
        "tile 64x64": (dataclasses.replace(tl, tile_m=64, tile_n=64), 256,
                       MATMUL_PAGE_K, torch.bfloat16),
        "skinny_f32 on bf16": (skf, m, MATMUL_PAGE_K, torch.bfloat16),
        "skinny_f32 M 17": (skf, 17, MATMUL_PAGE_K, torch.float32),
        "skinny_f32 smem short": (dataclasses.replace(
            skf, smem_bytes=skf.smem_bytes - 16), m, MATMUL_PAGE_K,
            torch.float32),
        "tile_f32 on M 8": (tlf, m, MATMUL_PAGE_K, torch.float32),
        "tile_f32 96x64": (dataclasses.replace(tlf, tile_m=96, tile_n=64),
                           256, MATMUL_PAGE_K, torch.float32),
        "tile_f32 smem short": (dataclasses.replace(
            tlf, smem_bytes=tlf.smem_bytes - 16), 256, MATMUL_PAGE_K,
            torch.float32),
        "tile on f32": (tl, 256, MATMUL_PAGE_K, torch.float32),
        "scalar where skinny_f32 runs": (hops.scalar_plan(
            m, k, n, MATMUL_PAGE_K), m, MATMUL_PAGE_K, torch.float32),
        "scalar where tile runs": (hops.scalar_plan(
            256, k, n, MATMUL_PAGE_K), 256, MATMUL_PAGE_K, torch.bfloat16)}
    x = torch.zeros((256, k), dtype=torch.bfloat16, device=dev)
    part = torch.zeros((k // sk.tile_k * 2, 256, n), device=dev)
    counters = torch.zeros((n,), dtype=torch.int32, device=dev)
    for name, (pl, mm, page_k, dtype) in matmul.items():
        try:
            hops.check_plan(pl, mm, k, n, page_k, dtype)
            fail(f"paged_matmul check_plan takes plan {name}: {pl}")
        except ValueError:
            pass
        if pl.smem_bytes > hops.MAX_SMEM:
            fail(f"paged_matmul plan {name} does not fit: {pl}")
        out[f"paged_matmul {name}"] = rc = lib.repro_paged_matmul(
            x.data_ptr(), x.data_ptr(), counters.data_ptr(), x.data_ptr(),
            part.data_ptr(), counters.data_ptr(), mm, k, n, page_k,
            k // page_k, build.DTYPE_CODES[dtype],
            hops.INSTANCE_CODES[pl.instance], pl.tile_m, pl.tile_n,
            pl.tile_k, pl.stages, pl.splits, pl.smem_bytes, stream)
        if rc == 0:
            fail(f"the paged_matmul C entry takes plan {name}: {pl}")
    torch.cuda.synchronize(dev)
    return out


def rotating(fn, n):
    """A call that runs ``fn(0)``, ``fn(1)``, ... ``fn(n - 1)``, ``fn(0)``,
    ... in turn: timed through ``device_ms`` with a multiple of ``n``
    calls, each call finds the inputs of the ``n - 1`` calls before it
    between itself and its own last use."""
    state = [0]

    def call():
        i = state[0]
        state[0] = (i + 1) % n
        return fn(i)
    return call


def check_paged_matmul(dev):
    """paged_matmul in bf16 at qwen3-1.7b's MLP width: x [8, 2048] (the
    decode batch, the skinny instance) and [256, 2048] (a prefill chunk,
    the tile instance) against 8 logical pages of [256, 6144] drawn by a
    seeded permutation from a pool of 16 (bf16 2e-2). The f32 instances
    are ``check_paged_matmul_f32``'s. The weights are at the models' init
    scale,
    N(0, 0.02^2), so that y is O(1) as in a layer: f32 sums of 2048
    products taken in another order than cuBLAS's part by ~1e-4 when y is
    O(50), as unit-variance weights make it. Bit-identical over 50
    repeats at both M. Times with the weight cold in L2, as a
    weight-streaming caller finds it: each call reads another of
    MATMUL_POOLS pools (25 MB of pages each, MATMUL_POOLS - 1 others
    between two uses against the card's 50 MB of L2), for the kernel,
    every plan of its sweep and cuBLAS ``torch.matmul`` on the
    pre-gathered weight (the library time); the warm times (one pool)
    beside them, named as such."""
    import torch
    from repro_torch.kernels.hdm_stream import ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    pools = [(torch.randn((MATMUL_POOL, MATMUL_PAGE_K, MATMUL_N),
                          generator=gen, device=dev) * 0.02).bfloat16()
             for _ in range(MATMUL_POOLS)]
    n_k = MATMUL_K // MATMUL_PAGE_K
    ids = torch.randperm(MATMUL_POOL, generator=torch.Generator(
    ).manual_seed(SEED))[:n_k].to(dev, torch.int32)
    ws = [pl[ids.long()].reshape(MATMUL_K, MATMUL_N) for pl in pools]
    pool, w = pools[0], ws[0]
    n = MATMUL_POOLS
    res = {"page_ids": ids.tolist(), "cold_pools": n,
           "cold_bytes_between_uses": (n - 1) * ws[0].numel() * 2}
    for m in (8, 256):
        x = torch.randn((m, MATMUL_K), generator=gen, device=dev).bfloat16()
        p = ops.plan(m, MATMUL_K, MATMUL_N, MATMUL_PAGE_K, torch.bfloat16)
        got = ops.stream_matmul(x, pool, ids)
        want = ref.paged_matmul_ref(x, pool, ids)
        torch.cuda.synchronize()
        r = {"plan": str(p),
             "err": check_close(f"paged_matmul bf16 M={m}", got, want)}
        x2 = torch.randn_like(x)
        r["bitwise_repeats"] = check_repeatable(
            f"paged_matmul M={m}", lambda: ops.stream_matmul(x, pool, ids),
            lambda: ops.stream_matmul(x2, pool, ids))
        r["ms"] = device_ms(rotating(
            lambda i: ops.stream_matmul(x, pools[i], ids), n), 4 * n)
        r["warm_ms"] = device_ms(lambda: ops.stream_matmul(x, pool, ids), 20)
        r["plain_ms"] = time_ms(
            lambda: ref.paged_matmul_ref(x, pool, ids), 10)
        r["library_ms"] = device_ms(rotating(
            lambda i: torch.matmul(x, ws[i]), n), 4 * n)
        r["library_warm_ms"] = device_ms(lambda: torch.matmul(x, w), 20)
        r["library_err"] = float((torch.matmul(x, w).float()
                                  - got.float()).abs().max())
        # the sweep: K-splits x stages (skinny), block tiles x stages (tile)
        alts = ([ops.skinny_plan(m, MATMUL_K, MATMUL_N, sp, st)
                 for sp in (1, 2, 4, 8) for st in (2, 3, 4)] if m <= 16
                else [ops.tile_plan(m, MATMUL_K, MATMUL_N, tm, tn, st)
                      for tm, tn in ops.TILE_SHAPES for st in (2, 3, 4)])
        r["plans_ms"] = {}
        for alt in alts:
            check_close(f"paged_matmul M={m} {alt}",
                        ops.launch(x, pool, ids, alt), want)
            key = (f"splits{alt.splits} stages{alt.stages}" if m <= 16 else
                   f"tile{alt.tile_m}x{alt.tile_n} stages{alt.stages}")
            r["plans_ms"][f"{key} ctas{alt.grid[0] * alt.grid[1]}"] = \
                device_ms(rotating(lambda i, pl=alt: ops.launch(
                    x, pools[i], ids, pl), n), 4 * n)
        # x and the 8 pages read once, y written once (bf16)
        n_bytes = 2 * (x.numel() + w.numel() + m * MATMUL_N) + 4 * n_k
        r["bound_ms"], r["bound_by"] = bound(n_bytes,
                                             2 * m * MATMUL_K * MATMUL_N)
        res[f"m{m}"] = r
    res.update({k: res["m8"][k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by",
                                          "plans_ms")})
    res["max_abs_err"] = max(res["m8"]["err"], res["m256"]["err"])
    res["shape"] = (f"x [8,{MATMUL_K}] (also [256,{MATMUL_K}]) bf16, "
                    f"w_pages [{MATMUL_POOL},{MATMUL_PAGE_K},{MATMUL_N}], "
                    f"{n_k} page ids, L2 cold ({n} pools)")
    return res


def check_paged_matmul_f32(dev, parent):
    """paged_matmul in f32 at qwen3-1.7b's MLP width, pages and ids drawn
    as in ``check_paged_matmul``: x [8, 2048] on skinny_f32 (FFMA; its
    plain version ``ref.paged_matmul_split_ref`` at the plan's K-splits)
    and [256, 2048] on tile_f32 (3xTF32), both at 3e-5 against
    ``ref.paged_matmul_ref`` and bit-identical over 50 repeats; timed with
    the weight cold in L2 (four pools in turn) and warm, beside f32 cuBLAS
    (TF32 off) on the gathered weight, the parent's scalar instance where
    ``parent`` is built, and every plan of the sweeps (K-splits x stages;
    block tiles x stages). Then the scalar instance, which now runs only
    shapes neither takes, at M = 256 over pages of 32 rows (64 of a pool
    of 128), warm."""
    import torch
    from repro_torch.kernels.hdm_stream import ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    pools = [torch.randn((MATMUL_POOL, MATMUL_PAGE_K, MATMUL_N),
                         generator=gen, device=dev) * 0.02
             for _ in range(MATMUL_POOLS)]
    n_k = MATMUL_K // MATMUL_PAGE_K
    ids = torch.randperm(MATMUL_POOL, generator=torch.Generator(
    ).manual_seed(SEED))[:n_k].to(dev, torch.int32)
    ws = [pl[ids.long()].reshape(MATMUL_K, MATMUL_N) for pl in pools]
    pool, w = pools[0], ws[0]
    n = MATMUL_POOLS
    res = {}
    for m, name in ((8, "skinny_f32"), (256, "tile_f32")):
        x = torch.randn((m, MATMUL_K), generator=gen, device=dev)
        p = ops.plan(m, MATMUL_K, MATMUL_N, MATMUL_PAGE_K, torch.float32)
        if p.instance != name:
            fail(f"paged_matmul f32 M={m} is planned on {p.instance}")
        got = ops.stream_matmul(x, pool, ids)
        want = ref.paged_matmul_ref(x, pool, ids)
        torch.cuda.synchronize()
        r = {"plan": str(p), "max_abs_err": check_close(
            f"paged_matmul f32 M={m}", got, want, F32_TOL)}
        if m <= ops.SKINNY_M:
            r["split_ref_err"] = check_close(
                f"paged_matmul f32 M={m} vs its split sum", got,
                ref.paged_matmul_split_ref(x, pool, ids,
                                           p.tiles_per_split * p.tile_k),
                F32_TOL)
        x2 = torch.randn_like(x)
        r["bitwise_repeats"] = check_repeatable(
            f"paged_matmul f32 M={m}",
            lambda: ops.stream_matmul(x, pool, ids),
            lambda: ops.stream_matmul(x2, pool, ids))
        r["ms"] = device_ms(rotating(
            lambda i: ops.stream_matmul(x, pools[i], ids), n), 4 * n)
        r["warm_ms"] = device_ms(lambda: ops.stream_matmul(x, pool, ids), 20)
        r["plain_ms"] = time_ms(
            lambda: ref.paged_matmul_ref(x, pool, ids), 10)
        r["library_ms"] = device_ms(rotating(
            lambda i: torch.matmul(x, ws[i]), n), 4 * n)
        r["library_warm_ms"] = device_ms(lambda: torch.matmul(x, w), 20)
        r["library_err"] = float((torch.matmul(x, w) - got).abs().max())
        alts = ([ops.skinny_plan(m, MATMUL_K, MATMUL_N, sp, st, torch.float32)
                 for sp in (2, 4, 8) for st in (2, 3, 4)] if m <= 16
                else [ops.tile_plan(m, MATMUL_K, MATMUL_N, tm, tn, st,
                                    torch.float32)
                      for tm, tn in ops.TILE_F32_SHAPES for st in (2, 3)])
        r["plans_ms"] = {}
        for alt in alts:
            check_close(f"paged_matmul f32 M={m} {alt}",
                        ops.launch(x, pool, ids, alt), want, F32_TOL)
            key = (f"splits{alt.splits} stages{alt.stages}" if m <= 16 else
                   f"tile{alt.tile_m}x{alt.tile_n} stages{alt.stages}")
            r["plans_ms"][f"{key} ctas{alt.grid[0] * alt.grid[1]}"] = \
                device_ms(rotating(lambda i, pl=alt: ops.launch(
                    x, pools[i], ids, pl), n), 4 * n)
        r["parent_ms"] = None
        if parent is not None:
            r["parent_err"] = check_close(
                f"parent paged_matmul f32 M={m}",
                parent_matmul(parent, x, pool, ids), want, F32_TOL)
            r["parent_ms"] = device_ms(rotating(
                lambda i: parent_matmul(parent, x, pools[i], ids), n), 4 * n)
            r["parent_warm_ms"] = device_ms(
                lambda: parent_matmul(parent, x, pool, ids), 20)
            r["ms_again"] = device_ms(rotating(
                lambda i: ops.stream_matmul(x, pools[i], ids), n), 4 * n)
        # x and the 8 pages read once, y written once (f32); skinny_f32 on
        # FFMA, tile_f32 as 3 TF32 products per f32 product
        n_bytes = 4 * (x.numel() + w.numel() + m * MATMUL_N) + 4 * n_k
        flops = 2 * m * MATMUL_K * MATMUL_N
        r["bound_ms"], r["bound_by"] = (
            bound(n_bytes, flops, F32_FLOPS) if name == "skinny_f32"
            else bound(n_bytes, TF32_PRODUCTS * flops, TF32_FLOPS))
        r["shape"] = (f"x [{m},{MATMUL_K}] f32, w_pages [{MATMUL_POOL},"
                      f"{MATMUL_PAGE_K},{MATMUL_N}], {n_k} page ids, L2 "
                      f"cold ({n} pools)")
        res[name] = r
    # the scalar instance: pages of 32 rows (not whole 64-deep K tiles)
    page_k = 32
    small = pools[0].view(-1, page_k, MATMUL_N)          # 128 pages of 32
    sids = torch.randperm(small.shape[0], generator=torch.Generator(
    ).manual_seed(SEED))[:MATMUL_K // page_k].to(dev, torch.int32)
    x = torch.randn((256, MATMUL_K), generator=gen, device=dev)
    if ops.plan(256, MATMUL_K, MATMUL_N, page_k, torch.float32).instance \
            != "scalar":
        fail("paged_matmul f32 over 32-row pages is not planned on the "
             "scalar instance")
    got = ops.stream_matmul(x, small, sids)
    r = {"max_abs_err": check_close(
        "paged_matmul scalar f32 M=256", got,
        ref.paged_matmul_ref(x, small, sids), F32_TOL)}
    sw = small[sids.long()].reshape(MATMUL_K, MATMUL_N)
    r["ms"] = device_ms(lambda: ops.stream_matmul(x, small, sids), 20)
    r["plain_ms"] = time_ms(
        lambda: ref.paged_matmul_ref(x, small, sids), 10)
    r["library_ms"] = device_ms(lambda: torch.matmul(x, sw), 20)
    n_bytes = 4 * (x.numel() + sw.numel() + 256 * MATMUL_N) + 4 * len(sids)
    r["bound_ms"], r["bound_by"] = bound(
        n_bytes, 2 * 256 * MATMUL_K * MATMUL_N, F32_FLOPS)
    r["shape"] = (f"x [256,{MATMUL_K}] f32, w_pages [{small.shape[0]},"
                  f"{page_k},{MATMUL_N}], {len(sids)} page ids, L2 warm")
    res["scalar"] = r
    return res


def check_model_small(dev, arch, kv_quant="none"):
    """The whole model step on the card against the same weights on the
    CPU (plain kernel versions; the CPU tests hold that path to the JAX
    reference): the smoke-size ``arch`` in f32, chunked prefill with a
    ragged last chunk, then decode ticks with ragged per-slot positions.
    Returns the largest logit and cache differences. Tolerances: f32 3e-5
    (tests/test_kernel_parity.py); the recurrent families (the hybrid,
    xLSTM) 1e-4 (tests/test_kernels.py for the SSD), their states held
    relative to their scale (the Mamba2 states are ~1e-6 at smoke size).
    The VLM runs with its cross gates set away from 0 and its vision K/V
    written from random embeddings (``vision_kv``), so that the cross
    layers take part. With int8 pages the codes must be equal but for
    steps of one (counted), the scales within 1e-6 relative and the
    dequantized pages within the tolerance plus one step."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=8, kv_quant=kv_quant)
    cpu = torch.device("cpu")
    params = {cpu: M.init_model(cfg, seed=SEED, device=cpu)}
    caches = {cpu: M.cache_init(cfg, rc, 2, 64, device=cpu)}
    rng = np.random.default_rng(SEED)
    if cfg.family == "vlm":
        emb = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
        for gi, cross in enumerate(params[cpu].cross):
            cross.attn_gate.fill_(0.6)
            cross.mlp_gate.fill_(-0.4)
            k, v = transformer.vision_kv(cross, cfg, emb)
            caches[cpu]["cross_k"][gi], caches[cpu]["cross_v"][gi] = k, v
    params[dev] = copy.deepcopy(params[cpu]).to(dev)
    caches[dev] = {n: ({k: t.to(dev) for k, t in a.items()} if n == "kv"
                       else a.to(dev)) for n, a in caches[cpu].items()}
    lead = (2, cfg.n_codebooks) if cfg.family == "audio" else (2,)
    prompt = rng.integers(1, cfg.vocab_size, lead + (21,)).astype(np.int32)
    steps = [("prefill", prompt[..., s:s + 8]) for s in range(0, 21, 8)]
    steps += [("decode", rng.integers(1, cfg.vocab_size, lead + (1,))
               .astype(np.int32)) for _ in range(4)]
    tol = 1e-4 if cfg.family in ("hybrid", "ssm") else 3e-5
    f32_tol = dict(atol=tol, rtol=tol)
    err = 0.0
    for i, (kind, toks) in enumerate(steps):
        if i == len(steps) - 4:                   # row 1 runs 5 positions on
            for c in caches.values():
                c["pos"][1] += 5
        logits = {}
        for d in params:
            t = torch.from_numpy(toks).to(d)
            fn = M.prefill_step_cached if kind == "prefill" else M.decode_step
            logits[d], caches[d] = fn(params[d], cfg, rc, t, caches[d])
        got, want = logits[dev].cpu(), logits[cpu]
        if not torch.allclose(got, want, **f32_tol):
            fail(f"small {arch} {kind} step {i}: card logits differ from "
                 f"the CPU by {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
    out = {"logits_max_abs_err": err, "steps": len(steps)}
    if kv_quant == "int8":
        out.update(int8_cache_diff(arch, caches[dev]["kv"], caches[cpu]["kv"],
                                   tol))
        return out
    leaves = {n: (caches[dev]["kv"][n], caches[cpu]["kv"][n])
              for n in caches[cpu].get("kv", {})}
    leaves.update({n: (caches[dev][n], caches[cpu][n])
                   for n in caches[cpu] if n not in ("kv", "pos")})
    for n, (got, want) in leaves.items():
        got = got.cpu()
        scale = 1.0 if n in ("k", "v") else float(want.abs().max())
        cache_err = float((got - want).abs().max())
        out[f"{n}_max_abs_err"] = cache_err
        if scale == 0.0 or not torch.allclose(
                got, want, atol=tol * scale, rtol=tol):
            fail(f"small {arch}: card {n} cache differs from the CPU by "
                 f"{cache_err} (scale {scale})")
    if not torch.equal(caches[dev]["pos"].cpu(), caches[cpu]["pos"]):
        fail(f"small {arch}: card positions differ from the CPU")
    return out


def int8_cache_diff(arch, got, want, tol):
    """int8 pages on the card (``got``) against the CPU's: scales within
    1e-6 relative, codes equal but for steps of one, dequantized values
    within ``tol`` plus one step. Returns the differences and the count
    of codes that differ."""
    import torch
    out = {"codes": 0, "codes_differ": 0}
    for n in ("k", "v"):
        gq, wq = got[n].cpu(), want[n]
        gs, ws = got[n + "_scale"].cpu(), want[n + "_scale"]
        if not torch.allclose(gs, ws, rtol=1e-6, atol=0):
            fail(f"small {arch} int8: card {n} scales differ from the CPU "
                 f"by {float((gs - ws).abs().max())}")
        step = (gq.int() - wq.int()).abs()
        out["codes"] += gq.numel()
        out["codes_differ"] += int((step > 0).sum())
        out[f"{n}_max_code_step"] = int(step.max())
        dg = gq.float() * gs[..., :, None, :, None]
        dw = wq.float() * ws[..., :, None, :, None]
        over = (dg - dw).abs() - (tol + tol * dw.abs()
                                  + ws[..., :, None, :, None])
        out[f"{n}_max_abs_err"] = float((dg - dw).abs().max())
        if int(step.max()) > 1 or float(over.max()) > 0:
            fail(f"small {arch} int8: card {n} codes differ from the CPU "
                 f"by {int(step.max())} steps")
    return out


# ---------------------------------------------------------------- phase 3

def build_engine(dev, arch, kv_quant="none", max_seq=MAX_SEQ):
    """Full-width ``arch`` with random bf16 weights drawn on the card from
    the seed, on the serving engine of every serving phase (slots of
    ``max_seq`` tokens); cut to ``CUT_LAYERS[arch]`` layers where it has
    an entry."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServingEngine
    cfg = registry.get(arch)
    if arch in CUT_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS[arch])
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    t0 = time.time()
    params = M.init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    config = ServeConfig(n_slots=N_SLOTS, max_seq=max_seq,
                         prefill_chunk=CHUNK, tier_topology=TOPOLOGY,
                         store_budget_bytes=16 << 30, seed=SEED,
                         kv_quant=kv_quant)
    engine = ServingEngine(params, cfg, rc, config=config, device=dev)
    return cfg, rc, params, engine, init_s


def zero_counters():
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hdm_stream import ops as hops
    from repro_torch.kernels.mamba2_scan import ops as sops
    dops.launches = dops.int8_launches = 0
    fops.launches = 0
    fops.kernel_launches = dict.fromkeys(fops.kernel_launches, 0)
    sops.launches = hops.launches = 0
    hops.instance_launches = dict.fromkeys(hops.instance_launches, 0)


def read_counters():
    """Every kernel wrapper's launch count, under the ``kernels`` line's
    names."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hdm_stream import ops as hops
    from repro_torch.kernels.mamba2_scan import ops as sops
    return {"paged_decode": dops.launches,
            "paged_decode_int8": dops.int8_launches,
            "flash_prefill": fops.kernel_launches["mma"],
            "flash_prefill_d256": fops.kernel_launches["mma256"],
            "flash_prefill_tf32": fops.kernel_launches["tf32"],
            "flash_prefill_tf32_256": fops.kernel_launches["tf32_256"],
            "flash_prefill_scalar": fops.kernel_launches["scalar"],
            "ssd_scan": sops.launches,
            "paged_matmul": (hops.instance_launches["skinny"]
                             + hops.instance_launches["tile"]),
            "paged_matmul_skinny_f32": hops.instance_launches["skinny_f32"],
            "paged_matmul_tile_f32": hops.instance_launches["tile_f32"],
            "paged_matmul_scalar": hops.instance_launches["scalar"]}


def split_counts(arch, counts, on_path):
    """The counts read after a main path, split into the kernels the path
    must run and the rest, which must all be 0."""
    launches = {name: counts[name] for name in on_path}
    off_path = {name: n for name, n in counts.items() if name not in on_path}
    if any(off_path.values()):
        fail(f"{arch}: kernels launched off the path: {off_path}")
    return launches, off_path


def run_stats(engine, handles, wall_s, launches, init_s):
    import torch
    from repro_torch.core.tier import CxlTier
    st = engine.stats
    entries = {CxlTier.entry_bytes(e) for e in engine.store.pages.values()}
    kv = engine.cache.get("kv")
    return {"init_s": init_s, "wall_s": wall_s, "launches": launches,
            "n_layers": engine.cfg.n_layers,
            "kv_layers": 0 if kv is None else kv["k"].shape[0],
            "entry_bytes": sorted(entries),
            "requests_done": sum(h.done() for h in handles),
            "requests": len(handles),
            "decode_tokens": st["decode_tokens"],
            "prefill_tokens": st["prefill_tokens"],
            "decode_ticks": st["decode_dispatches"],
            "prefill_chunks": st["prefill_dispatches"],
            "tokens_per_s": st["decode_tokens"] / wall_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "prefix_hits": st["prefix_hits"],
            "restore_stall_ns": st["restore_stall_ns"],
            "tier_write_ns": st["tier_write_ns"],
            "store_bytes": st["store_bytes"], "flushes": st["flushes"],
            "tier_sr_hit_rate": st["tier_sr_hit_rate"]}


def step_costs(engine, params, cfg, rc, prompt, dev):
    """Steady-state device costs of the two steps at the path's shapes
    (CUDA events), then one more tick whose logits must be finite and of
    the expected shape. xLSTM's prefill (a recurrence a token in every
    layer) is timed over ``XLSTM_TIMED_TOKENS`` tokens, not a whole
    chunk."""
    import torch
    from repro_torch.models import model as M
    out = {"decode_tick_ms": time_ms(engine._decode_sample, 10)}
    n = XLSTM_TIMED_TOKENS if cfg.family == "ssm" else CHUNK
    chunk = engine._codebooks(torch.tensor([prompt[:n]],
                                           dtype=torch.int32, device=dev))

    def prefill_chunk():
        cache1 = M.slot_view(engine.cache, 0)
        cache1["pos"] = torch.zeros(1, dtype=torch.int32, device=dev)
        M.prefill_step_cached(params, cfg, rc, chunk, cache1,
                              last_only=True)
    out["prefill_chunk_ms"] = time_ms(prefill_chunk, 5)
    out["prefill_chunk_tokens"] = n
    out["prefill_ms_per_token"] = out["prefill_chunk_ms"] / n
    logits, _ = M.decode_step(params, cfg, rc,
                              engine._codebooks(engine.last_tokens[:, None]),
                              engine.cache)
    torch.cuda.synchronize()
    books = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    if tuple(logits.shape) != (N_SLOTS,) + books + (1, cfg.vocab_size):
        fail(f"{cfg.arch_id} decode logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        fail(f"{cfg.arch_id}: non-finite decode logits")
    return out


def retired_entry(engine, rid):
    """``rid``'s retired entry without charging a flush: the staging ring's
    latest write of it, else the host store's."""
    staged = [entry for key, entry in engine.flusher.pending if key == rid]
    return staged[-1] if staged else engine.store.pages.get(rid)


def prefix_pages_equal(engine, rid, again_rid, prompt_len):
    """The flush -> restore -> decode round trip: the pages that the
    prompt filled (and no decode step touched) come back in the restored
    request's own retired entry with the same values (int8: codes and
    scales), bit for bit (``tests/test_kv_quant.py``'s engine gate, at
    full width)."""
    import torch
    a, b = retired_entry(engine, rid), retired_entry(engine, again_rid)
    if a is None or b is None:
        return False
    full = prompt_len // engine.cache["kv"]["k"].shape[3]
    return all(torch.equal(a["kv"][n][:, :full].cpu(),
                           b["kv"][n][:, :full].cpu()) for n in a["kv"])


@contextlib.contextmanager
def counting_drops():
    """Counts the (token, expert) pairs that the MoE layers route and drop
    at capacity, on decode ticks and on prefill chunks: wraps the two
    one-rank entry points the blocks call. The count routes each input a
    second time (no kernel of the port's); yields ``{kind: [dropped (a
    device tensor), routed]}``."""
    from repro_torch.models import moe
    acc = {"decode": [0, 0], "prefill": [0, 0]}
    inner = {"decode": moe.moe_apply_ep_decode, "prefill": moe.moe_apply_ep}

    def wrap(kind):
        def counted(m, cfg, x, **kw):
            n, pairs = moe.dropped_pairs(m, cfg, x)
            acc[kind][0] = acc[kind][0] + n
            acc[kind][1] += pairs
            return inner[kind](m, cfg, x, **kw)
        return counted
    moe.moe_apply_ep_decode, moe.moe_apply_ep = wrap("decode"), wrap(
        "prefill")
    try:
        yield acc
    finally:
        moe.moe_apply_ep_decode, moe.moe_apply_ep = (inner["decode"],
                                                     inner["prefill"])


def serve(dev, kv_quant="none", arch=ARCH):
    """Serve full-width ``arch`` (qwen3-1.7b, gemma-2b, granite or
    musicgen) with bf16 or int8 KV pages: its requests, then some of them
    again under new rids (prefix restores). granite's MoE layers count the
    pairs they drop."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Request

    n_req, n_again, lens, max_seq = {
        MUSICGEN: (N_MUSICGEN_REQUESTS, N_MUSICGEN_RESUBMIT,
                   MUSICGEN_PROMPT_LENS, MUSICGEN_MAX_SEQ),
        GLM4: (N_GROUP_REQUESTS, N_GROUP_RESUBMIT, PROMPT_LENS, MAX_SEQ),
        STARCODER2: (N_GROUP_REQUESTS, N_GROUP_RESUBMIT, PROMPT_LENS,
                     MAX_SEQ)}.get(arch, (N_REQUESTS, N_RESUBMIT,
                                          PROMPT_LENS, MAX_SEQ))
    cfg, rc, params, engine, init_s = build_engine(dev, arch, kv_quant,
                                                   max_seq)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*lens, n_req)]
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts from 0 just before, read just after
    with (counting_drops() if cfg.family == "moe"
          else contextlib.nullcontext()) as drops:
        zero_counters()
        t0 = time.time()
        first = [engine.submit(Request(rid=i, prompt=p,
                                       max_new_tokens=MAX_NEW))
                 for i, p in enumerate(prompts)]
        engine.run(max_ticks=10_000)
        again = [engine.submit(Request(rid=1000 + i, prompt=prompts[i],
                                       max_new_tokens=MAX_NEW))
                 for i in range(n_again)]
        engine.run(max_ticks=10_000)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        counts = read_counters()
    # bf16 pages: the bf16 decode mode and the bf16 tensor-core prefill
    # (gemma-2b: its D 256 instance); int8 pages: the int8 mode and the f32
    # (3xTF32) prefill instance (gemma-2b: its D 256 instance)
    int8 = kv_quant == "int8"
    prefill = {(ARCH, False): "flash_prefill",
               (GEMMA, False): "flash_prefill_d256",
               (GRANITE, False): "flash_prefill",
               (MUSICGEN, False): "flash_prefill",
               (GLM4, False): "flash_prefill",
               (STARCODER2, False): "flash_prefill",
               (ARCH, True): "flash_prefill_tf32",
               (GEMMA, True): "flash_prefill_tf32_256"}[arch, int8]
    launches, off_path = split_counts(
        f"{arch} int8" if int8 else arch, counts,
        ("paged_decode_int8" if int8 else "paged_decode", prefill))

    out = run_stats(engine, first + again, wall_s, launches, init_s)
    out["off_path_launches"] = off_path
    out["restored"] = [h.request.restored for h in again]
    out["tokens_equal"] = [h.result() == first[i].result()
                           for i, h in enumerate(again)
                           if h.done() and first[i].done()]
    out["tokens_first_run"] = [first[i].result() for i in range(n_again)]
    out["tokens_restored"] = [h.result() for h in again]
    if drops is not None:
        out["dropped_pairs"] = {kind: {"dropped": int(n), "routed": pairs,
                                       "share": int(n) / pairs}
                                for kind, (n, pairs) in drops.items()}
    out.update(step_costs(engine, params, cfg, rc, prompts[0], dev))
    if int8 or cfg.family == "moe":
        out["prefix_pages_equal"] = [
            prefix_pages_equal(engine, i, 1000 + i, len(prompts[i]))
            for i in range(n_again)]
        out["tokens_equal_leading"] = [
            next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                 len(x))
            for x, y in zip(out["tokens_first_run"], out["tokens_restored"])]
    if int8:
        out["post_prefill"] = restore_from_post_prefill(
            dev, arch, prompts[:N_RESUBMIT], out["tokens_first_run"])
    return out


def restore_from_post_prefill(dev, arch, prompts, first_tokens):
    """int8 restores are exact when the entry is the post-prefill state.

    A retired entry holds the pages as they stand at retire, so under
    int8 the page holding ``pos`` carries the scale that the decoded rows
    grew and its prompt rows come back re-rounded to it (the reference
    engine does the same). Here each prompt first runs for one token on
    fresh slots, so that its entry is exactly the state its first run
    decoded from; restored, it must give that run's greedy tokens."""
    from repro_torch.serving.engine import Request
    _, _, _, engine, _ = build_engine(dev, arch, "int8")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=1))
    engine.run(max_ticks=10_000)
    again = [engine.submit(Request(rid=100 + i, prompt=p,
                                   max_new_tokens=MAX_NEW))
             for i, p in enumerate(prompts)]
    engine.run(max_ticks=10_000)
    return {"restored": [h.request.restored for h in again],
            "tokens_equal": [h.result() == t
                             for h, t in zip(again, first_tokens)]}


# ---------------------------------------------------------------- phase 4

def check_hybrid_stepwise(dev, params, cfg, rc):
    """One 256-token prompt at full width through one chunked prefill (the
    SSD-scan and flash-prefill kernels) and through 256 ``decode_step``
    calls (the reference engine's form of the hybrid prefill). With the
    bf16 weights widened to f32 the two must agree within FULL_F32_TOL,
    with the prompt's greedy token equal. In bf16 their difference is
    measured and reported, not bounded: ``dt`` comes out of a bf16 product
    whose rounding differs between a 1-row and a 256-row product, and the
    decay ``exp(dt * A)`` (A up to 16) amplifies it layer after layer."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import model as M
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        1, cfg.vocab_size, (1, CHUNK)).astype(np.int32)).to(dev)
    out = {"positions": CHUNK}
    for name in ("float32", "bfloat16"):
        wide = name == "float32"
        c = dataclasses.replace(cfg, dtype=name)
        p = copy.deepcopy(params).float() if wide else params
        cache = M.cache_init(c, rc, 1, CHUNK, device=dev)
        chunked, _ = M.prefill_step_cached(p, c, rc, toks, cache)
        cache = M.cache_init(c, rc, 1, CHUNK, device=dev)
        stepwise = torch.cat([M.decode_step(p, c, rc, toks[:, t:t + 1],
                                            cache)[0]
                              for t in range(CHUNK)], 1)
        torch.cuda.synchronize()
        got, want = chunked.float(), stepwise.float()
        if not torch.isfinite(got).all() or not torch.isfinite(want).all():
            fail(f"{cfg.arch_id} {name}: non-finite prefill logits")
        same = (got.argmax(-1) == want.argmax(-1))[0]
        diff = (got - want).abs()
        out[name] = {"logits_max_abs_err": float(diff.max()),
                     "logits_mean_abs_err": float(diff.mean()),
                     "logit_scale": float(want.abs().max()),
                     "argmax_equal_positions": int(same.sum())}
        if wide:
            check_close(f"{cfg.arch_id} f32 chunked vs stepwise prefill "
                        f"logits", got, want, FULL_F32_TOL)
            if not bool(same[-1]):
                fail(f"{cfg.arch_id}: the prompt's greedy token differs "
                     f"between chunked and stepwise prefill (f32)")
        del p, cache, chunked, stepwise
        torch.cuda.empty_cache()
    return out


def serve_fresh(dev, arch, n_requests, on_path):
    """Serve ``n_requests`` fresh requests of full-width ``arch``, a family
    the engine never restores from the tier (the hybrid, the VLM, xLSTM),
    and hold the main path to the kernels ``on_path``. zamba2 first checks
    its chunked prefill against its stepwise form."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Request

    cfg, rc, params, engine, init_s = build_engine(dev, arch)
    stepwise = (check_hybrid_stepwise(dev, params, cfg, rc)
                if cfg.family == "hybrid" else None)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROMPT_LENS, n_requests)]
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts from 0 just before, read just after
    zero_counters()
    t0 = time.time()
    handles = [engine.submit(Request(rid=i, prompt=p,
                                     max_new_tokens=MAX_NEW))
               for i, p in enumerate(prompts)]
    engine.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches, off_path = split_counts(arch, read_counters(), on_path)

    out = run_stats(engine, handles, wall_s, launches, init_s)
    out["off_path_launches"] = off_path
    if stepwise is not None:
        out["stepwise"] = stepwise
    out["stored_rids"] = sorted(engine.store.pages)
    if cfg.family == "vlm":
        out["vision_kv_nonzero"] = int(engine.cache["cross_k"].count_nonzero()
                                       + engine.cache["cross_v"]
                                       .count_nonzero())
    out.update(step_costs(engine, params, cfg, rc, prompts[0], dev))
    return out


def report(arch, run):
    log(f"serve {arch}: {run['requests_done']}/{run['requests']} requests, "
        f"{run['decode_tokens']} decode + {run['prefill_tokens']} prefill "
        f"tokens in {run['wall_s']:.2f}s ({run['tokens_per_s']:.1f} "
        f"decode tok/s), {run['decode_ticks']} ticks, "
        f"{run['prefill_chunks']} prefill chunks")
    log(f"{arch}: decode tick {run['decode_tick_ms']:.3f} ms, prefill chunk "
        f"({run['prefill_chunk_tokens']} tokens) "
        f"{run['prefill_chunk_ms']:.3f} ms "
        f"({run['prefill_ms_per_token']:.4f} ms per token), "
        f"max_memory_allocated {run['max_memory_allocated']} bytes, "
        f"weights init {run['init_s']:.1f}s")
    log(f"{arch} tier: prefix_hits {run['prefix_hits']}, restore_stall_ns "
        f"{run['restore_stall_ns']}, tier_write_ns {run['tier_write_ns']}, "
        f"store_bytes {run['store_bytes']}, flushes {run['flushes']}, "
        f"sr_hit_rate {run['tier_sr_hit_rate']}")
    log(f"{arch}: launches on the main path: {run['launches']}")
    if run["requests_done"] != run["requests"]:
        fail(f"{arch}: only {run['requests_done']}/{run['requests']} "
             f"finished")
    for name, n in run["launches"].items():
        if n <= 0:
            fail(f"{arch}: kernel {name} was never launched on the main "
                 f"path")


def check_restores(arch, run, tokens=True):
    """Every resubmit restored from the tier and stalled on it, with its
    first run's greedy tokens (``tokens``); else (granite, whose tick
    couples its slots through the experts' capacity) with its first run's
    first token and its prompt's full pages bit for bit."""
    n = len(run["restored"])
    if run["prefix_hits"] < n or run["restore_stall_ns"] <= 0:
        fail(f"{arch}: prefix restores missing: hits {run['prefix_hits']}, "
             f"stall {run['restore_stall_ns']}")
    if not all(run["restored"]):
        fail(f"{arch}: resubmits not restored: {run['restored']}")
    if tokens and (len(run["tokens_equal"]) != n
                   or not all(run["tokens_equal"])):
        fail(f"{arch}: restored greedy tokens differ: "
             f"{run['tokens_equal']}")
    if not tokens:
        log(f"{arch}: restored tokens equal to the first run's "
            f"{run['tokens_equal']}, equal leading tokens "
            f"{run['tokens_equal_leading']} of {MAX_NEW}; prompt pages bit "
            f"for bit {run['prefix_pages_equal']}")
        if not all(run["prefix_pages_equal"]) or min(
                run["tokens_equal_leading"]) < 1:
            fail(f"{arch}: the restore is not exact")


def check_per_step(arch, run, prefill, decode):
    """The path's prefill kernel ran once per attention layer (K/V layer
    of the cache) per chunk and its decode kernel once per attention
    layer per tick."""
    n = run["kv_layers"]
    want = {prefill: n * run["prefill_chunks"],
            decode: n * run["decode_ticks"]}
    got = {name: run["launches"][name] for name in want}
    if got != want:
        fail(f"{arch}: launches {got}, want one per layer per step {want}")


def check_int8_run(name, run8, bf16_run):
    """The gates of a full-width int8 run: every resubmit restored with its
    first token and its prompt's full pages bit for bit, restores of
    post-prefill entries giving the first run's tokens, the int8 decode
    once per layer per tick, and an entry under INT8_ENTRY_RATIO of the
    same model's bf16 entry. Restored from entries captured at retire,
    greedy tokens may part from the first run's after the first one (the
    page holding ``pos`` carries the scale its decoded rows grew; see
    ``restore_from_post_prefill``)."""
    log(f"{name}: restored tokens equal to the first run's "
        f"{run8['tokens_equal']}, equal leading tokens "
        f"{run8['tokens_equal_leading']} of {MAX_NEW}; prompt pages bit "
        f"for bit {run8['prefix_pages_equal']}; restored from post-prefill "
        f"entries {run8['post_prefill']}")
    if run8["prefix_hits"] < N_RESUBMIT or not all(run8["restored"]):
        fail(f"{name}: resubmits not restored: {run8['restored']}")
    if not all(run8["prefix_pages_equal"]) or min(
            run8["tokens_equal_leading"]) < 1:
        fail(f"{name}: the round trip is not exact")
    post = run8["post_prefill"]
    if not (all(post["restored"]) and all(post["tokens_equal"])
            and len(post["tokens_equal"]) == N_RESUBMIT):
        fail(f"{name}: restores of post-prefill entries differ from the "
             f"first run: {post}")
    per_tick = run8["launches"]["paged_decode_int8"] / run8["decode_ticks"]
    if per_tick != run8["kv_layers"]:
        fail(f"{name}: int8 decode launches per tick {per_tick} (want one "
             f"per layer, {run8['kv_layers']})")
    ratio = max(run8["entry_bytes"]) / min(bf16_run["entry_bytes"])
    run8["entry_ratio"] = ratio
    log(f"{name}: entry {run8['entry_bytes']} bytes over the bf16 entry "
        f"{bf16_run['entry_bytes']} = {ratio:.5f} (gate < "
        f"{INT8_ENTRY_RATIO}); restore stall per restore "
        f"{run8['restore_stall_ns'] / run8['prefix_hits']:.1f} ns against "
        f"bf16 {bf16_run['restore_stall_ns'] / bf16_run['prefix_hits']:.1f}"
        f" ns")
    if ratio >= INT8_ENTRY_RATIO:
        fail(f"{name}: int8 entry / bf16 entry {ratio}")


def check_vlm_kernels(dev):
    """Both attention kernels at the VLM's heads (Hkv 8 of 4 query heads
    each, D 128) over the serving path's slots and chunk; the decode runs
    its 8-row instance, half of whose rows are padding at G 4."""
    dec = check_decode(dev, 8, 4, 128)
    log(f"paged_decode ok: {dec['shape']}; {dec}")
    pre = check_prefill(dev, 8, 4, 128)
    log(f"flash_prefill ok: {pre['shape']}; {pre}")
    return dec, pre


def serve_vlm(dev):
    """Serve full-width llama-3.2-vision-11b (``CUT_LAYERS``); its gates:
    every request finished and its pages were flushed as one entry of the
    self-attention layers' pages, flash_prefill ran once per self-attention
    layer per chunk and the bf16 paged_decode once per self-attention
    layer per tick, no other kernel ran, and the vision K/V are still
    the cache's zeros (the serving path never writes them, as in the
    reference)."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get(VLM), n_layers=CUT_LAYERS[VLM])
    vlm = serve_fresh(dev, VLM, N_VLM_REQUESTS,
                      ("paged_decode", "flash_prefill"))
    report(VLM, vlm)
    check_per_step(VLM, vlm, "flash_prefill", "paged_decode")
    entry = 2 * vlm["kv_layers"] * MAX_SEQ * cfg.kv_dim * 2
    log(f"{VLM}: {vlm['kv_layers']} K/V layers; entries "
        f"{vlm['entry_bytes']} bytes (want {entry}) for requests "
        f"{vlm['stored_rids']}; nonzero vision K/V values "
        f"{vlm['vision_kv_nonzero']}")
    if (vlm["kv_layers"] != cfg.n_layers // cfg.cross_attn_period
            * (cfg.cross_attn_period - 1)
            or vlm["flushes"] != N_VLM_REQUESTS
            or vlm["stored_rids"] != list(range(N_VLM_REQUESTS))
            or vlm["entry_bytes"] != [entry]):
        fail(f"{VLM}: not every request's pages were flushed as one "
             f"{entry}-byte entry")
    if vlm["vision_kv_nonzero"]:
        fail(f"{VLM}: the serving path wrote the vision K/V")
    return vlm


def serve_xlstm(dev):
    """Serve full-width xlstm-125m; its gates: every request finished, no
    kernel launched (xLSTM has none) and nothing was flushed (its cache
    has no pages, as in the reference)."""
    xl = serve_fresh(dev, XLSTM, N_XLSTM_REQUESTS, ())
    report(XLSTM, xl)
    if xl["kv_layers"] or xl["flushes"] or xl["store_bytes"] \
            or xl["tier_write_ns"] or xl["stored_rids"]:
        fail(f"{XLSTM}: pages flushed from a cache without pages")
    return xl


def check_group_kernels(dev):
    """Both attention kernels at glm4-9b's heads (Hkv 2 of 16 query heads
    each) and starcoder2-15b's (Hkv 4 of 12), D 128, over the serving
    path's slots and chunk: the decode in both modes, split over two CTAs
    per kv head."""
    dec, dec8, pre = {}, {}, {}
    for arch, hkv, g in ((GLM4, 2, 16), (STARCODER2, 4, 12)):
        dec[arch] = check_decode(dev, hkv, g, 128)
        log(f"paged_decode ok: {dec[arch]['shape']}; {dec[arch]}")
        dec8[arch] = check_decode_int8(dev, hkv, g, 128)
        log(f"paged_decode int8 ok: {dec8[arch]['shape']}; {dec8[arch]}")
        pre[arch] = check_prefill(dev, hkv, g, 128)
        log(f"flash_prefill ok: {pre[arch]['shape']}; {pre[arch]}")
    return dec, dec8, pre


def serve_group(dev, arch):
    """Serve full-width glm4-9b or starcoder2-15b (query-head groups of 16
    and 12: the decode split over two CTAs per kv head) with bf16 pages:
    4 requests, then 2 of them again (prefix restores); phase 3's gates,
    and the bf16 decode and prefill once per layer per step."""
    run = serve(dev, arch=arch)
    report(arch, run)
    check_restores(arch, run)
    check_per_step(arch, run, "flash_prefill", "paged_decode")
    return run


def tp_traffic(vocab, arch=ARCH):
    """The tp phase's waves: 4 prompts of 300-1000 tokens (musicgen's
    1024-token slots: 300-600), then, for a family the engine restores,
    the first 2 again under new rids (restores). With the seed's lengths
    (896, 746, 658, 489) the last prompt's final chunk is odd (233
    tokens): granite's prefill MoE takes its one-device fallback
    there."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = MUSICGEN_PROMPT_LENS if arch == MUSICGEN else PROMPT_LENS
    first = [(i, rng.integers(1, vocab, int(n)).tolist(), MAX_NEW)
             for i, n in enumerate(rng.integers(*lens, N_TP_REQUESTS))]
    if arch in (HYBRID, VLM, XLSTM):
        return [first]
    return [first, [(1000 + i, prompt, MAX_NEW)
                    for i, prompt, _ in first[:N_TP_RESUBMIT]]]


def tp_chunks(waves):
    """The prefill chunks' lengths of the first wave (the second restores
    every prompt and prefills nothing)."""
    return [min(CHUNK, len(prompt) - at) for _, prompt, _ in waves[0]
            for at in range(0, len(prompt), CHUNK)]


def tp_model(dev, arch=ARCH):
    """qwen3-1.7b at full width cut to ``TP_LAYERS`` layers, or granite or
    a family of ``TP_FAMILIES`` cut to its ``TP_CUT``, random bf16 weights
    from the seed on ``dev``."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    cfg = dataclasses.replace(registry.get(arch), n_layers=(
        TP_LAYERS if arch == ARCH else TP_CUT.get(arch, CUT_LAYERS.get(
            arch))))
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    return cfg, rc, M.init_model(cfg, seed=SEED, device=dev)


def param_bytes(params, leaves=None):
    """Bytes of ``params``' leaves (those named in ``leaves``, if
    given)."""
    return sum(p.numel() * p.element_size()
               for name, p in params.named_parameters()
               if leaves is None or name in leaves)


def tp_shard(group, whole):
    """This rank's shard of the whole model, the whole one's bytes and
    those of its split leaves; the whole model is dropped from the
    card."""
    from repro_torch.parallel import sharding
    specs = sharding.param_specs(whole)
    sizes = {"whole_param_bytes": param_bytes(whole),
             "split_param_bytes": param_bytes(
                 whole, {n for n, sp in specs.items() if "model" in sp})}
    params = sharding.shard_params(whole, group.rank, group.size, specs)
    return params, sizes


def tp_serve(group, params, cfg, rc, kv_quant, dev, waves, mesh_shape=()):
    """One engine's run of ``waves`` (one rank when ``group`` is None; a
    rank of ``mesh_shape`` when given, ``group`` its ``RankMesh``): its
    report with the kernels' launch counts, the collectives, the peak
    memory and the wall."""
    import torch
    from repro_torch.launch import mesh
    from repro_torch.launch.serve import serve_waves
    from repro_torch.serving.config import ServeConfig
    max_seq = MUSICGEN_MAX_SEQ if cfg.family == "audio" else MAX_SEQ
    config = ServeConfig(n_slots=N_SLOTS, max_seq=max_seq,
                         prefill_chunk=CHUNK, tier_topology=TOPOLOGY,
                         store_budget_bytes=16 << 30, seed=SEED,
                         kv_quant=kv_quant, mesh_shape=mesh_shape,
                         tp=1 if group is None or mesh_shape else group.size)
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts from 0 just before, read just after
    zero_counters()
    mesh.COLLECTIVES.clear()
    t0 = time.time()
    out = serve_waves(group, params, cfg, rc, config, waves, dev)
    torch.cuda.synchronize(dev)
    out["wall_s"] = time.time() - t0
    out["launches"] = read_counters()
    out["collectives"] = dict(mesh.COLLECTIVES)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["shard_counters"] = out["tier"].get("shard_counters")
    return out


def tp_steps(group, params, cfg, rc, kv_quant, dev, prompt,
             steps=("decode_tick", "prefill_chunk")):
    """Tick and chunk ms of the path's two steps (CUDA events; a rank's
    waits on its collectives included) on a cache of 8 slots at half
    their length (a rank's pages of it), and the collectives each step
    runs; only those of ``steps``. Both ranks run the same steps, so their
    collectives pair up. xLSTM's chunk is ``XLSTM_TIMED_TOKENS`` tokens;
    musicgen's tokens go to every codebook."""
    import dataclasses
    import torch
    from repro_torch.launch import mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    rc = dataclasses.replace(rc, kv_quant=kv_quant)
    max_seq = MUSICGEN_MAX_SEQ if cfg.family == "audio" else MAX_SEQ
    cache = M.cache_init(cfg, rc, N_SLOTS, max_seq, device=dev)
    if group is not None:
        cache = sharding.shard_cache(cache, group.rank, group.size)
    n_chunk = XLSTM_TIMED_TOKENS if cfg.family == "ssm" else CHUNK
    tokens = torch.tensor(prompt[:N_SLOTS], dtype=torch.int32,
                          device=dev)[:, None]
    chunk = torch.tensor([prompt[:n_chunk]], dtype=torch.int32, device=dev)
    if cfg.family == "audio":
        tokens, chunk = (t[:, None].expand(t.shape[0], cfg.n_codebooks,
                                           t.shape[1]) for t in (tokens,
                                                                 chunk))

    def tick():
        cache["pos"].fill_(max_seq // 2)
        M.decode_step(params, cfg, rc, tokens, cache, group=group)

    def prefill():
        cache1 = M.slot_view(cache, 0)
        cache1["pos"] = torch.zeros(1, dtype=torch.int32, device=dev)
        M.prefill_step_cached(params, cfg, rc, chunk, cache1,
                              last_only=True, group=group)
    out = {}
    for name, fn, iters in (("decode_tick", tick, 10),
                            ("prefill_chunk", prefill, 5)):
        if name not in steps:
            continue
        mesh.COLLECTIVES.clear()
        out[f"{name}_ms"] = time_ms(fn, iters)
        out[f"{name}_collectives"] = {
            op: n / (iters + 2) for op, n in mesh.COLLECTIVES.items()}
    return out


@contextlib.contextmanager
def capturing_logits():
    """Keeps the logits row of every greedy step of each request this
    rank samples, in order: its prefill's last row (a restored request
    has none), then one row a decode tick. Yields ``{rid: [row [V],
    ...]}`` (clones on the card)."""
    from repro_torch.serving.engine import ServingEngine
    prefill, sample = ServingEngine._prefill_slot, ServingEngine._sample
    rows, admitting = {}, []

    def _prefill_slot(self, req, slot, tokens=None):
        admitting.append(req.rid)
        try:
            return prefill(self, req, slot, tokens)
        finally:
            admitting.pop()

    def _sample(self, row, *args):
        if admitting:
            rows.setdefault(admitting[-1], []).append(row[0].clone())
        else:
            # this rank's row of slots (every slot on one rank or at tp)
            first = self._rows[0] * row.shape[0]
            for i in range(row.shape[0]):
                req = self.slots[first + i]
                if req is not None:
                    rows.setdefault(req.rid, []).append(row[i].clone())
        return sample(self, row, *args)
    ServingEngine._prefill_slot, ServingEngine._sample = _prefill_slot, _sample
    try:
        yield rows
    finally:
        ServingEngine._prefill_slot, ServingEngine._sample = prefill, sample


def logits_file(name):
    """The one-rank engine's logits file of a tp path: ``name`` a page
    format (qwen3) or an arch."""
    return os.path.join(ROOT, "build", "tp", f"one_rank_logits_{name}.pt")


def comparable_steps(a_rows, b_rows):
    """How many steps of one request two engines' logits rows can be
    compared at: every step up to and including the first whose argmaxes
    part (later steps are conditioned on other tokens)."""
    n = 0
    for a, b in zip(a_rows, b_rows):
        n += 1
        if int(a.float().argmax()) != int(b.float().argmax()):
            break
    return n


def tp_logits_bound(one, wide):
    """The tp gate's bound on the logits, measured on the one-rank engine
    before the ranks run: ``TP_NOISE_X`` times its bf16 logits' largest
    distance from those of the same weights widened to f32 (``one`` /
    ``wide``: ``{rid: [V] rows}``, at the comparable steps), plus TOL's
    atol. Returns (bound, that distance)."""
    noise = 0.0
    for rid, rows in one.items():
        for a, b in list(zip(rows, wide[rid]))[:comparable_steps(
                rows, wide[rid])]:
            noise = max(noise, float((a.float() - b.float()).abs().max()))
    return TP_NOISE_X * noise + TOL["atol"], noise


def restore_sources(waves):
    """Each request of ``waves`` after the first that resubmits a prompt
    of the first wave -> that request's rid: the one whose retired entry
    it restores."""
    first = {tuple(prompt): rid for rid, prompt, _ in waves[0]}
    return {rid: first[tuple(prompt)] for wave in waves[1:]
            for rid, prompt, _ in wave if tuple(prompt) in first}


def restore_vs_source(path, rid, src, rows, tokens, bound):
    """One engine's logits rows of a restored request ``rid`` against its
    own rows of ``src``, the request whose retired entry it restores
    (``rows`` / ``tokens``: ``{rid: [V] rows}`` / ``{rid: greedy
    tokens}``). The restore starts from the entry's first token and its
    pages, so its row j is conditioned as the source's row j + 1 while
    their tokens agree: each such row within ``bound`` of it. Returns the
    rows held and their max abs error; (0, None) where this rank did not
    sample the source (the dp phase's restore that crossed data rows)."""
    import torch
    if src not in rows:
        return 0, None
    held, err = 0, 0.0
    for j, row in enumerate(rows[rid][:len(rows[src]) - 1]):
        e = float((row.float() - rows[src][j + 1].float()).abs().max())
        if not torch.isfinite(row).all() or e > bound:
            fail(f"{path} rid {rid} step {j}: logits {e} off its source "
                 f"rid {src}'s step {j + 1}, beyond {bound}")
        held, err = j + 1, max(err, e)
        if tokens[rid][j + 1] != tokens[src][j + 1]:
            break
    if not held:
        fail(f"{path} rid {rid}: no step held against its source rid {src}")
    return held, err


def tp_logits_gate(path, got, ref, tokens=None, sources=None):
    """The ranks' greedy steps against the one-rank engine's, request by
    request and step by step (``got``: ``{rid: [V] rows}``; ``ref``: the
    one-rank engine's rows ``one``, its f32 twin's ``f32``, the ``bound``
    of ``tp_logits_bound`` and its greedy ``tokens``): every logits row
    within the bound of the one-rank row, and of the f32 twin's while that
    one's tokens agree, until the ranks' and the one-rank argmaxes part;
    where they part, the one-rank logits of the two tokens must lie within
    the bound of each other (a near tie), and the request's later steps,
    conditioned on other tokens, are not held. A restored request's first
    token is its source's (``sources``: restored rid -> the rid whose
    entry it restores) and takes no step: where it differs between the
    ranks (``tokens``) and the one-rank engine, every step of the request
    is conditioned on another token, so the ranks' rows and the one-rank
    engine's are each held to that engine's own rows of the source
    instead (``restore_vs_source``; ``parted_at`` -1, the source and
    ``vs_source`` recorded; ``tp_tokens_check`` then holds the source to
    a near tie at its first step). Returns per request the steps held,
    the max abs errors against both and, where the tokens parted, the
    step, the two tokens and that gap."""
    import torch
    bound, out = ref["bound"], {}
    sources = sources or {}
    for rid, rows in ref["one"].items():
        if rid in sources and tokens is not None and \
                tokens[rid][0] != ref["tokens"][rid][0]:
            src = sources[rid]
            held, err = restore_vs_source(f"{path} ranks'", rid, src, got,
                                          tokens, bound)
            held1, err1 = restore_vs_source(f"{path} one-rank engine's", rid,
                                            src, ref["one"], ref["tokens"],
                                            bound)
            out[rid] = {"steps": held, "max_abs_err": 0.0,
                        "max_abs_err_f32": 0.0, "parted_at": -1,
                        "tokens": [ref["tokens"][rid][0], tokens[rid][0]],
                        "source": src,
                        "vs_source": {"steps": held, "max_abs_err": err,
                                      "one_rank_steps": held1,
                                      "one_rank_max_abs_err": err1}}
            continue
        mine, wide = got.get(rid, []), ref["f32"][rid]
        if len(mine) != len(rows):
            fail(f"{path}: rid {rid} took {len(mine)} greedy steps, the "
                 f"one-rank engine {len(rows)}")
        exact = comparable_steps(rows, wide)
        res = {"steps": 0, "max_abs_err": 0.0, "max_abs_err_f32": 0.0,
               "parted_at": None}
        for j, (a, b) in enumerate(zip(rows, mine)):
            a, b = a.float(), b.float()
            err = float((a - b).abs().max())
            e32 = float((b - wide[j].float()).abs().max()) if j < exact \
                else 0.0
            res["steps"] = j + 1
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_abs_err_f32"] = max(res["max_abs_err_f32"], e32)
            if not torch.isfinite(b).all() or max(err, e32) > bound:
                fail(f"{path}: rid {rid} step {j}: logits {err} off the "
                     f"one-rank engine's and {e32} off its f32 twin's, "
                     f"beyond {bound}")
            top, theirs = int(a.argmax()), int(b.argmax())
            if top != theirs:
                gap = float(a[top] - a[theirs])
                res.update(parted_at=j, tokens=[top, theirs], gap=gap)
                if gap > bound:
                    fail(f"{path}: rid {rid} step {j}: token {theirs} "
                         f"against the one-rank engine's {top}, whose "
                         f"logits are {gap} apart there: not a near tie")
                break
        out[rid] = res
    return out


def f32_copy_product(x, w):
    """The f32-copy form of ``parallel.sharding.product_f32`` (both
    operands widened, an f32 GEMM), timed against it on the card."""
    return x.float() @ w.float()


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` for the block: the steps timed
    again in an earlier form, in the same process."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


@contextlib.contextmanager
def capturing_ffn(block):
    """Keeps the input and output of ``block``'s feed-forward half: every
    prefill chunk's, and the first decode tick's. Yields the list of
    ``(decode, h, y)``."""
    inner = block.ffn
    seen = []

    def ffn(cfg, h, *, decode, **kw):
        y = inner(cfg, h, decode=decode, **kw)
        if not decode or not any(d for d, _, _ in seen):
            seen.append((decode, h.clone(), y.clone()))
        return y
    block.ffn = ffn
    try:
        yield seen
    finally:
        del block.ffn


def tp_rank(group):
    """One rank of the tp phase (a process of its own, on the card it
    shares): qwen3-1.7b on its shard of the weights in both page formats,
    its greedy steps held to the one-rank engine's logits, then
    granite-moe-1b-a400m, each timed after its run."""
    import gc
    import torch
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    dev = group.device
    cfg, rc, whole = tp_model(dev)
    params, out = tp_shard(group, whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    waves = tp_traffic(cfg.vocab_size)
    for kv_quant, path in (("none", TP_PATH), ("int8", TP8_PATH)):
        with capturing_logits() as rows:
            out[kv_quant] = tp_serve(group, params, cfg, rc, kv_quant, dev,
                                     waves)
        ref = torch.load(logits_file(kv_quant))
        for side in ("one", "f32"):
            ref[side] = {rid: list(t.to(dev)) for rid, t in
                         ref[side].items()}
        out[kv_quant]["logits_vs_one_rank"] = tp_logits_gate(
            f"{path} rank {group.rank}", rows, ref,
            out[kv_quant]["tokens"], restore_sources(waves))
        del rows, ref
        out[kv_quant].update(tp_steps(group, params, cfg, rc, kv_quant,
                                      dev, waves[0][0][1]))
    # the bf16 tick and chunk again with the row-parallel products taken
    # from f32 copies of both operands
    with patched(sharding, "product_f32", f32_copy_product):
        out["none"]["f32_copy"] = tp_steps(group, params, cfg, rc, "none",
                                           dev, waves[0][0][1])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, rc, whole = tp_model(dev, GRANITE)
    moe0 = whole.blocks[0].moe              # layer 0's whole experts
    params, sizes = tp_shard(group, whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    waves = tp_traffic(cfg.vocab_size)
    with capturing_ffn(params.blocks[0]) as seen:
        run = tp_serve(group, params, cfg, rc, "none", dev, waves)
    run.update(sizes)
    # layer 0's MoE on this rank against the two plain versions on the
    # card (every rank in this process, whole experts, no collective):
    # moe_apply_ep_ref, built from the helpers of the form under test, and
    # moe_apply_ep_loop, a per-pair loop that shares none of them
    errs = {"prefill": [], "decode": [], "loop_prefill": [],
            "loop_decode": [], "drops": [], "odd_chunks": 0}
    for decode, h, y in seen:
        kind = "decode" if decode else "prefill"
        step = "decode" if decode else f"chunk of {h.shape[1]}"
        want, drops = moe.moe_apply_ep_ref(moe0, cfg, h, group.size,
                                           decode=decode)
        loop, loop_drops = moe.moe_apply_ep_loop(moe0, cfg, h, group.size,
                                                 decode=decode)
        name = f"{GRANITE} tp2 rank {group.rank} layer-0 MoE ({step})"
        errs[kind].append(check_close(name, y, want))
        errs[f"loop_{kind}"].append(check_close(f"{name} vs the loop", y,
                                                loop))
        if drops != loop_drops:
            fail(f"{name}: dropped pairs {drops}, the loop's {loop_drops}")
        errs["drops"].append(drops)
        errs["odd_chunks"] += (not decode) and h.shape[1] % group.size
    run["moe_vs_ref"] = errs
    run.update(tp_steps(group, params, cfg, rc, "none", dev,
                        waves[0][0][1]))
    # the same steps with the row-parallel products from f32 copies, and
    # the chunk with the MoE's aux loss (and its all-reduce) computed
    ep = moe.moe_apply_ep

    def with_aux(*args, **kwargs):
        return ep(*args, **dict(kwargs, aux=True))
    with patched(sharding, "product_f32", f32_copy_product):
        run["f32_copy"] = tp_steps(group, params, cfg, rc, "none", dev,
                                   waves[0][0][1])
    with patched(moe, "moe_apply_ep", with_aux):
        run["with_aux"] = tp_steps(group, params, cfg, rc, "none", dev,
                                   waves[0][0][1], ("prefill_chunk",))
    out[GRANITE] = run
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for arch in TP_FAMILIES:
        out[arch] = tp_family_rank(group, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_family_rank(group, arch):
    """One rank's run of a family of ``TP_FAMILIES`` on its shard: its
    traffic with every greedy step held to the one-rank engine's logits
    (``tp_logits_gate``), the steps timed, and for the VLM the direct
    steps with vision K/V (``tp_vlm_direct``)."""
    import gc
    import torch
    dev = group.device
    cfg, rc, whole = tp_model(dev, arch)
    params, sizes = tp_shard(group, whole)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    waves = tp_traffic(cfg.vocab_size, arch)
    with capturing_logits() as rows:
        run = tp_serve(group, params, cfg, rc, "none", dev, waves)
    run.update(sizes)
    ref = torch.load(logits_file(arch))
    for side in ("one", "f32"):
        ref[side] = {rid: list(t.to(dev)) for rid, t in ref[side].items()}
    run["logits_vs_one_rank"] = tp_logits_gate(
        f"{TPF_PATHS[arch]} rank {group.rank}", rows, ref, run["tokens"],
        restore_sources(waves))
    del rows, ref
    run.update(tp_steps(group, params, cfg, rc, "none", dev,
                        waves[0][0][1]))
    if arch == VLM:
        run["direct"] = tp_vlm_direct(group, params, cfg, rc)
    return run


def vlm_direct_inputs(dev, cfg):
    """The VLM's direct steps' inputs: 2 rows of a ``CHUNK``-token prompt
    and a tick's tokens, and vision embeddings [2, Nv, d] (f32), from the
    seed."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    toks = torch.randint(1, cfg.vocab_size, (2, CHUNK + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    emb = torch.randn((2, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                      device=dev)
    return toks, emb


def vlm_direct_steps(params, cfg, rc, dev, group=None):
    """The VLM's direct steps on ``params`` (whole, or this rank's shard
    over ``group``) with both cross gates at ``VLM_GATES``: every cross
    layer writes its vision K/V from ``vlm_direct_inputs``' embeddings
    (``vision_kv``, over ``group``), then a prefill chunk (last row) and
    a tick over a 2-row cache (a rank's pages of it). Returns the two
    logits rows [2, V] of each step (f32) and the vision K/V."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding
    for cross in params.cross:
        for name, g in VLM_GATES.items():
            getattr(cross, name).fill_(g)
    toks, emb = vlm_direct_inputs(dev, cfg)
    cache = M.cache_init(cfg, rc, 2, MAX_SEQ, device=dev)
    if group is not None:
        cache = sharding.shard_cache(cache, group.rank, group.size)
    for gi, cross in enumerate(params.cross):
        k, v = transformer.vision_kv(cross, cfg, emb.to(cache["cross_k"].dtype),
                                     group)
        cache["cross_k"][gi].copy_(k)
        cache["cross_v"][gi].copy_(v)
    pre, _ = M.prefill_step_cached(params, cfg, rc, toks[:, :CHUNK], cache,
                                   last_only=True, group=group)
    tick, _ = M.decode_step(params, cfg, rc, toks[:, CHUNK:], cache,
                            group=group)
    for cross in params.cross:
        for name in VLM_GATES:
            getattr(cross, name).zero_()
    return ({"prefill": pre[:, -1].float(), "decode": tick[:, -1].float()},
            {"k": cache["cross_k"].clone(), "v": cache["cross_v"].clone()})


def tp_vlm_direct(group, params, cfg, rc):
    """The VLM's direct steps on this rank (``vlm_direct_steps``) against
    the one-rank call's logits, within the bound measured on the one-rank
    call and its f32 twin; this rank's vision K/V (from its split wk /
    wv, gathered) against the one-rank call's within TOL. Returns the
    max abs errors."""
    import torch
    dev = group.device
    ref = torch.load(logits_file(f"{VLM}_direct"))
    got, vision = vlm_direct_steps(params, cfg, rc, dev, group)
    out = {"bound": ref["bound"]}
    for step, rows in got.items():
        err = float((rows - ref["one"][step].to(dev)).abs().max())
        e32 = float((rows - ref["f32"][step].to(dev)).abs().max())
        out[step] = {"max_abs_err": err, "max_abs_err_f32": e32}
        if not torch.isfinite(rows).all() or max(err, e32) > ref["bound"]:
            fail(f"{TPF_PATHS[VLM]} rank {group.rank}: the direct {step} "
                 f"with vision K/V is {err} off the one-rank call's and "
                 f"{e32} off its f32 twin's, beyond {ref['bound']}")
    for name, t in vision.items():
        out[f"vision_{name}_err"] = check_close(
            f"{TPF_PATHS[VLM]} rank {group.rank} vision {name}", t,
            ref["vision"][name].to(dev))
    return out


def check_tp_run(path, r, run, per_step, restores=N_TP_RESUBMIT):
    """A rank's main path: each kernel of ``per_step`` (``{kernel:
    (layers, "decode" or "prefill")}``) once per such layer per tick or
    chunk, and no other kernel; ``restores`` resubmits restored through
    the peer lanes. Returns the path's launches and the others (all
    0)."""
    launches, off_path = split_counts(f"{path} rank {r}", run["launches"],
                                      tuple(per_step))
    if launches and min(launches.values()) <= 0:
        fail(f"{path} rank {r}: a kernel of the path never launched: "
             f"{launches}")
    st = run["stats"]
    want = {k: n * st[f"{step}_dispatches"]
            for k, (n, step) in per_step.items()}
    if launches != want:
        fail(f"{path} rank {r}: launches {launches}, want one per layer "
             f"per step {want}")
    if run["restored"] != [1000 + i for i in range(restores)]:
        fail(f"{path} rank {r}: restores {run['restored']}")
    if st["mesh_ranks"] != TP_RANKS or \
            st["tier_peer_fetches"] < restores:
        fail(f"{path} rank {r}: mesh_ranks {st['mesh_ranks']}, peer "
             f"fetches {st['tier_peer_fetches']}")
    return launches, off_path


def check_tp_shard(path, r, run, sizes):
    """A rank holds the whole model's bytes less (N-1)/N of its split
    leaves', which are over half of them."""
    whole, split = sizes["whole_param_bytes"], sizes["split_param_bytes"]
    want = whole - split + split // TP_RANKS
    if run["param_bytes"] != want or split <= whole // 2:
        fail(f"{path} rank {r}: {run['param_bytes']} parameter bytes, want "
             f"{want} (whole {whole}, split {split})")


def tp_record(path, runs, one, extra):
    """The path's numbers for the JSON record, rank 0's launches."""
    first = runs[0]
    stats = first["stats"]
    launches, off_path = first["on_path"]
    out = {"launches": launches, "off_path_launches": off_path,
           "wall_s": [r["wall_s"] for r in runs],
           "param_bytes": [r["param_bytes"] for r in runs],
           "max_memory_allocated": [r["max_memory_allocated"] for r in runs],
           "decode_tick_ms": [r["decode_tick_ms"] for r in runs],
           "prefill_chunk_ms": [r["prefill_chunk_ms"] for r in runs],
           "decode_tick_collectives": first["decode_tick_collectives"],
           "prefill_chunk_collectives": first["prefill_chunk_collectives"],
           "collectives": [r["collectives"] for r in runs],
           "shard_counters": first["shard_counters"],
           "restored": first["restored"],
           "decode_ticks": stats["decode_dispatches"],
           "prefill_chunks": stats["prefill_dispatches"],
           "restore_stall_ns": stats["restore_stall_ns"],
           "tier_write_ns": stats["tier_write_ns"]}
    if one is not None:
        out.update({f"one_rank_{k}": one[k] for k in (
            "wall_s", "param_bytes", "max_memory_allocated",
            "decode_tick_ms", "prefill_chunk_ms", "launches")})
    out.update(extra)
    log(f"{path}: walls {out['wall_s']} s; parameter bytes "
        f"{out['param_bytes']}; peak {out['max_memory_allocated']} bytes; "
        f"tick {out['decode_tick_ms']} ms, chunk {out['prefill_chunk_ms']} "
        f"ms; collectives a tick {out['decode_tick_collectives']}, a chunk "
        f"{out['prefill_chunk_collectives']}; on the run "
        f"{out['collectives']}; ShardedTier counters "
        f"{out['shard_counters']}; launches {out['launches']}"
        + (f"; one rank: wall {one['wall_s']:.2f} s, "
           f"{one['param_bytes']} parameter bytes, peak "
           f"{one['max_memory_allocated']} bytes, tick "
           f"{one['decode_tick_ms']:.3f} ms, chunk "
           f"{one['prefill_chunk_ms']:.3f} ms" if one is not None else ""))
    return out


def serve_tp(dev):
    """The tp phase: one spawn of two rank processes on the one card
    joined by gloo (``launch.mesh.spawn``, a file rendezvous under
    build/), each holding its shard of the weights
    (``parallel.sharding``) and half of every slot's pages, serving in
    turn qwen3-1.7b (``TP_LAYERS`` layers) in bf16 and int8 pages and
    granite-moe-1b-a400m (``TP_CUT``, bf16 pages; the expert-parallel
    MoE). qwen3: every rank's greedy steps held to the one-rank engine's
    on the card over the same traffic (``tp_logits_gate``: logits within
    ``tp_logits_bound``, measured on the one-rank engine and its f32
    twin first; tokens equal but where they part at a near tie).
    granite: the ranks' tokens, stats and tier traces equal one another;
    layer 0's MoE on each rank within TOL of ``moe_apply_ep_ref`` and of
    ``moe_apply_ep_loop`` at every prefill chunk (the odd final one too:
    the fallback) and the first decode tick; 2 all_to_alls per MoE
    layer per even chunk and none at decode. Both: the restores
    happened, the peer lanes carried shards, each rank holds its share of
    the weights, and the decode (its m / l output) and the prefill ran
    once per layer per step and no other kernel. A rank that fails or
    outlives ``TP_TIMEOUT_S`` fails."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh
    import copy
    import dataclasses
    import torch
    cfg, rc, params = tp_model(dev)
    # the same weights widened to f32: the one-rank engine's own bf16
    # rounding, measured, sets the ranks' bound
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rc32 = dataclasses.replace(rc, model=cfg32)
    wide = copy.deepcopy(params).float()
    waves = tp_traffic(cfg.vocab_size)
    one, bounds = {}, {}
    os.makedirs(os.path.dirname(logits_file("none")), exist_ok=True)
    for kv_quant in ("none", "int8"):
        with capturing_logits() as rows:
            one[kv_quant] = tp_serve(None, params, cfg, rc, kv_quant, dev,
                                     waves)
        with capturing_logits() as rows32:
            tp_serve(None, wide, cfg32, rc32, kv_quant, dev, waves)
        bound, noise = tp_logits_bound(rows, rows32)
        bounds[kv_quant] = {"bound": bound, "one_rank_vs_f32": noise}
        torch.save({"one": {rid: torch.stack(r).cpu()
                            for rid, r in rows.items()},
                    "f32": {rid: torch.stack(r).cpu()
                            for rid, r in rows32.items()},
                    "bound": bound, "tokens": one[kv_quant]["tokens"]},
                   logits_file(kv_quant))
        del rows, rows32
        one[kv_quant].update(tp_steps(None, params, cfg, rc, kv_quant, dev,
                                      waves[0][0][1]))
    del params, wide
    free_card()
    for arch in TP_FAMILIES:
        one[arch] = tp_family_one_rank(dev, arch)
        free_card()
    t0 = time.time()
    ranks = mesh.spawn(tp_rank, TP_RANKS, (),
                       rendezvous_dir=os.path.join(ROOT, "build", "tp"),
                       device="cuda", timeout_s=TP_TIMEOUT_S)
    spawn_s = time.time() - t0
    out = {}
    for kv_quant, path in (("none", TP_PATH), ("int8", TP8_PATH)):
        decode = "paged_decode" if kv_quant == "none" else \
            "paged_decode_int8"
        prefill = "flash_prefill" if kv_quant == "none" else \
            "flash_prefill_tf32"
        runs = [r[kv_quant] for r in ranks]
        for r, run in enumerate(runs):
            run["on_path"] = check_tp_run(
                path, r, run, {decode: (TP_LAYERS, "decode"),
                               prefill: (TP_LAYERS, "prefill")})
            check_tp_shard(path, r, run, ranks[r])
            if run["tokens"] != runs[0]["tokens"] or run[
                    "logits_vs_one_rank"] != runs[0]["logits_vs_one_rank"]:
                fail(f"{path} rank {r}: greedy tokens or logits differ from "
                     f"rank 0's")
        gate = runs[0]["logits_vs_one_rank"]
        equal = tp_tokens_check(path, runs[0]["tokens"],
                                one[kv_quant]["tokens"], gate,
                                runs[0]["restored"], bounds[kv_quant])
        extra = {}
        if kv_quant == "none":
            extra = {f"f32_copy_{k}": [r["f32_copy"][k] for r in runs]
                     for k in ("decode_tick_ms", "prefill_chunk_ms")}
        if extra:
            log(f"{path}: with the row-parallel products from f32 copies: "
                f"tick {extra['f32_copy_decode_tick_ms']} ms, chunk "
                f"{extra['f32_copy_prefill_chunk_ms']} ms")
        out[path] = tp_record(path, runs, one[kv_quant], {
            "tokens_equal_leading": equal, "logits_vs_one_rank": gate,
            "logits_bound": bounds[kv_quant],
            **extra,
            "n_layers": TP_LAYERS, "spawn_s": spawn_s,
            "whole_param_bytes": ranks[0]["whole_param_bytes"],
            "split_param_bytes": ranks[0]["split_param_bytes"]})

    path = TPG_PATH
    runs = [r[GRANITE] for r in ranks]
    chunks = tp_chunks(tp_traffic(registry.get(GRANITE).vocab_size))
    n_layers = TP_CUT[GRANITE]
    even = sum(1 for c in chunks if c % TP_RANKS == 0)
    for r, run in enumerate(runs):
        run["on_path"] = check_tp_run(
            path, r, run, {"paged_decode": (n_layers, "decode"),
                           "flash_prefill": (n_layers, "prefill")})
        check_tp_shard(path, r, run, run)
        if (run["tokens"], stats_but_wall(run), run["tier"]) != (
                runs[0]["tokens"], stats_but_wall(runs[0]), runs[0]["tier"]):
            fail(f"{path} rank {r}: tokens, stats or tier traces differ "
                 f"from rank 0's")
        if run["stats"]["prefill_dispatches"] != len(chunks):
            fail(f"{path} rank {r}: {run['stats']['prefill_dispatches']} "
                 f"prefill chunks, the traffic has {len(chunks)}")
        a2a = run["collectives"].get("all_to_all", 0)
        if a2a != 2 * n_layers * even or run["decode_tick_collectives"].get(
                "all_to_all", 0):
            fail(f"{path} rank {r}: {a2a} all_to_alls on the run, want 2 "
                 f"per MoE layer per even chunk ({2 * n_layers * even}); "
                 f"a tick's: {run['decode_tick_collectives']}")
        errs = run["moe_vs_ref"]
        if len(errs["prefill"]) != len(chunks) or len(errs["decode"]) != 1 \
                or errs["odd_chunks"] != len(chunks) - even or not (
                    0 < even < len(chunks)):
            fail(f"{path} rank {r}: layer-0 MoE checked at "
                 f"{len(errs['prefill'])} chunks ({errs['odd_chunks']} "
                 f"odd) and {len(errs['decode'])} ticks; the traffic has "
                 f"{len(chunks)} chunks, {even} even")
    log(f"{path}: ranks agree (tokens, stats, tier traces); layer-0 MoE "
        f"within TOL of moe_apply_ep_ref and moe_apply_ep_loop at "
        f"{len(chunks)} chunks ({len(chunks) - even} odd: the fallback) and "
        f"the first tick, max abs err "
        f"{[max(r['moe_vs_ref']['prefill']) for r in runs]} / "
        f"{[r['moe_vs_ref']['decode'] for r in runs]} (the loop: "
        f"{[max(r['moe_vs_ref']['loop_prefill']) for r in runs]} / "
        f"{[r['moe_vs_ref']['loop_decode'] for r in runs]}); dropped pairs "
        f"{runs[0]['moe_vs_ref']['drops']}; all_to_alls "
        f"{2 * n_layers * even} a rank")
    extra = {f"{form}_{k}": [r[form][k] for r in runs]
             for form, keys in (("f32_copy", ("decode_tick_ms",
                                              "prefill_chunk_ms")),
                                ("with_aux", ("prefill_chunk_ms",
                                              "prefill_chunk_collectives")))
             for k in keys}
    log(f"{path}: with the row-parallel products from f32 copies: tick "
        f"{extra['f32_copy_decode_tick_ms']} ms, chunk "
        f"{extra['f32_copy_prefill_chunk_ms']} ms; with the MoE's aux "
        f"loss: chunk {extra['with_aux_prefill_chunk_ms']} ms, collectives "
        f"{extra['with_aux_prefill_chunk_collectives'][0]}")
    out[path] = tp_record(path, runs, None, {
        **extra, "n_layers": n_layers, "spawn_s": spawn_s,
        "whole_param_bytes": runs[0]["whole_param_bytes"],
        "split_param_bytes": runs[0]["split_param_bytes"],
        "chunks": chunks, "moe_vs_ref": runs[0]["moe_vs_ref"]})
    for arch in TP_FAMILIES:
        out[TPF_PATHS[arch]] = check_tp_family(
            arch, [r[arch] for r in ranks], one[arch], spawn_s)
    return out


def tp_family_one_rank(dev, arch):
    """A family of ``TP_FAMILIES`` on one rank before the ranks run: its
    traffic on the one-rank engine and on the same weights widened to f32
    (every greedy step's logits kept, the bound measured from them and
    saved for the ranks), its steps timed; for the VLM, the direct steps
    with vision K/V in both widths too."""
    import copy
    import dataclasses
    import torch
    cfg, rc, params = tp_model(dev, arch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rc32 = dataclasses.replace(rc, model=cfg32)
    wide = copy.deepcopy(params).float()
    waves = tp_traffic(cfg.vocab_size, arch)
    with capturing_logits() as rows:
        one = tp_serve(None, params, cfg, rc, "none", dev, waves)
    with capturing_logits() as rows32:
        tp_serve(None, wide, cfg32, rc32, "none", dev, waves)
    bound, noise = tp_logits_bound(rows, rows32)
    one["bound"] = {"bound": bound, "one_rank_vs_f32": noise}
    torch.save({"one": {rid: torch.stack(r).cpu() for rid, r in rows.items()},
                "f32": {rid: torch.stack(r).cpu()
                        for rid, r in rows32.items()},
                "bound": bound, "tokens": one["tokens"]}, logits_file(arch))
    del rows, rows32
    one.update(tp_steps(None, params, cfg, rc, "none", dev, waves[0][0][1]))
    if arch == VLM:
        got, vision = vlm_direct_steps(params, cfg, rc, dev)
        got32, _ = vlm_direct_steps(wide, cfg32, rc32, dev)
        noise = max(float((got[k] - got32[k]).abs().max()) for k in got)
        bound = TP_NOISE_X * noise + TOL["atol"]
        torch.save({"one": {k: t.cpu() for k, t in got.items()},
                    "f32": {k: t.cpu() for k, t in got32.items()},
                    "vision": {k: t.cpu() for k, t in vision.items()},
                    "bound": bound}, logits_file(f"{VLM}_direct"))
        one["direct_bound"] = {"bound": bound, "one_rank_vs_f32": noise}
    return one


def check_tp_family(arch, runs, one, spawn_s):
    """A family's tp path from its ranks' reports: each rank ran the
    path's kernels once per attention or Mamba2 layer per step and no
    other (xLSTM: none), holds its share of the weights, agrees with the
    other rank (tokens, stats, tier traces, the logits gate), and its
    greedy tokens equal the one-rank engine's but at near ties; musicgen
    restored its resubmits; the VLM's direct steps with vision K/V passed
    on every rank. Returns the path's record."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    path = TPF_PATHS[arch]
    cfg = dataclasses.replace(registry.get(arch), n_layers=TP_CUT[arch])
    attn = {HYBRID: M.n_groups(cfg) if cfg.family == "hybrid" else 0,
            MUSICGEN: cfg.n_layers, XLSTM: 0,
            VLM: cfg.n_layers - cfg.n_layers // max(cfg.cross_attn_period,
                                                    1)}[arch]
    per_step = {}
    if attn:
        per_step = {"paged_decode": (attn, "decode"),
                    "flash_prefill": (attn, "prefill")}
    if arch == HYBRID:
        per_step["ssd_scan"] = (cfg.n_layers, "prefill")
    restores = N_TP_RESUBMIT if arch == MUSICGEN else 0
    for r, run in enumerate(runs):
        run["on_path"] = check_tp_run(path, r, run, per_step, restores)
        check_tp_shard(path, r, run, run)
        if (run["tokens"], stats_but_wall(run), run.get("tier"),
                run["logits_vs_one_rank"]) != (
                runs[0]["tokens"], stats_but_wall(runs[0]),
                runs[0].get("tier"), runs[0]["logits_vs_one_rank"]):
            fail(f"{path} rank {r}: tokens, stats, tier traces or logits "
                 f"differ from rank 0's")
    gate = runs[0]["logits_vs_one_rank"]
    equal = tp_tokens_check(path, runs[0]["tokens"], one["tokens"], gate,
                            runs[0]["restored"], one["bound"])
    extra = {"tokens_equal_leading": equal, "logits_vs_one_rank": gate,
             "logits_bound": one["bound"], "n_layers": cfg.n_layers,
             "spawn_s": spawn_s,
             "whole_param_bytes": runs[0]["whole_param_bytes"],
             "split_param_bytes": runs[0]["split_param_bytes"]}
    if arch == VLM:
        extra["direct"] = [r["direct"] for r in runs]
        extra["direct_bound"] = one["direct_bound"]
        log(f"{path}: direct prefill chunk and tick with vision K/V and "
            f"cross gates {VLM_GATES} within {one['direct_bound']} of the "
            f"one-rank calls on every rank: {extra['direct']}")
    return tp_record(path, runs, one, extra)


def tp_tokens_check(path, got, want, gate, restored, bound):
    """The ranks' greedy tokens against the one-rank engine's: a request
    whose steps never parted (``gate``, ``tp_logits_gate``'s) has every
    token equal; one that parted at step j has its tokens equal up to
    that step's token and not at it (a restored request's first token,
    from its entry, takes no step); a restored request whose first token
    parted (step -1) equals its source's first token on both engines, and
    the source parted there, at its first step. Returns each request's
    equal leading tokens."""
    leading = {rid: next((i for i, (a, b) in enumerate(zip(got.get(rid, ()),
                                                          t)) if a != b),
                         len(t)) for rid, t in want.items()}
    for rid, t in want.items():
        parted = gate[rid]["parted_at"]
        src = gate[rid].get("source")
        if parted == -1 and (gate[src]["parted_at"] != 0 or got[src][0] != got[
                rid][0] or want[src][0] != t[0]):
            fail(f"{path}: rid {rid} restored first token "
                 f"{gate[rid]['tokens']}, its source rid {src} parted at "
                 f"{gate[src]['parted_at']} (first tokens {got[src][0]} / "
                 f"{want[src][0]}): not its source's first step")
        at = len(t) if parted is None else parted + (rid in restored)
        if leading[rid] != at or len(got.get(rid, ())) != len(t):
            fail(f"{path}: rid {rid}: {leading[rid]} leading tokens equal "
                 f"to the one-rank engine's, the logits parted at "
                 f"{parted}: {got.get(rid)} against {t}")
    parted = {rid: g for rid, g in gate.items() if g["parted_at"] is not None}
    log(f"{path}: greedy steps held to the one-rank engine's on "
        f"{TP_RANKS} ranks, each on its shard of the weights: logits max "
        f"abs err {max(g['max_abs_err'] for g in gate.values())} (against "
        f"the f32 twin {max(g['max_abs_err_f32'] for g in gate.values())})"
        f" within {bound['bound']} ({TP_NOISE_X} x the one-rank engine's "
        f"own {bound['one_rank_vs_f32']} from its f32 twin, + "
        f"{TOL['atol']}); tokens equal"
        + (f" but at near ties {parted}" if parted else " throughout"))
    return leading


def stats_but_wall(run):
    return {k: v for k, v in run["stats"].items() if k != "prefill_time_s"}


def dp_traffic(vocab):
    """The dp phase's waves: ``N_DP_REQUESTS`` prompts of 300-1000 tokens
    (the first 4 take data row 0's slots 0-3, the others row 1's 4-5),
    ``DP_MAX_NEW`` new tokens each, then the last and the first prompt
    again under new rids: restores into slots 0 and 1, the first from
    row 1's slot 5."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    first = [(i, rng.integers(1, vocab, int(n)).tolist(), DP_MAX_NEW)
             for i, n in enumerate(rng.integers(*PROMPT_LENS,
                                                N_DP_REQUESTS))]
    return [first, [(1000 + i, first[i][1], DP_MAX_NEW)
                    for i in (N_DP_REQUESTS - 1, 0)]]


@contextlib.contextmanager
def recording_slots():
    """The slot each request was prefilled in (and its prompt's length),
    retired from and restored into, in this rank's engine."""
    from repro_torch.serving.engine import ServingEngine as E
    saved = {n: getattr(E, n) for n in ("_prefill_slot", "_retire",
                                        "_apply_restore")}
    rec = {"prefilled": [], "retired": {}, "restored": {}}

    def _prefill_slot(self, req, slot, tokens=None):
        n = len(req.prompt if tokens is None else tokens)
        rec["prefilled"].append((req.rid, slot, n,
                                 self._local(slot) is not None))
        return saved["_prefill_slot"](self, req, slot, tokens)

    def _retire(self, slot):
        rec["retired"][self.slots[slot].rid] = slot
        return saved["_retire"](self, slot)

    def _apply_restore(self, req, slot, entry):
        rec["restored"][req.rid] = slot
        return saved["_apply_restore"](self, req, slot, entry)
    for n, f in (("_prefill_slot", _prefill_slot), ("_retire", _retire),
                 ("_apply_restore", _apply_restore)):
        setattr(E, n, f)
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(E, n, f)


def dp_one_rank(dev):
    """qwen3-1.7b (``TP_LAYERS``) on one rank before the mesh's ranks run:
    the dp traffic on the one-rank engine and on the same weights widened
    to f32 (every greedy step's logits kept, the bound measured from
    them and saved for the ranks), its steps timed."""
    import copy
    import dataclasses
    import torch
    cfg, rc, params = tp_model(dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rc32 = dataclasses.replace(rc, model=cfg32)
    wide = copy.deepcopy(params).float()
    waves = dp_traffic(cfg.vocab_size)
    with capturing_logits() as rows:
        one = tp_serve(None, params, cfg, rc, "none", dev, waves)
    with capturing_logits() as rows32:
        tp_serve(None, wide, cfg32, rc32, "none", dev, waves)
    bound, noise = tp_logits_bound(rows, rows32)
    one["bound"] = {"bound": bound, "one_rank_vs_f32": noise}
    os.makedirs(os.path.dirname(logits_file("dp")), exist_ok=True)
    torch.save({"one": {rid: torch.stack(r).cpu() for rid, r in rows.items()},
                "f32": {rid: torch.stack(r).cpu()
                        for rid, r in rows32.items()},
                "bound": bound, "tokens": one["tokens"]}, logits_file("dp"))
    del rows, rows32, wide
    one.update(tp_steps(None, params, cfg, rc, "none", dev, waves[0][0][1]))
    return one


def dp_steps(rank_mesh, params, cfg, rc, dev, prompt):
    """Tick and chunk ms on this rank (CUDA events, the waits on its
    collectives included) at SR depth 1 and 0 in ``DP_ORDERS``' turns,
    and the collectives each step runs by axis: a tick of the
    row's 4 slots at half their length (its pages of them), a chunk
    into the row's first slot (both rows prefill at once, so their
    gathers pair up), on a cache of 8 slots cut by ``shard_cache``; then
    a data-axis gather alone, of a layer and of the embedding."""
    import dataclasses
    import torch
    from repro_torch.launch import mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    _, d, m = rank_mesh.coords
    data, model = rank_mesh.data, rank_mesh.model
    cache = sharding.shard_cache(
        M.cache_init(cfg, rc, N_SLOTS, MAX_SEQ, device=dev), model.rank,
        model.size, (data.rank, data.size))
    per = N_SLOTS // data.size
    ranks = M.Ranks(model=model, pages=model, fsdp=data, batch=data)
    tokens = torch.tensor(prompt[d * per:(d + 1) * per], dtype=torch.int32,
                          device=dev)[:, None]
    chunk = torch.tensor([prompt[:CHUNK]], dtype=torch.int32, device=dev)
    out = {f"depth{k}": {} for k in (1, 0)}
    for order in DP_ORDERS:
        for depth in order:
            rcd = dataclasses.replace(rc, sr_prefetch_depth=depth)

            def tick():
                cache["pos"].fill_(MAX_SEQ // 2)
                M.decode_step(params, cfg, rcd, tokens, cache, ranks=ranks)

            def prefill():
                cache1 = M.slot_view(cache, 0)
                cache1["pos"] = torch.zeros(1, dtype=torch.int32, device=dev)
                M.prefill_step_cached(params, cfg, rcd, chunk, cache1,
                                      last_only=True,
                                      ranks=dataclasses.replace(
                                          ranks, batch=None))
            for name, fn, iters in (("decode_tick", tick, 3),
                                    ("prefill_chunk", prefill, 2)):
                mesh.COLLECTIVES.clear()
                res = out[f"depth{depth}"]
                res.setdefault(f"{name}_ms", []).append(time_ms(fn, iters))
                res[f"{name}_collectives"] = {
                    op: n / (iters + 2)
                    for op, n in mesh.COLLECTIVES.items()}
    for name, unit, iters in (("layer", params.blocks[0], 10),
                              ("embedding", (params.embed,), 5)):
        out[f"gather_{name}_ms"] = time_ms(
            lambda: sharding.FsdpRead(unit, data).wait(), iters)
    return out


def dp_rank(rank_mesh):
    """One rank of the dp phase (a process of its own, on the card it
    shares with three others): qwen3-1.7b's whole weights made on the
    card and placed on the POOL tier (``core.hdm.HDMStore``: the rank's
    model-axis shard, cut again on the FSDP axes), layer 0 gathered and
    held bit for bit to the whole model's model-axis shard of it, the dp
    traffic served with every greedy step held to the one-rank engine's
    logits, then the steps timed."""
    import gc
    import torch
    from repro_torch.core import hdm
    from repro_torch.parallel import sharding
    dev = rank_mesh.device
    _, d, m = rank_mesh.coords
    cfg, rc, whole = tp_model(dev)
    store = hdm.HDMStore(rank_mesh)
    specs = store.specs(whole)
    want0 = {n: p.clone() for n, p in sharding.shard_params(
        whole, m, rank_mesh.model.size, specs).blocks[0].named_parameters()}
    params = store.place(whole)
    out = {"whole_param_bytes": param_bytes(whole),
           "resident_bytes": hdm.bytes_per_device(whole, store),
           "coords": rank_mesh.coords}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    got0 = dict(sharding.gather_fsdp(params.blocks[0], rank_mesh.data)
                .named_parameters())
    out["layer0"] = {
        "gathered_bytes": sum(t.numel() * t.element_size()
                              for t in got0.values()),
        "shard_bytes": param_bytes(params.blocks[0]),
        "bit_equal": all(torch.equal(got0[n], t) for n, t in want0.items())
        and sorted(got0) == sorted(want0)}
    del got0, want0
    waves = dp_traffic(cfg.vocab_size)
    with capturing_logits() as rows, recording_slots() as slots:
        run = tp_serve(rank_mesh, params, cfg, rc, "none", dev, waves,
                       mesh_shape=DP_MESH)
    run.update(out)
    run["slots"] = slots
    ref = torch.load(logits_file("dp"))
    for side in ("one", "f32"):
        ref[side] = {rid: list(t.to(dev)) for rid, t in ref[side].items()
                     if rid in rows}
    run["logits_vs_one_rank"] = tp_logits_gate(
        f"{DP_PATH} rank {rank_mesh.rank}", rows, ref, run["tokens"],
        restore_sources(waves))
    del rows, ref
    gc.collect()
    run["steps"] = dp_steps(rank_mesh, params, cfg, rc, dev, waves[0][0][1])
    return run


def serve_dp(dev, one):
    """The dp phase: four rank processes of mesh (2, 2) on the one card
    joined by gloo (``launch.mesh.spawn`` with ``mesh_shape``), spawned
    once, each on its POOL shard of qwen3-1.7b's weights (``TP_LAYERS``)
    with its row's 4 slots and its half of their pages; every layer
    gathered over the data axis by the speculative read. Held: layer 0
    gathered equals the model-axis shard bit for bit; every greedy step's
    logits within the bound of the one-rank engine's (``one``:
    ``dp_one_rank``) and tokens equal but at near ties, on the rank that
    samples them; every rank's tokens, stats and tier traces alike; a
    restore crossed data rows; the decode kernel once per layer per tick
    and the prefill once per layer per chunk of the rank's row, no other
    kernel; the rank's bytes its share by the specs. A rank that fails or
    outlives ``DP_TIMEOUT_S`` fails."""
    import math
    from repro_torch.launch import mesh
    t0 = time.time()
    ranks = mesh.spawn(dp_rank, math.prod(DP_MESH), (),
                       rendezvous_dir=os.path.join(ROOT, "build", "dp"),
                       device="cuda", timeout_s=DP_TIMEOUT_S,
                       mesh_shape=DP_MESH)
    spawn_s = time.time() - t0
    path, first = DP_PATH, ranks[0]
    for r, run in enumerate(ranks):
        if (run["tokens"], stats_but_wall(run), run["tier"]) != (
                first["tokens"], stats_but_wall(first), first["tier"]):
            fail(f"{path} rank {r}: tokens, stats or tier traces differ "
                 f"from rank 0's")
        if not run["layer0"]["bit_equal"]:
            fail(f"{path} rank {r}: layer 0 gathered over the data axis is "
                 f"not the model-axis shard bit for bit")
        if run["param_bytes"] != run["resident_bytes"] or \
                4 * run["param_bytes"] > 1.05 * run["whole_param_bytes"]:
            fail(f"{path} rank {r}: {run['param_bytes']} parameter bytes, "
                 f"want {run['resident_bytes']} of "
                 f"{run['whole_param_bytes']}")
        sl = run["slots"]
        owned = sum(-(-n // CHUNK) for _, _, n, mine in sl["prefilled"]
                    if mine)
        run["on_path"] = split_counts(f"{path} rank {r}", run["launches"],
                                      ("paged_decode", "flash_prefill"))
        want = {"paged_decode": TP_LAYERS * run["stats"]["decode_dispatches"],
                "flash_prefill": TP_LAYERS * owned}
        if run["on_path"][0] != want or not owned:
            fail(f"{path} rank {r}: launches {run['on_path'][0]}, want one "
                 f"per layer per tick and per chunk of its row {want}")
    sl, per = first["slots"], N_SLOTS // DP_MESH[0]
    crossed = [rid for rid, slot in sl["restored"].items()
               if sl["retired"][rid - 1000] // per != slot // per]
    if first["restored"] != [1000, 1000 + N_DP_REQUESTS - 1] or not crossed:
        fail(f"{path}: restores {first['restored']} into slots "
             f"{sl['restored']} (retired from {sl['retired']}): none "
             f"crossed data rows")
    # the two data rows' ranks sample the requests of their own slots
    gate = {}
    for r in range(0, len(ranks), DP_MESH[1]):
        gate.update(ranks[r]["logits_vs_one_rank"])
    if sorted(gate) != sorted(one["tokens"]):
        fail(f"{path}: the data rows sampled {sorted(gate)}, the traffic "
             f"has {sorted(one['tokens'])}")
    equal = tp_tokens_check(path, first["tokens"], one["tokens"], gate,
                            first["restored"], one["bound"])
    steps = [r["steps"] for r in ranks]
    out = {"spawn_s": spawn_s, "n_layers": TP_LAYERS, "mesh": DP_MESH,
           "launches": first["on_path"][0],
           "off_path_launches": first["on_path"][1],
           "wall_s": [r["wall_s"] for r in ranks],
           "param_bytes": [r["param_bytes"] for r in ranks],
           "whole_param_bytes": first["whole_param_bytes"],
           "layer0": [r["layer0"] for r in ranks],
           "max_memory_allocated": [r["max_memory_allocated"]
                                    for r in ranks],
           "collectives": [r["collectives"] for r in ranks],
           "steps": steps, "restored_into": sl["restored"],
           "retired_from": sl["retired"], "crossed_rows": crossed,
           "decode_ticks": first["stats"]["decode_dispatches"],
           "prefill_chunks": first["stats"]["prefill_dispatches"],
           "tokens_equal_leading": equal, "logits_vs_one_rank": gate,
           "logits_bound": one["bound"],
           "one_rank_wall_s": one["wall_s"],
           "one_rank_param_bytes": one["param_bytes"],
           "one_rank_max_memory_allocated": one["max_memory_allocated"],
           "one_rank_decode_tick_ms": one["decode_tick_ms"],
           "one_rank_prefill_chunk_ms": one["prefill_chunk_ms"]}
    log(f"{path}: walls {out['wall_s']} s (one rank {one['wall_s']:.2f}); "
        f"parameter bytes {out['param_bytes']} of "
        f"{out['whole_param_bytes']}; layer 0 gathered "
        f"{[x['gathered_bytes'] for x in out['layer0']]} bytes from shards "
        f"of {[x['shard_bytes'] for x in out['layer0']]}, bit-equal to the "
        f"model-axis shard; peak {out['max_memory_allocated']} bytes (one "
        f"rank {one['max_memory_allocated']}); collectives on the run "
        f"{out['collectives'][0]}; restores {sl['restored']} from "
        f"{sl['retired']} ({crossed} crossed rows)")
    for k in ("depth1", "depth0"):
        log(f"{path}: SR {k}: tick {[s[k]['decode_tick_ms'] for s in steps]}"
            f" ms, chunk {[s[k]['prefill_chunk_ms'] for s in steps]} ms "
            f"(one rank: {one['decode_tick_ms']:.3f} / "
            f"{one['prefill_chunk_ms']:.3f}); a tick's collectives "
            f"{steps[0][k]['decode_tick_collectives']}, a chunk's "
            f"{steps[0][k]['prefill_chunk_collectives']}")
    log(f"{path}: a data-axis gather alone: layer "
        f"{[s['gather_layer_ms'] for s in steps]} ms, embedding "
        f"{[s['gather_embedding_ms'] for s in steps]} ms")
    return out


def check_train_prefill(dev):
    """flash_prefill at the training loss's shape (TRAIN_PREFILL_TOL): one
    layer's whole 4096-token sequence as one chunk at position 0, its own
    K/V the cache (q [8, 4096, 16, 128], K/V [8, 4096, 8, 128]), against
    its plain version (run a batch row at a time: the whole batch's
    [C, Smax] scores in f32 would take 8.6 GB), timed beside causal SDPA
    and at the other plans of the tensor-core kernel (rows per CTA x
    stages). The bound must see a lost key tile: the last 64 rows computed
    without the last 64 keys have to miss it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    b, c, hkv, g, d = TRAIN_BATCH, TRAIN_SEQ, 8, 2, 128
    h = hkv * g
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((b, c, h, d), generator=gen, device=dev).bfloat16()
    kc = torch.randn((b, c, hkv, d), generator=gen, device=dev).bfloat16()
    vc = torch.randn((b, c, hkv, d), generator=gen, device=dev).bfloat16()
    pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    p = ops.plan(b, c, h, hkv, d, torch.bfloat16)

    def plain():
        return torch.cat([ref.flash_prefill_ref(q[i:i + 1], kc[i:i + 1],
                                                vc[i:i + 1], pos[i:i + 1])
                          for i in range(b)])
    got = ops.flash_prefill(q, kc, vc, pos)
    want = plain()
    res = {"plan": str(p),
           "max_abs_err": check_close("flash_prefill train shape", got,
                                      want, TRAIN_PREFILL_TOL)}
    tail = c - 64
    dropped = ref.flash_prefill_ref(q[:, tail:], kc[:, :tail], vc[:, :tail],
                                    torch.full_like(pos, tail))
    res["dropped_tile_err"] = float((dropped.float()
                                     - want[:, tail:].float()).abs().max())
    if torch.allclose(dropped.float(), want[:, tail:].float(),
                      **TRAIN_PREFILL_TOL):
        fail(f"flash_prefill train shape: {TRAIN_PREFILL_TOL} cannot see "
             f"the last key tile (off by {res['dropped_tile_err']})")
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = device_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 10)
    res["plain_ms"] = time_ms(plain, 2, warmup=1)
    res["library_ms"] = device_ms(sdpa, 10)
    # the other plans of the tensor-core kernel at this shape (the plan
    # was chosen on 256-row chunks): rows per CTA x ring depth
    res["plans_ms"] = {}
    for rows, stages in ((16, 3), (32, 3), (64, 2), (64, 4)):
        alt = ops.mma_plan(b, c, h, hkv, d, rows, stages)
        check_close(f"flash_prefill train shape rows={rows} "
                    f"stages={stages}", ops.launch(q, kc, vc, pos, 0.0, alt),
                    want, TRAIN_PREFILL_TOL)
        res["plans_ms"][f"rows{rows} stages{stages}"] = device_ms(
            lambda pl=alt: ops.launch(q, kc, vc, pos, 0.0, pl), 10)
    visible = b * c * (c + 1) // 2                   # (query, key) pairs
    n_bytes = 2 * q.numel() * 2 + 2 * kc.numel() * 2 + 4 * b
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * visible * h * d)
    res["shape"] = (f"q [{b},{c},{h},{d}] bf16, cache = its own K/V "
                    f"[{b},{c},{hkv},{d}], pos 0 (the use_pallas loss of "
                    f"full-width {ARCH})")
    return res


def train_small(dev, arch):
    """One training step of the smoke-size ``arch`` in f32 on the card and
    on the CPU from the same weights and batch (the CPU tests hold the CPU
    path to the JAX reference): loss and every gradient within the f32
    tolerance (F32_TOL; the training forward runs no kernel of the port,
    the hybrid's SSD included), and the f32 masters after the AdamW update
    within 2 lr (a near-zero gradient's sign may differ between the two
    devices)."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    opt_cfg = adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=32, seed=SEED,
        n_codebooks=cfg.n_codebooks if cfg.family == "audio" else 0,
        vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)).batch(0)
    cpu = torch.device("cpu")
    params = {cpu: M.init_model(cfg, seed=SEED, device=cpu)}
    params[dev] = copy.deepcopy(params[cpu]).to(dev)
    out, masters = {}, {}
    for d, model in params.items():
        state = steps_lib.init_state(model, rc, opt_cfg)
        b = to_device(batch, d)
        loss, grads = steps_lib.loss_and_grads(model, cfg, rc, b)
        state, metrics = steps_lib.build_train_step(cfg, rc, opt_cfg)(
            state, b)
        out[d] = (loss, grads, metrics["loss"])
        masters[d] = state.opt.master
    (l_dev, g_dev, ml_dev), (l_cpu, g_cpu, ml_cpu) = out[dev], out[cpu]
    res = {"loss": float(l_cpu), "loss_err": abs(float(l_dev) - float(l_cpu)),
           "grad_max_abs_err": max(float((a.cpu() - b).abs().max())
                                   for a, b in zip(g_dev, g_cpu)),
           "master_max_abs_err": max(
               float((a.cpu() - b).abs().max())
               for a, b in zip(masters[dev], masters[cpu]))}
    if (not torch.allclose(l_dev.cpu(), l_cpu, **F32_TOL)
            or not torch.allclose(ml_dev.cpu(), ml_cpu, **F32_TOL)):
        fail(f"small {arch} train: card loss {float(l_dev)} vs CPU "
             f"{float(l_cpu)}")
    for a, b in zip(g_dev, g_cpu):
        if not torch.isfinite(a).all() or not torch.allclose(
                a.cpu(), b, **F32_TOL):
            fail(f"small {arch} train: card gradients differ from the CPU "
                 f"by {res['grad_max_abs_err']}")
    if res["master_max_abs_err"] > 2 * opt_cfg.learning_rate:
        fail(f"small {arch} train: masters differ by "
             f"{res['master_max_abs_err']}")
    return res


def train_checkpoint(dev):
    """``launch/train.py`` at smoke size on the card (2 steps), its
    asynchronous checkpoint written from CUDA tensors, restored onto the
    card equal to the state it saved, and a resumed run from it."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch import train
    path = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    run = train.train(ARCH, smoke=True, steps=2, device=dev, ckpt_dir=path)
    step, flat, extra = Checkpointer(path).restore(device=dev)
    want = train.state_dict(run["state"])
    if step != 1 or sorted(flat) != sorted(want) or any(
            not torch.equal(flat[k], v.detach()) for k, v in want.items()):
        fail("the smoke checkpoint did not restore the state it saved")
    again = train.train(ARCH, smoke=True, steps=1, device=dev, ckpt_dir=path,
                        resume=True)
    shutil.rmtree(path, ignore_errors=True)
    return {"leaves": len(flat), "step": step, "extra": extra,
            "losses": [h["loss"] for h in run["history"]],
            "resumed_loss": again["final_loss"],
            "bytes": sum(t.numel() * t.element_size() for t in flat.values()
                         if t is not None)}


def train_full(dev):
    """Train full-width qwen3-1.7b on the card (see ``TRAIN_*``): first the
    forward loss under ``no_grad`` with ``use_pallas`` (flash_prefill 28
    times, once a layer, and no other kernel) against the plain one; a
    step with ``use_pallas`` refused; then the 4 steps (no kernel of the
    port runs under grad, as none of the reference's does), timed by CUDA
    events."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import PEAK_FLOPS_BF16
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = registry.get(ARCH)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH,
                                seq_len=TRAIN_SEQ)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    rc_pallas = dataclasses.replace(rc, use_pallas=True)
    t0 = time.time()
    params = M.init_model(cfg, seed=SEED, device=dev)
    batch = to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, seed=SEED)).batch(0), dev)
    torch.cuda.synchronize()
    res = {"init_s": time.time() - t0, "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ, "ln_vocab": math.log(cfg.vocab_size)}
    with torch.no_grad():
        zero_counters()
        loss_pallas = float(M.loss_fn(params, cfg, rc_pallas, batch))
        counts = read_counters()
        loss_plain = float(M.loss_fn(params, cfg, rc, batch))
    launches, off = split_counts(TRAIN_PATH, counts, ("flash_prefill",))
    res.update(loss_pallas=loss_pallas, loss_plain=loss_plain,
               launches=launches, off_path_launches=off)
    log(f"{TRAIN_PATH}: forward loss use_pallas {loss_pallas:.6f}, plain "
        f"{loss_plain:.6f}; launches {launches}")
    if abs(loss_pallas - loss_plain) > PALLAS_LOSS_TOL * (
            1 + abs(loss_plain)):
        fail(f"{TRAIN_PATH}: the use_pallas loss {loss_pallas} is not "
             f"within {PALLAS_LOSS_TOL} of the plain one {loss_plain}")
    if launches["flash_prefill"] != cfg.n_layers:
        fail(f"{TRAIN_PATH}: flash_prefill launched "
             f"{launches['flash_prefill']} times, not once a layer")
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    state = steps_lib.init_state(params, rc, opt_cfg)
    try:
        steps_lib.build_train_step(cfg, rc_pallas, opt_cfg)(state, batch)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        res["pallas_step_refused"] = str(e)
    else:
        fail(f"{TRAIN_PATH}: a step under grad with use_pallas ran")
    free_card()
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        step_ms.append(start.elapsed_time(end))
    counts = read_counters()
    if any(counts.values()):
        fail(f"{TRAIN_PATH}: a kernel launched under grad: {counts}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]   # median after the 1st
    flops = 6 * cfg.n_active_params() * tokens
    res.update(losses=losses, step_ms=step_ms, step_ms_median=ms,
               tokens_per_s=tokens / (ms / 1e3),
               mfu=flops / (ms / 1e3) / PEAK_FLOPS_BF16,
               model_flops_per_step=flops,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               kernel_launches_per_step=sum(counts.values()) / TRAIN_STEPS,
               grad_norm=float(metrics["grad_norm"]),
               n_params=sum(p.numel() for p in params.parameters()))
    log(f"{TRAIN_PATH}: losses {losses}; step ms {step_ms} (median after "
        f"the first {ms:.1f}); {res['tokens_per_s']:.0f} tokens/s; MFU "
        f"{res['mfu']:.4f} (6 x {cfg.n_active_params()} active params x "
        f"{tokens} tokens a step over {PEAK_FLOPS_BF16:.0e} flop/s; remat's "
        f"recompute not counted); peak {res['peak_gib']:.2f} GiB; port "
        f"kernel launches per step {res['kernel_launches_per_step']}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{TRAIN_PATH}: non-finite loss {losses}")
    if abs(losses[0] - res["ln_vocab"]) > 1.5:
        fail(f"{TRAIN_PATH}: first loss {losses[0]} not within 1.5 of "
             f"ln V = {res['ln_vocab']}")
    if not losses[-1] < losses[0]:
        fail(f"{TRAIN_PATH}: the loss did not decrease: {losses}")
    return res


def train_driver(dev):
    """``launch/train.py`` as its CLI drives it on the card
    (``python -m repro_torch.launch.train --arch qwen3-1.7b``): full-width
    qwen3-1.7b for TRAIN_DRIVER_STEPS steps of 8 x 4096 tokens from its
    ``Pipeline`` (pinned host batches copied non-blocking), through the
    variant ladder, RuntimeQoS and the heartbeat, with no checkpoint. Every
    loss is finite and the first lies within 1.5 of ln V."""
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    run = train.train(ARCH, smoke=False, steps=TRAIN_DRIVER_STEPS,
                      device=dev, log_every=1)
    losses = [h["loss"] for h in run["history"]]
    res = {"wall_s": time.time() - t0, "losses": losses,
           "step_s": [h["dt"] for h in run["history"]],
           "variants": [list(h["variant"]) for h in run["history"]],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del run
    ln_v = math.log(registry.get(ARCH).vocab_size)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{TRAIN_PATH} driver: non-finite loss {losses}")
    if abs(losses[0] - ln_v) > 1.5:
        fail(f"{TRAIN_PATH} driver: first loss {losses[0]} not within 1.5 "
             f"of ln V = {ln_v}")
    return res


def xlstm_forms(dev, params, cfg):
    """``mlstm_apply`` (chunkwise, from the zero state) at full width in
    f32 against ``mlstm_step`` run over the same tokens from the state
    initialisers' state (C, n 0; m -1e9; an empty conv window): the
    training form against the serving one (XLSTM_FORMS_TOL)."""
    import copy
    import dataclasses
    import torch
    from repro_torch.models import xlstm
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    layer = copy.deepcopy(params.mlstm[0][0]).float()
    d_in, nh = cfg.mlstm_expand * cfg.d_model, cfg.n_heads
    dh, b = d_in // nh, 2
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((b, XLSTM_FORMS_TOKENS, cfg.d_model), generator=gen,
                    device=dev) * 0.5
    f32 = dict(dtype=torch.float32, device=dev)
    state = {"C": torch.zeros((b, nh, dh, dh), **f32),
             "n": torch.zeros((b, nh, dh), **f32),
             "m": torch.full((b, nh), -1e9, **f32),
             "conv": torch.zeros((b, xlstm.CONV - 1, d_in), **f32)}
    with torch.no_grad():
        got = xlstm.mlstm_apply(layer, cfg32, x)
        want, _ = xlstm.mlstm_step(layer, cfg32, x, state)
    err = check_close(f"{XLSTM_TRAIN_PATH}: mlstm_apply vs mlstm_step",
                      got - x, want - x, XLSTM_FORMS_TOL)
    return {"tokens": XLSTM_FORMS_TOKENS, "max_abs_err": err,
            "block_out_max": float((want - x).abs().max())}


def bf16_shares(names, g16, g32):
    """Each bf16 gradient leaf's distance from the f32 twin's, over the
    twin's norm."""
    import torch
    share = {}
    for n, a, b in zip(names, g16, g32):
        norm = float(torch.linalg.vector_norm(b.float()))
        dist = float(torch.linalg.vector_norm(a.float() - b.float()))
        share[n] = dist / max(norm, 1e-30)
    return share


def xlstm_gate_model(dev):
    """The bf16 gate's model and batch (``XLSTM_GATE_*``): xlstm-125m at
    full width cut to ``XLSTM_GATE_LAYERS``, made by ``init_model`` and
    every drawn leaf redrawn by numpy from SEED in ``named_parameters``
    order, N(0, 0.1^2) for the convolutions and N(0, 0.02^2) for the rest
    as ``init_model`` draws them (the norm scales and gate biases keep
    their fixed values), so that the CPU and the card hold the same bits;
    returns (cfg, params on ``dev``, the batch in numpy)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    cfg = dataclasses.replace(registry.get(XLSTM),
                              n_layers=XLSTM_GATE_LAYERS)
    params = M.init_model(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for n, p in params.named_parameters():
            if n.endswith(("gate_bias", "scale")):
                continue
            std = np.float32(0.1 if n.endswith("conv_w") else 0.02)
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape), dtype=np.float32) * std))
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=XLSTM_GATE_BATCH,
        seq_len=XLSTM_GATE_SEQ, seed=SEED)).batch(0)
    return cfg, params, batch


def weights_sha(params) -> str:
    """sha256 of every parameter's bytes, in order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for p in params.parameters():
        h.update(p.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def xlstm_bf16_gate(dev):
    """The bf16 leaf rule on the card at the gate's inputs
    (``xlstm_gate_model``, the weights' sha256 checked): the loss (TOL)
    and each gradient leaf of the bf16 model against its f32 twin, each
    leaf within ``bf16_limit``; returns each leaf's distance over its
    norm."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps as steps_lib
    path = f"{XLSTM_TRAIN_PATH} bf16 gate"
    cfg, params, batch = xlstm_gate_model(dev)
    sha = weights_sha(params)
    if sha != XLSTM_GATE_SHA:
        fail(f"{path}: the gate's weights hash to {sha}, not the "
             f"{XLSTM_GATE_SHA} the reference's errors were measured on")
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b = to_device(batch, dev)
    wide = copy.deepcopy(params).float().requires_grad_(True)
    params.requires_grad_(True)
    l16, g16 = steps_lib.loss_and_grads(params, cfg, rc, b)
    l32, g32 = steps_lib.loss_and_grads(
        wide, cfg32, dataclasses.replace(rc, model=cfg32), b)
    names = [n for n, _ in params.named_parameters()]
    bad = [n for n, g in zip(names, g16) if not torch.isfinite(g).all()]
    if bad:
        fail(f"{path}: non-finite bf16 gradients {bad}")
    share = bf16_shares(names, g16, g32)
    over = {n: (x, bf16_limit(n)) for n, x in share.items()
            if x > bf16_limit(n)}
    if over:
        fail(f"{path}: bf16 gradients off the f32 twin's beyond the bf16 "
             f"leaf rule (leaf: (distance, bound) over its norm): {over}")
    if abs(float(l16) - float(l32)) > TOL["atol"] + TOL["rtol"] * abs(
            float(l32)):
        fail(f"{path}: bf16 loss {float(l16)} vs the f32 twin's "
             f"{float(l32)}")
    return {"n_layers": XLSTM_GATE_LAYERS, "batch": XLSTM_GATE_BATCH,
            "seq_len": XLSTM_GATE_SEQ, "loss_bf16": float(l16),
            "loss_f32": float(l32), "share": share,
            "share_over_bound_max": max(x / bf16_limit(n)
                                        for n, x in share.items())}


def train_xlstm(dev):
    """Train full-width xlstm-125m on one rank (XLSTM_TRAIN_*): first the
    training form against the serving one in f32 (``xlstm_forms``), the
    bf16 leaf rule at the gate's inputs (``xlstm_bf16_gate``), the first
    step's bf16 loss against an f32 twin at the same weights (TOL; each
    gradient leaf's distance from the twin's reported), then the steps,
    timed by CUDA events: every loss finite, the first within 1.5 of ln
    V; no kernel launched (the family has none)."""
    import copy
    import dataclasses
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = registry.get(XLSTM)
    shape = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=XLSTM_TRAIN_BATCH,
                                seq_len=XLSTM_TRAIN_SEQ)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    params = M.init_model(cfg, seed=SEED, device=dev)
    res = {"forms": xlstm_forms(dev, params, cfg),
           "batch": XLSTM_TRAIN_BATCH, "seq_len": XLSTM_TRAIN_SEQ,
           "n_layers": cfg.n_layers, "ln_vocab": math.log(cfg.vocab_size)}
    log(f"{XLSTM_TRAIN_PATH}: mlstm_apply vs mlstm_step in f32 "
        f"{res['forms']}")
    res["bf16_gate"] = gate = xlstm_bf16_gate(dev)
    worst = sorted(gate["share"].items(), key=lambda kv: -kv[1])[:4]
    log(f"{XLSTM_TRAIN_PATH}: bf16 leaf rule at {XLSTM_GATE_LAYERS} layers, "
        f"{XLSTM_GATE_BATCH} x {XLSTM_GATE_SEQ} tokens: loss bf16 "
        f"{gate['loss_bf16']:.6f} vs f32 twin {gate['loss_f32']:.6f}; each "
        f"leaf within {gate['share_over_bound_max']:.3f} of its bound (the "
        f"farthest from the twin {worst})")
    free_card()
    batch = to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=XLSTM_TRAIN_BATCH,
        seq_len=XLSTM_TRAIN_SEQ, seed=SEED)).batch(0), dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rc32 = dataclasses.replace(rc, model=cfg32)
    wide = copy.deepcopy(params).float().requires_grad_(True)
    params.requires_grad_(True)
    zero_counters()
    l16, g16 = steps_lib.loss_and_grads(params, cfg, rc, batch)
    l32, g32 = steps_lib.loss_and_grads(wide, cfg32, rc32, batch)
    names = [n for n, _ in params.named_parameters()]
    bad = [n for n, g in zip(names, g16) if not torch.isfinite(g).all()]
    if bad:
        fail(f"{XLSTM_TRAIN_PATH}: non-finite bf16 gradients {bad}")
    share = bf16_shares(names, g16, g32)
    res.update(loss_bf16=float(l16), loss_f32=float(l32),
               grad_share_max=max(share.values()), grad_share=share)
    if abs(float(l16) - float(l32)) > TOL["atol"] + TOL["rtol"] * abs(
            float(l32)):
        fail(f"{XLSTM_TRAIN_PATH}: bf16 loss {float(l16)} vs the f32 "
             f"twin's {float(l32)}")
    del wide, g16, g32
    free_card()
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    state = steps_lib.init_state(params, rc, opt_cfg)
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(XLSTM_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        step_ms.append(start.elapsed_time(end))
    launches, off = split_counts(XLSTM_TRAIN_PATH, read_counters(), ())
    tokens = XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ
    res.update(losses=losses, step_ms=step_ms, launches=launches,
               off_path_launches=off, tokens_per_step=tokens,
               tokens_per_s=tokens / (min(step_ms[1:]) / 1e3),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    worst = sorted(share.items(), key=lambda kv: -kv[1])[:4]
    log(f"{XLSTM_TRAIN_PATH}: first step's loss bf16 {res['loss_bf16']:.6f} "
        f"vs f32 twin {res['loss_f32']:.6f}; bf16 gradients within "
        f"{res['grad_share_max']:.4f} of each leaf's norm (not gated: the "
        f"reference's error is not known here; the farthest {worst}); "
        f"losses {losses};"
        f" step ms {step_ms} ({tokens} tokens a step); peak "
        f"{res['peak_gib']:.2f} GiB; no kernel launched")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{XLSTM_TRAIN_PATH}: non-finite loss {losses}")
    if abs(losses[0] - res["ln_vocab"]) > 1.5:
        fail(f"{XLSTM_TRAIN_PATH}: first loss {losses[0]} not within 1.5 of "
             f"ln V = {res['ln_vocab']}")
    return res


def dp_train_model(dev, arch=ARCH):
    """The dp-train phase's model (qwen3-1.7b at full width cut to
    ``DP_TRAIN_LAYERS``), or a family of ``TPF_TRAIN`` at its cut, random
    bf16 weights from the seed on ``dev``, its run config and its global
    batch (numpy; the VLM's vision embeddings with it)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    layers, n_batch, seq = TPF_TRAIN.get(arch, (
        DP_TRAIN_LAYERS, DP_TRAIN_BATCH, DP_TRAIN_SEQ))
    cfg = dataclasses.replace(registry.get(arch), n_layers=layers)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=n_batch,
                                seq_len=seq)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    vision = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=n_batch, seq_len=seq,
        seed=SEED, vision_tokens=vision, d_model=cfg.d_model)).batch(0)
    return cfg, rc, M.init_model(cfg, seed=SEED, device=dev), batch


def dp_train_file(arch=ARCH):
    name = "one_rank.pt" if arch == ARCH else f"one_rank_{arch}.pt"
    return os.path.join(ROOT, "build", "dp_train", name)


def first_moments(grads, gnorm, opt_cfg):
    """AdamW's first moments after one step from zero on ``grads`` whose
    global norm is ``gnorm``: ``optim.adamw.update``'s arithmetic (the
    clip in f32, each gradient cast back to its dtype, then ``(1 - b1)``
    of it in f32)."""
    import torch
    norm = torch.tensor(gnorm, dtype=torch.float32, device=grads[0].device)
    scale = torch.clamp(opt_cfg.grad_clip / (norm + 1e-9), max=1.0)
    return [(1 - opt_cfg.b1) * (g.float() * scale).to(g.dtype).float()
            for g in grads]


def noise_gate(path, what, dist, noise, norms):
    """Fail unless each leaf's distance from the one rank's (``dist``,
    name -> float) is within ``TP_NOISE_X`` times the one rank's own
    distance from its f32 twin (``noise``) plus 1e-6 of the twin's norm
    (``norms``); returns the largest ratio to that noise."""
    for n, d in dist.items():
        if d > TP_NOISE_X * noise[n] + 1e-6 * norms[n]:
            fail(f"{path}: {what} {n} off the one rank's by {d}, beyond "
                 f"{TP_NOISE_X} x its own {noise[n]} from the f32 twin")
    return max(d / max(noise[n], 1e-30) for n, d in dist.items())


def dp_train_one_rank(dev, arch=ARCH):
    """The one-rank port's loss and gradients on the dp-train phase's
    global batch (or a ``TPF_TRAIN`` family's), and its f32 twin's (the
    same weights widened): the gradients, their global norm and, per
    leaf, the one rank's own distance from the twin, of the gradients and
    of the first moments after one AdamW step, saved for the dp2 and tp2
    train phases' ranks; then its step timed (the bytes of the whole
    state, its peak)."""
    import copy
    import dataclasses
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    cfg, rc, params, batch = dp_train_model(dev, arch)
    b = to_device(batch, dev)
    params.requires_grad_(True)
    l1, g1 = steps_lib.loss_and_grads(params, cfg, rc, b)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wide = copy.deepcopy(params).float()
    l32, g32 = steps_lib.loss_and_grads(
        wide, cfg32, dataclasses.replace(rc, model=cfg32), b)
    names = [n for n, _ in params.named_parameters()]
    noise = {n: float(torch.linalg.vector_norm(a.float() - c))
             for n, a, c in zip(names, g1, g32)}
    norms = {n: float(torch.linalg.vector_norm(c))
             for n, c in zip(names, g32)}
    # one AdamW step: the one rank's first moments (from its gradients and
    # their clip norm, ``first_moments``) against its f32 twin's after one
    # step from the same weights, per leaf
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    del g32
    free_card()
    state32 = steps_lib.init_state(wide, dataclasses.replace(
        rc, model=cfg32), opt_cfg)
    state32, _ = steps_lib.build_train_step(
        cfg32, dataclasses.replace(rc, model=cfg32), opt_cfg)(state32, b)
    gnorm = float(adamw.global_norm(g1))
    m1 = first_moments(g1, gnorm, opt_cfg)
    m_noise = {n: float(torch.linalg.vector_norm(a - c))
               for n, a, c in zip(names, m1, state32.opt.m)}
    m_norms = {n: float(torch.linalg.vector_norm(c))
               for n, c in zip(names, state32.opt.m)}
    del state32, m1
    os.makedirs(os.path.dirname(dp_train_file(arch)), exist_ok=True)
    torch.save({"loss": float(l1), "loss_f32": float(l32),
                "grad_norm": gnorm,
                "grads": {n: g.cpu() for n, g in zip(names, g1)}},
               dp_train_file(arch))
    del wide, g1
    free_card()
    state = steps_lib.init_state(params, rc, opt_cfg)
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3 if arch == ARCH else TPF_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    opt = state.opt
    out = {"loss": float(l1), "loss_f32": float(l32), "noise": noise,
           "norms": norms, "m_noise": m_noise, "m_norms": m_norms,
           "grad_norm": gnorm, "step_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bytes": {k: sum(t.numel() * t.element_size() for t in ts)
                     for k, ts in (("params", list(params.parameters())),
                                   ("m", opt.m), ("v", opt.v),
                                   ("master", opt.master))}}
    return out


def dp_train_rank(rank_mesh):
    """One rank of the dp-train phase (a process of its own, on the card
    it shares with the other): the whole model made on the card and
    placed on the POOL tier with its AdamW state (``steps.init_state(
    mesh=)``), its rows of the global batch; the loss and gradients, its
    shard's distance from the one-rank gradients, a whole step on and off from
    copies of the state (bit for bit equal), then the steps timed in
    turns, a layer's gather alone, a layer's and the embedding's gradient
    reduced as DS on and as DS off does it, bytes and peak. The
    kernel counts run from before the first loss to after the last step
    (the main path: no kernel runs under grad)."""
    import copy
    import dataclasses
    import gc
    import torch
    from repro_torch.core import deterministic_store as ds
    from repro_torch.data.pipeline import rows_of, to_device
    from repro_torch.launch import mesh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    dev = rank_mesh.device
    cfg, rc, whole, batch = dp_train_model(dev)
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    state = steps_lib.init_state(whole, rc, opt_cfg, mesh=rank_mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    group = rank_mesh.data
    b = to_device(rows_of(batch, group.rank, group.size), dev)
    specs = steps_lib.param_spec_list(state.params, rc)
    names = [n for n, _ in state.params.named_parameters()]
    axes = sharding.fsdp_axes(state.params)
    zero_counters()
    loss, g_on = steps_lib.loss_and_grads(state.params, cfg, rc, b,
                                          group=group,
                                          reducer=ds.GradReducer(group))
    g_on = ds.apply_ds(g_on, specs, group=group)
    out = {"coords": rank_mesh.coords, "loss": float(loss), "axes": axes}
    ref = torch.load(dp_train_file())
    sq = {}
    for n, a, g in zip(names, axes, g_on):
        want = ref["grads"][n].to(dev)
        if a is not None:
            want = want.narrow(a, group.rank * g.shape[a], g.shape[a])
        sq[n] = float(((g.float() - want.float()) ** 2).sum())
    out["sq_dist"] = sq
    del g_on, ref
    gc.collect()
    torch.cuda.empty_cache()
    # the timed steps, DS on and off in DP_TRAIN_ORDERS' turns; the first
    # turn's two steps start from the same state (the second from a copy
    # taken before the first, which works in place), and their results
    # must be equal bit for bit
    steps_of = {on: steps_lib.build_train_step(
        cfg, dataclasses.replace(rc, ds_enabled=on), opt_cfg,
        mesh=rank_mesh) for on in (True, False)}
    times = {True: [], False: []}
    colls, after = {}, {}
    spare = copy.deepcopy(state)
    for turn, order in enumerate(DP_TRAIN_ORDERS):
        for on in order:
            if turn == 0 and on != order[0]:
                state = spare
            mesh.COLLECTIVES.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = steps_of[on](state, b)
            end.record()
            torch.cuda.synchronize()
            times[on].append(start.elapsed_time(end))
            colls["ds_on" if on else "ds_off"] = dict(mesh.COLLECTIVES)
            out.setdefault("losses", []).append(float(metrics["loss"]))
            if turn == 0:
                after[on] = (state, metrics["loss"])
        if turn == 0:
            (a, la), (o, lo) = after[True], after[False]
            out["step_ds_off_bit_equal"] = bool(torch.equal(la, lo) and all(
                torch.equal(x, y) for x, y in zip(
                    list(a.params.parameters()) + a.opt.m + a.opt.v
                    + a.opt.master, list(o.params.parameters()) + o.opt.m
                    + o.opt.v + o.opt.master)))
            state = after[order[0]][0]
            del after, spare, a, o
            gc.collect()
            torch.cuda.empty_cache()
    out["counts"] = read_counters()
    out["step_ms"] = {"ds_on": times[True], "ds_off": times[False]}
    out["collectives"] = colls
    layer = state.params.blocks[0]
    out["gather_layer_ms"] = time_ms(
        lambda: sharding.FsdpRead(layer, group).wait(), 5)
    # a unit's f32 gradient reduced as DS on does it (reduce-scatter) and
    # as DS off does it (all-reduce of the whole buffer), in alternated
    # turns: a layer, and the tied embedding (gathered once a step)
    for unit, obj, turns, iters in (("layer", layer, 2, 3),
                                    ("embed", state.params.embed, 1, 2)):
        shards = [p for p in obj.parameters() if p.shape]
        buf = torch.zeros((group.size, sum(p.numel() for p in shards)),
                          dtype=torch.float32, device=dev)
        rs, ar = [], []
        for _ in range(turns):
            rs.append(time_ms(lambda: group.reduce_scatter(buf, 0), iters,
                              warmup=1))
            ar.append(time_ms(lambda: group.all_reduce(buf, "sum"), iters,
                              warmup=1))
        out[f"reduce_scatter_{unit}_ms"] = rs
        out[f"all_reduce_{unit}_ms"] = ar
        out[f"{unit}_grad_bytes_f32"] = buf.numel() * 4
        del buf
    opt = state.opt
    out["bytes"] = {k: sum(t.numel() * t.element_size() for t in ts)
                    for k, ts in (("params", list(state.params.parameters())),
                                  ("m", opt.m), ("v", opt.v),
                                  ("master", opt.master))}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, opt, layer
    gc.collect()
    torch.cuda.empty_cache()
    out["device_pool"] = device_pool_step(rank_mesh, b, names, opt_cfg)
    return out


def device_pool_step(rank_mesh, b, names, opt_cfg):
    """One step of the dp-train model with DEVICE weights (whole on both
    ranks) beside POOL m, v and masters (each rank's FSDP shard,
    ``steps.state_moves``): its loss, and each leaf's squared distance of
    the first moments from the one rank's (``first_moments`` of the saved
    gradients), on this rank's shard of the state; its collectives and
    bytes."""
    import dataclasses
    import gc
    import torch
    from repro_torch.launch import mesh
    from repro_torch.launch import steps as steps_lib
    dev = rank_mesh.device
    cfg, rc, whole, _ = dp_train_model(dev)
    rc = dataclasses.replace(rc, param_tier="device", optimizer_tier="pool")
    state = steps_lib.init_state(whole, rc, opt_cfg, mesh=rank_mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    moves = steps_lib.state_moves(state.params, rc, rank_mesh)
    mesh.COLLECTIVES.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = steps_lib.build_train_step(cfg, rc, opt_cfg,
                                                mesh=rank_mesh)(state, b)
    end.record()
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss"]),
           "step_ms": start.elapsed_time(end),
           "collectives": dict(mesh.COLLECTIVES),
           "sliced": [mv is not None for mv in moves]}
    ref = torch.load(dp_train_file())
    rank = rank_mesh.data.rank
    sq = {}
    for n, mv, m in zip(names, moves, state.opt.m):
        want = first_moments([ref["grads"][n].to(dev)], ref["grad_norm"],
                             opt_cfg)[0]
        if mv is not None:
            want = want.narrow(mv[1], rank * m.shape[mv[1]], m.shape[mv[1]])
        sq[n] = float(((m - want) ** 2).sum())
    out["m_sq_dist"] = sq
    opt = state.opt
    out["bytes"] = {k: sum(t.numel() * t.element_size() for t in ts)
                    for k, ts in (("params", list(state.params.parameters())),
                                  ("m", opt.m), ("v", opt.v),
                                  ("master", opt.master))}
    return out


def train_dp(dev, one):
    """The dp-train phase: two rank processes of mesh (2, 1) on the one
    card joined by gloo (``launch.mesh.spawn``), each on its POOL shard
    of qwen3-1.7b's weights and AdamW state (``DP_TRAIN_LAYERS``) and its
    rows of the global batch; every layer gathered in its remat'd body
    and its gradients reduce-scattered by the deterministic store. Held:
    the ranks' loss and gradients (their shards put together; the whole
    leaves all-reduced) within ``TP_NOISE_X`` times the one-rank port's
    own distance from its f32 twin (``one``: ``dp_train_one_rank``), the
    loss plus TOL's atol; a whole step with DS off bit for bit the step
    with DS on; the ranks' losses alike; no kernel launched (the training
    forward runs none); the collectives of a step by axis."""
    import math
    from repro_torch.launch import mesh
    t0 = time.time()
    ranks = mesh.spawn(dp_train_rank, math.prod(DP_TRAIN_MESH), (),
                       rendezvous_dir=os.path.join(ROOT, "build", "dp_train"),
                       device="cuda", timeout_s=DP_TRAIN_TIMEOUT_S,
                       mesh_shape=DP_TRAIN_MESH)
    spawn_s = time.time() - t0
    path, first = DP_TRAIN_PATH, ranks[0]
    noise_loss = abs(one["loss"] - one["loss_f32"])
    for r, run in enumerate(ranks):
        if run["losses"] != first["losses"] or run["loss"] != first["loss"]:
            fail(f"{path} rank {r}: losses {run['losses']} differ from "
                 f"rank 0's {first['losses']}")
        if not run["step_ds_off_bit_equal"]:
            fail(f"{path} rank {r}: a step with the deterministic store off "
                 f"is not bit for bit the step with it on")
    if abs(first["loss"] - one["loss"]) > TP_NOISE_X * noise_loss + \
            TOL["atol"]:
        fail(f"{path}: loss {first['loss']} vs one rank's {one['loss']}, "
             f"beyond {TP_NOISE_X} x {noise_loss} + {TOL['atol']}")
    dist = {}
    for i, (n, a) in enumerate(zip(first["sq_dist"], first["axes"])):
        sq = (sum(run["sq_dist"][n] for run in ranks) if a is not None
              else first["sq_dist"][n])
        dist[n] = math.sqrt(sq)
        if dist[n] > TP_NOISE_X * one["noise"][n] + 1e-6 * one["norms"][n]:
            fail(f"{path}: gradient {n} off the one rank's by {dist[n]}, "
                 f"beyond {TP_NOISE_X} x its own {one['noise'][n]} from the "
                 f"f32 twin")
    # DEVICE weights beside POOL state: the loss and the first moments
    dpool = [r["device_pool"] for r in ranks]
    if any(d["loss"] != dpool[0]["loss"] for d in dpool):
        fail(f"{path} DEVICE beside POOL: the ranks' losses differ: "
             f"{[d['loss'] for d in dpool]}")
    if abs(dpool[0]["loss"] - one["loss"]) > TP_NOISE_X * noise_loss + \
            TOL["atol"]:
        fail(f"{path} DEVICE beside POOL: loss {dpool[0]['loss']} vs one "
             f"rank's {one['loss']}, beyond {TP_NOISE_X} x {noise_loss} + "
             f"{TOL['atol']}")
    m_dist = {n: math.sqrt(sum(d["m_sq_dist"][n] for d in dpool) if sliced
                           else dpool[0]["m_sq_dist"][n])
              for n, sliced in zip(dpool[0]["m_sq_dist"], dpool[0]["sliced"])}
    m_ratio = noise_gate(f"{path} DEVICE beside POOL", "first moment",
                         m_dist, one["m_noise"], one["m_norms"])
    launches, off = split_counts(path, first["counts"], ())
    out = {"spawn_s": spawn_s, "mesh": DP_TRAIN_MESH,
           "device_pool": {"loss": dpool[0]["loss"],
                           "m_dist_over_noise_max": m_ratio,
                           "step_ms": [d["step_ms"] for d in dpool],
                           "collectives": dpool[0]["collectives"],
                           "bytes": [d["bytes"] for d in dpool]},
           "n_layers": DP_TRAIN_LAYERS, "batch": DP_TRAIN_BATCH,
           "seq_len": DP_TRAIN_SEQ, "launches": launches,
           "off_path_launches": off, "loss": first["loss"],
           "one_rank_loss": one["loss"], "one_rank_loss_f32": one["loss_f32"],
           "grad_dist_over_noise_max": max(
               dist[n] / max(one["noise"][n], 1e-30) for n in dist),
           "losses": first["losses"],
           "step_ms": [r["step_ms"] for r in ranks],
           "collectives": first["collectives"],
           "gather_layer_ms": [r["gather_layer_ms"] for r in ranks],
           **{f"{op}_{unit}_ms": [r[f"{op}_{unit}_ms"] for r in ranks]
              for op in ("reduce_scatter", "all_reduce")
              for unit in ("layer", "embed")},
           "layer_grad_bytes_f32": first["layer_grad_bytes_f32"],
           "embed_grad_bytes_f32": first["embed_grad_bytes_f32"],
           "bytes": [r["bytes"] for r in ranks],
           "one_rank_bytes": one["bytes"],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "one_rank_peak_gib": one["peak_gib"],
           "one_rank_step_ms": one["step_ms"]}
    log(f"{path}: loss {first['loss']:.6f} on both ranks (one rank "
        f"{one['loss']:.6f}, its f32 twin {one['loss_f32']:.6f}); "
        f"gradients within {out['grad_dist_over_noise_max']:.3f} x the one "
        f"rank's own distance from its f32 twin; a step with DS off bit for "
        f"bit DS on's; step ms {out['step_ms']} (one rank "
        f"{one['step_ms']}); collectives a step {out['collectives']}; a "
        f"layer's gather {out['gather_layer_ms']} ms; a layer's f32 "
        f"gradient ({out['layer_grad_bytes_f32']} bytes) reduce-scattered "
        f"(DS on) {out['reduce_scatter_layer_ms']} ms, all-reduced (DS "
        f"off) {out['all_reduce_layer_ms']} ms; the embedding's "
        f"({out['embed_grad_bytes_f32']} bytes) "
        f"{out['reduce_scatter_embed_ms']} / {out['all_reduce_embed_ms']} "
        f"ms; bytes a rank {out['bytes']} "
        f"(one rank {one['bytes']}); peak GiB {out['peak_gib']} (one rank "
        f"{one['peak_gib']:.2f}); spawn {spawn_s:.1f} s")
    dp_ = out["device_pool"]
    log(f"{path} DEVICE weights beside POOL m, v and masters: loss "
        f"{dp_['loss']:.6f}; first moments within {m_ratio:.3f} x the one "
        f"rank's own distance from its f32 twin; step ms {dp_['step_ms']}; "
        f"collectives {dp_['collectives']}; bytes a rank {dp_['bytes']}")
    return out


def tp_train_rank(rank_mesh, arch=ARCH):
    """One rank of the tp2-train phase (a process of its own, on the card
    it shares with the other): the dp-train phase's model (or a
    ``TPF_TRAIN`` family's) made on the card and cut to this rank's shard
    of the model axis (``steps.init_state(mesh=)``: every leaf
    ``param_specs`` splits on "model" halved), the whole global batch; the
    loss and gradients under the model axis's split
    (``steps.loss_and_grads(ranks=)``), each leaf's squared distance from
    the one rank's gradient's part, then ``TP_TRAIN_STEPS`` (a family:
    ``TPF_TRAIN_STEPS``) steps timed, the first moments after the first
    against the one rank's (``first_moments``), the collectives of a step
    by axis, bytes and peak. The kernel counts run from before the first
    loss to after the last step."""
    import gc
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import mesh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw
    dev = rank_mesh.device
    cfg, rc, whole, batch = dp_train_model(dev, arch)
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    state = steps_lib.init_state(whole, rc, opt_cfg, mesh=rank_mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = to_device(batch, dev)
    ranks = steps_lib.train_ranks_of(rc, rank_mesh)
    specs = dict(zip([n for n, _ in state.params.named_parameters()],
                     steps_lib.param_spec_list(state.params, rc)))
    model = rank_mesh.model
    zero_counters()
    loss, grads = steps_lib.loss_and_grads(state.params, cfg, rc, b,
                                           ranks=ranks)
    ref = torch.load(dp_train_file(arch))

    def part(n, t):
        spec = specs[n]
        if "model" not in spec:
            return t
        axis = spec.index("model")
        k = t.shape[axis] // model.size
        return t.narrow(axis, model.rank * k, k)
    sq = {n: float(((g.float() - part(n, ref["grads"][n].to(dev)).float())
                    ** 2).sum())
          for n, g in zip(specs, grads)}
    out = {"coords": rank_mesh.coords, "loss": float(loss), "sq_dist": sq,
           "split": {n: "model" in spec for n, spec in specs.items()}}
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    step = steps_lib.build_train_step(cfg, rc, opt_cfg, mesh=rank_mesh)
    times, losses = [], []
    for i in range(TP_TRAIN_STEPS if arch == ARCH else TPF_TRAIN_STEPS):
        mesh.COLLECTIVES.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, b)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        if i == 0:
            out["collectives"] = dict(mesh.COLLECTIVES)
            out["grad_norm"] = float(metrics["grad_norm"])
            m_sq = {}
            for n, m in zip(specs, state.opt.m):
                want = first_moments([ref["grads"][n].to(dev)],
                                     ref["grad_norm"], opt_cfg)[0]
                m_sq[n] = float(((m - part(n, want)) ** 2).sum())
            out["m_sq_dist"] = m_sq
    out["counts"] = read_counters()
    out["step_ms"], out["losses"] = times, losses
    opt = state.opt
    out["bytes"] = {k: sum(t.numel() * t.element_size() for t in ts)
                    for k, ts in (("params", list(state.params.parameters())),
                                  ("m", opt.m), ("v", opt.v),
                                  ("master", opt.master))}
    out["split_param_bytes"] = sum(
        p.numel() * p.element_size()
        for n, p in zip(specs, state.params.parameters())
        if "model" in specs[n])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def train_tp(dev, one):
    """The tp2-train phase: two rank processes of mesh (1, 2) on the one
    card joined by gloo (``launch.mesh.spawn``), each on its model-axis
    shard of the dp-train phase's qwen3-1.7b (``DP_TRAIN_LAYERS`` layers
    at full width, 4 x 1024 tokens a step, POOL tier) and the whole
    batch: Megatron's split under grad (``launch.steps``). Held against
    the one rank (``one``: ``dp_train_one_rank``) by the multi-rank rule:
    the loss, every gradient leaf (the ranks' parts put together) and the
    first moments after one AdamW step, each within ``TP_NOISE_X`` times
    the one rank's own distance from its f32 twin (the loss plus TOL's
    atol); the ranks' losses and clip norms alike; no kernel launched
    (the training forward runs none). Reported: a rank's step ms, the
    collectives of a step by axis, parameter and state bytes a rank
    against one rank's, the peak a rank."""
    import math
    from repro_torch.launch import mesh
    t0 = time.time()
    ranks = mesh.spawn(tp_train_rank, math.prod(TP_TRAIN_MESH), (),
                       rendezvous_dir=os.path.join(ROOT, "build", "dp_train"),
                       device="cuda", timeout_s=DP_TRAIN_TIMEOUT_S,
                       mesh_shape=TP_TRAIN_MESH)
    return check_tp_train(TP_TRAIN_PATH, ARCH, ranks, one,
                          time.time() - t0)


def tp_train_families_rank(rank_mesh):
    """One rank of the tp2-train-families phase: ``tp_train_rank`` for
    each family of ``TPF_TRAIN`` in turn, the card freed between."""
    import gc
    import torch
    out = {}
    for arch in TPF_TRAIN:
        out[arch] = tp_train_rank(rank_mesh, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_tp_families(dev):
    """The tp2-train-families phase: each family of ``TPF_TRAIN`` on one
    rank and its f32 twin first (``dp_train_one_rank``), then one spawn of
    two rank processes of mesh (1, 2) on the one card joined by gloo, each
    family on its model-axis shard in turn (``tp_train_families_rank``):
    the hybrid's Mamba2 heads and shared block, the VLM's self-attention
    and cross layers (Megatron's form), xLSTM's layers whole on every rank
    from their split leaves gathered. Each family held and reported as the tp2-train phase holds
    and reports qwen3-1.7b (``check_tp_train``)."""
    import math
    from repro_torch.launch import mesh
    one = {}
    for arch in TPF_TRAIN:
        one[arch] = dp_train_one_rank(dev, arch)
        free_card()
    t0 = time.time()
    ranks = mesh.spawn(tp_train_families_rank, math.prod(TP_TRAIN_MESH), (),
                       rendezvous_dir=os.path.join(ROOT, "build", "dp_train"),
                       device="cuda", timeout_s=DP_TRAIN_TIMEOUT_S,
                       mesh_shape=TP_TRAIN_MESH)
    spawn_s = time.time() - t0
    return {f"{arch} tp2 train": check_tp_train(
        f"{arch} tp2 train", arch, [r[arch] for r in ranks], one[arch],
        spawn_s) for arch in TPF_TRAIN}


def check_tp_train(path, arch, ranks, one, spawn_s):
    """A tp2-train path from its ranks' reports (``tp_train_rank``)
    against its one rank's (``dp_train_one_rank``), by the rule of
    ``train_tp``; returns the path's record."""
    import math
    first = ranks[0]
    layers, n_batch, seq = TPF_TRAIN.get(arch, (
        DP_TRAIN_LAYERS, DP_TRAIN_BATCH, DP_TRAIN_SEQ))
    noise_loss = abs(one["loss"] - one["loss_f32"])
    for r, run in enumerate(ranks):
        if (run["losses"] != first["losses"] or run["loss"] != first["loss"]
                or run["grad_norm"] != first["grad_norm"]):
            fail(f"{path} rank {r}: losses {run['losses']} / clip norm "
                 f"{run['grad_norm']} differ from rank 0's "
                 f"{first['losses']} / {first['grad_norm']}")
    if abs(first["loss"] - one["loss"]) > TP_NOISE_X * noise_loss + \
            TOL["atol"]:
        fail(f"{path}: loss {first['loss']} vs one rank's {one['loss']}, "
             f"beyond {TP_NOISE_X} x {noise_loss} + {TOL['atol']}")

    def dist(key):
        return {n: math.sqrt(sum(run[key][n] for run in ranks) if split
                             else first[key][n])
                for n, split in first["split"].items()}
    g_ratio = noise_gate(path, "gradient", dist("sq_dist"), one["noise"],
                         one["norms"])
    m_ratio = noise_gate(path, "first moment", dist("m_sq_dist"),
                         one["m_noise"], one["m_norms"])
    launches, off = split_counts(path, first["counts"], ())
    out = {"spawn_s": spawn_s, "mesh": TP_TRAIN_MESH,
           "n_layers": layers, "batch": n_batch,
           "seq_len": seq, "launches": launches,
           "off_path_launches": off, "loss": first["loss"],
           "one_rank_loss": one["loss"], "one_rank_loss_f32": one["loss_f32"],
           "grad_dist_over_noise_max": g_ratio,
           "m_dist_over_noise_max": m_ratio,
           "grad_norm": first["grad_norm"], "one_rank_grad_norm":
           one["grad_norm"], "losses": first["losses"],
           "step_ms": [r["step_ms"] for r in ranks],
           "one_rank_step_ms": one["step_ms"],
           "collectives": first["collectives"],
           "bytes": [r["bytes"] for r in ranks],
           "one_rank_bytes": one["bytes"],
           "split_param_bytes": [r["split_param_bytes"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "one_rank_peak_gib": one["peak_gib"]}
    log(f"{path}: loss {first['loss']:.6f} on both ranks (one rank "
        f"{one['loss']:.6f}, its f32 twin {one['loss_f32']:.6f}); gradients "
        f"within {g_ratio:.3f} x and first moments after one step within "
        f"{m_ratio:.3f} x the one rank's own distance from its f32 twin; "
        f"step ms {out['step_ms']} (one rank {one['step_ms']}); "
        f"collectives a step {out['collectives']}; bytes a rank "
        f"{out['bytes']} (one rank {one['bytes']}; the model-split "
        f"leaves' {out['split_param_bytes']}); peak GiB {out['peak_gib']} "
        f"(one rank {one['peak_gib']:.2f}); spawn {spawn_s:.1f} s")
    return out


def host_pinned_check(path, tensors):
    """Every tensor of ``tensors`` (name -> tensor) is a pinned host
    tensor on the HOST tier: none on the card, none pageable."""
    from repro_torch.core import hdm
    bad = [n for n, t in tensors.items()
           if t.is_cuda or not t.is_pinned() or hdm.host_target(t) is None]
    if bad:
        fail(f"{path}: HOST leaves on the card or not pinned: {bad[:5]} "
             f"(of {len(bad)})")
    return len(tensors)


def unit_bytes(unit) -> int:
    roots = unit if isinstance(unit, tuple) else (unit,)
    return sum(p.numel() * p.element_size() for r in roots
               for p in r.parameters())


def copy_rates(dev, n_bytes=1 << 30):
    """The HOST tier's link: the GB/s of ``hdm.host_empty`` pinning two
    buffers of ``n_bytes`` (host clock), and of one pinned host -> card
    and card -> host copy of ``n_bytes`` on the tier's side streams, each
    alone and both at once (their total; CUDA events, best of 3)."""
    import torch
    from repro_torch.core import hdm
    from repro_torch.parallel import sharding
    t0 = time.perf_counter()
    host, back = hdm.host_empty([((n_bytes,), torch.uint8)] * 2, dev)
    out = {"pin": 2 * n_bytes / (time.perf_counter() - t0) / 1e9}
    card, card2 = (torch.empty(n_bytes, dtype=torch.uint8, device=dev)
                   for _ in range(2))
    cur = torch.cuda.current_stream(dev)
    streams = {"h2d": sharding.copy_stream(dev, "h2d"),
               "d2h": sharding.copy_stream(dev, "d2h")}
    pairs = {"h2d": (card, host), "d2h": (back, card2)}
    for kind, kinds in (("h2d", ("h2d",)), ("d2h", ("d2h",)),
                        ("both", ("h2d", "d2h"))):
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(cur)
            for k in kinds:
                streams[k].wait_stream(cur)
                with torch.cuda.stream(streams[k]):
                    pairs[k][0].copy_(pairs[k][1], non_blocking=True)
            for k in kinds:     # both issued before either is waited for
                cur.wait_stream(streams[k])
            end.record(cur)
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out[kind] = len(kinds) * n_bytes / (min(ms) / 1e3) / 1e9
    return out


def host_serve(dev):
    """``HOST_SERVE_PATH``: full-width qwen3-1.7b (``HOST_SERVE_LAYERS``) on
    the DEVICE engine, then from the same weights on the HOST tier
    (``param_tier="host"``, ``enable_host_tier``, SR depth 1) on the same
    traffic: every HOST leaf pinned; greedy tokens, restores and the
    tier's ops and op_ns equal to the DEVICE engine's; no weight left on
    the card between steps, and no more than the stream's window (the
    leaves outside the stream and depth + 1 layers) on it during one;
    both kernels launched once per layer per tick and per chunk, as many
    times as on the DEVICE engine. Then the tick and the chunk timed at SR depth
    1 and 0 in ``HOST_ORDERS``' turns, the copies of one tick alone, and
    the share of them the prefetch hides."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.core import hdm
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import Request, ServingEngine
    path = HOST_SERVE_PATH
    cfg = dataclasses.replace(registry.get(ARCH), n_layers=HOST_SERVE_LAYERS)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    rc_host = dataclasses.replace(rc, param_tier="host",
                                  enable_host_tier=True, sr_prefetch_depth=1)
    config = ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, tier_topology=TOPOLOGY,
                         store_budget_bytes=16 << 30, seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROMPT_LENS, N_HOST_REQUESTS)]

    def run(engine):
        t0 = time.time()
        first = [engine.submit(Request(rid=i, prompt=p,
                                       max_new_tokens=HOST_MAX_NEW))
                 for i, p in enumerate(prompts)]
        engine.run(max_ticks=10_000)
        again = [engine.submit(Request(rid=1000 + i, prompt=prompts[i],
                                       max_new_tokens=HOST_MAX_NEW))
                 for i in range(N_HOST_RESUBMIT)]
        engine.run(max_ticks=10_000)
        torch.cuda.synchronize()
        return {"wall_s": time.time() - t0,
                "tokens": [h.result() for h in first + again],
                "restored": [h.request.restored for h in again],
                "ops": engine.tier.ops, "op_ns": engine.tier.op_ns,
                "per_layer_step": {
                    "paged_decode": cfg.n_layers
                    * engine.stats["decode_dispatches"],
                    "flash_prefill": cfg.n_layers
                    * engine.stats["prefill_dispatches"]}}

    on_path = ("paged_decode", "flash_prefill")
    params = M.init_model(cfg, seed=SEED, device=dev)
    engine = ServingEngine(params, cfg, rc, config=config, device=dev)
    zero_counters()
    want = run(engine)
    device_launches, _ = split_counts(f"{path} DEVICE", read_counters(),
                                      on_path)
    del engine
    free_card()
    t0 = time.time()
    engine = ServingEngine(params, cfg, rc_host, config=config, device=dev)
    place_s = time.time() - t0
    del params
    free_card()
    n_pinned = host_pinned_check(path, dict(engine.params.named_parameters()))
    outside = sum(unit_bytes(u) for u in M._outside(engine.params, cfg))
    layer = max(unit_bytes(u) for u in M._units(engine.params, cfg))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    sharding.HOST_COPIED.update(h2d=0, d2h=0)
    zero_counters()             # the main path: counts from 0, read after
    got = run(engine)
    counts = read_counters()
    launches, off_path = split_counts(path, counts, on_path)
    peak = torch.cuda.max_memory_allocated(dev) - base
    left = torch.cuda.memory_allocated(dev) - base
    h2d_bytes = sharding.HOST_COPIED["h2d"]
    window = outside + 2 * layer + (128 << 20)
    res = {"n_layers": cfg.n_layers, "place_s": place_s,
           "host_leaves_pinned": n_pinned, "weight_bytes": outside + sum(
               unit_bytes(u) for u in M._units(engine.params, cfg)),
           "outside_bytes": outside, "layer_bytes": layer,
           "card_peak_over_base": peak, "card_left_over_base": left,
           "window_bytes": window, "h2d_bytes_run": h2d_bytes,
           "launches": launches, "off_path_launches": off_path,
           "device_launches": device_launches,
           "launches_per_layer_step": got["per_layer_step"],
           "wall_s": got["wall_s"], "device_wall_s": want["wall_s"],
           "tokens_equal": got["tokens"] == want["tokens"],
           "restored": got["restored"],
           "ops_equal": got["ops"] == want["ops"],
           "op_ns_equal": got["op_ns"] == want["op_ns"],
           "host_bytes": hdm.host_bytes()}
    log(f"{path}: {res}")
    if not res["tokens_equal"]:
        fail(f"{path}: greedy tokens differ from the DEVICE engine's: "
             f"{got['tokens']} vs {want['tokens']}")
    if not (res["ops_equal"] and res["op_ns_equal"]):
        fail(f"{path}: the tier's ops / op_ns differ from the DEVICE "
             f"engine's")
    if not all(got["restored"]):
        fail(f"{path}: a resubmitted request was not restored")
    if min(launches.values()) <= 0:
        fail(f"{path}: a kernel of the path never launched: {launches}")
    if launches != got["per_layer_step"] or launches != device_launches:
        fail(f"{path}: launches {launches}, want one per layer per tick "
             f"and per chunk {got['per_layer_step']}, as the DEVICE "
             f"engine's {device_launches}")
    if left > layer:
        fail(f"{path}: {left} bytes stay on the card after the run, more "
             f"than a layer's {layer}")
    if peak > window:
        fail(f"{path}: {peak} bytes on the card during a step, beyond the "
             f"stream's window of {window}")
    # a pageable leaf marked for the HOST tier: its copy must raise, not
    # run in line
    probe = torch.nn.Linear(4, 4, bias=False)
    setattr(probe.weight, sharding.HOST_TARGET, dev)
    try:
        sharding.HostRead(probe).wait()
    except RuntimeError as e:
        res["pageable_leaf_refused"] = str(e)
    else:
        fail(f"{path}: a pageable HOST leaf was copied")
    chunk = torch.tensor([prompts[0][:CHUNK]], dtype=torch.int32,
                         device=dev)

    def prefill_chunk():
        cache1 = M.slot_view(engine.cache, 0)
        cache1["pos"] = torch.zeros(1, dtype=torch.int32, device=dev)
        M.prefill_step_cached(engine.params, cfg, engine._hot_rc, chunk,
                              cache1, last_only=True)
    times = {0: {"tick": [], "chunk": []}, 1: {"tick": [], "chunk": []}}
    for order in HOST_ORDERS:
        for depth in order:
            engine._hot_rc = dataclasses.replace(rc_host,
                                                 sr_prefetch_depth=depth)
            times[depth]["tick"].append(time_ms(engine._decode_sample, 5))
            times[depth]["chunk"].append(time_ms(prefill_chunk, 3))
    engine._hot_rc = rc_host
    units = [*M._outside(engine.params, cfg), *M._units(engine.params, cfg)]
    h2d_ms = time_ms(lambda: [sharding.HostRead(u).wait() for u in units], 3)
    tick = {d: min(t["tick"]) for d, t in times.items()}
    chunk_ms = {d: min(t["chunk"]) for d, t in times.items()}
    res.update(turns=[list(o) for o in HOST_ORDERS], times_ms=times,
               tick_ms=tick, chunk_ms=chunk_ms, h2d_ms_tick=h2d_ms,
               h2d_gb_s=res["weight_bytes"] / (h2d_ms / 1e3) / 1e9,
               hidden_share_tick=(tick[0] - tick[1]) / h2d_ms,
               hidden_share_chunk=(chunk_ms[0] - chunk_ms[1]) / h2d_ms)
    log(f"{path}: tick ms by depth {times_ms_line(times, 'tick')}, chunk "
        f"ms {times_ms_line(times, 'chunk')}; the copies of a tick alone "
        f"{h2d_ms:.3f} ms ({res['h2d_gb_s']:.1f} GB/s); hidden by the "
        f"prefetch: tick {res['hidden_share_tick']:.3f}, chunk "
        f"{res['hidden_share_chunk']:.3f}")
    del engine
    return res


def times_ms_line(times, key):
    return {d: [round(x, 3) for x in t[key]] for d, t in times.items()}


def host_train_rc(cfg, tier, depth):
    import dataclasses
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=HOST_BATCH,
                                seq_len=HOST_SEQ)
    return RunConfig(model=cfg, shape=shape, mesh=MeshConfig(),
                     param_tier=tier, optimizer_tier=tier,
                     enable_host_tier=tier == "host",
                     sr_prefetch_depth=depth)


def host_batch(cfg, dev):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    return to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=HOST_BATCH,
        seq_len=HOST_SEQ, seed=SEED)).batch(0), dev)


def state_leaves(state):
    """name -> tensor of every parameter, moment and master of a training
    state."""
    names = [n for n, _ in state.params.named_parameters()]
    out = {f"params/{n}": p for n, p in state.params.named_parameters()}
    for key in ("m", "v", "master"):
        out.update({f"{key}/{n}": t for n, t in
                    zip(names, getattr(state.opt, key))})
    return out


def host_train_gate(dev):
    """``HOST_TRAIN_PATH`` (a): glm4-9b cut to ``HOST_GATE_LAYERS``
    layers, ``HOST_GATE_STEPS`` steps on the HOST tier (every leaf of the
    state pinned; the forward loss at SR depth 0 and 1 equal bit for
    bit), then as many on the DEVICE twin from the same weights and
    batch, the card freed in between: every parameter, moment and master
    equal bit for bit (each HOST leaf copied onto the card and its bytes
    compared with the twin's there), the losses and gradient norms
    equal."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    path = f"{HOST_TRAIN_PATH} gate"
    cfg = dataclasses.replace(registry.get(GLM4), n_layers=HOST_GATE_LAYERS)
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    batch = host_batch(cfg, dev)
    runs, states = {}, {}
    for tier in ("host", "device"):
        rc = host_train_rc(cfg, tier, 1)
        params = M.init_model(cfg, seed=SEED, device=dev)
        state = steps_lib.init_state(params, rc, opt_cfg)
        del params
        free_card()
        res = {}
        if tier == "host":
            res["pinned"] = host_pinned_check(path, state_leaves(state))
            with torch.no_grad():
                losses = [M.loss_fn(state.params, cfg, dataclasses.replace(
                    rc, sr_prefetch_depth=d), batch,
                    host_grads=sharding.HostGrads()) for d in (0, 1)]
            res["forward_loss_d0_d1"] = [float(x) for x in losses]
            if not torch.equal(losses[0].view(torch.int32),
                               losses[1].view(torch.int32)):
                fail(f"{path}: the forward loss at depth 0 and 1 differ: "
                     f"{res['forward_loss_d0_d1']}")
        step = steps_lib.build_train_step(cfg, rc, opt_cfg)
        res["losses"], res["grad_norms"] = [], []
        for _ in range(HOST_GATE_STEPS):
            state, metrics = step(state, batch)
            res["losses"].append(float(metrics["loss"]))
            res["grad_norms"].append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        runs[tier], states[tier] = res, state
        del state, step
        free_card()
    host, card = (state_leaves(states[t]) for t in ("host", "device"))
    differ = [n for n, t in host.items() if not torch.equal(
        t.detach().to(dev).reshape(-1).view(torch.uint8),
        card[n].detach().reshape(-1).view(torch.uint8))]
    out = {"n_layers": cfg.n_layers, "steps": HOST_GATE_STEPS,
           "leaves_compared": len(host), "leaves_differing": differ,
           "host": runs["host"], "device": runs["device"]}
    log(f"{path}: {out}")
    if differ:
        fail(f"{path}: {len(differ)} leaves differ from the DEVICE twin's "
             f"bits: {differ[:5]}")
    if (runs["host"]["losses"] != runs["device"]["losses"]
            or runs["host"]["grad_norms"] != runs["device"]["grad_norms"]):
        fail(f"{path}: losses or gradient norms differ from the DEVICE "
             f"twin's")
    del states, host, card
    free_card()
    return out


def host_memory_readings():
    """(MemAvailable, the cgroup's memory limit) in bytes: cgroup v2's
    ``memory.max`` or v1's ``memory.limit_in_bytes`` (None where neither
    is readable or it is unlimited)."""
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    limit = None
    for name in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(name) as f:
                text = f.read().strip()
        except OSError:
            continue
        if text != "max" and int(text) < 1 << 60:
            limit = int(text)
        break
    return avail, limit


def settled_memory(tries=30, step_s=0.5, close=256 << 20):
    """``host_memory_readings`` once MemAvailable stops rising (memory an
    earlier phase unmapped comes back to it seconds later on the card's
    machine), and the seconds and bytes that return took."""
    t0 = time.perf_counter()
    first, limit = host_memory_readings()
    avail = first
    for _ in range(tries):
        time.sleep(step_s)
        again, limit = host_memory_readings()
        if again - avail < close:
            avail = max(avail, again)
            break
        avail = again
    return avail, limit, {"settle_s": time.perf_counter() - t0,
                          "settle_rise": avail - first}


def host_train_depth(cfg):
    """The depth ``HOST_TRAIN_PATH`` (b) trains at and why: the full
    depth if its pinned bytes (2 + 12 bytes a parameter: bf16 weights,
    f32 m, v and master) are at most ``HOST_FULL_SHARE`` of the smaller
    reading of ``host_memory_readings``; else the deepest cut of at least
    ``HOST_MIN_LAYERS`` layers that leaves ``HOST_HEADROOM`` of
    MemAvailable unpinned; else the deepest cut that does."""
    import dataclasses
    avail, limit, settle = settled_memory()
    smaller = min(x for x in (avail, limit) if x is not None)

    def pinned(n):
        return 14 * dataclasses.replace(cfg, n_layers=n).n_params()
    info = {"mem_available": avail, "cgroup_limit": limit,
            "pinned_full": pinned(cfg.n_layers), **settle}
    if pinned(cfg.n_layers) <= HOST_FULL_SHARE * smaller:
        return cfg.n_layers, dict(info, rule="full depth")
    fits = [n for n in range(1, cfg.n_layers + 1)
            if pinned(n) + HOST_HEADROOM <= avail]
    if not fits:
        fail(f"{HOST_TRAIN_PATH}: not one layer's state fits in "
             f"{avail} bytes of host memory")
    n = max(fits)
    rule = ("the deepest cut leaving the headroom" if n >= HOST_MIN_LAYERS
            else f"the deepest cut that fits, under {HOST_MIN_LAYERS}: "
                 f"the state does not pass the card's memory")
    return n, dict(info, rule=rule, pinned=pinned(n))


def first_loss(cfg) -> float:
    """The expected cross-entropy of random weights: the final norm's
    unit-variance output times an N(0, 0.02^2) unembedding gives logits
    of variance d (0.02)^2, whose log-sum-exp over V tokens averages ln V
    + d (0.02)^2 / 2 (qwen3-1.7b, d 2048: 12.34; PERF.md section 7 has
    12.31 for its first step)."""
    import math
    return math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2


def host_train(dev):
    """``HOST_TRAIN_PATH`` (b): glm4-9b at full width, one rank, weights,
    m, v and master on the HOST tier (pinned host memory), at
    ``host_train_depth``'s depth; a step of ``HOST_BATCH`` x
    ``HOST_SEQ`` tokens at each SR depth of ``HOST_TRAIN_DEPTHS`` (CUDA
    events), each step's optimizer timed
    alone; the bytes copied each way a step, the copy rates, the card's
    peak (under its total), the pinned bytes against the bytes held, the
    state at 16 bytes a parameter against the card's memory; the loss
    finite, the first within 0.5 of ``first_loss``; no kernel
    launched."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import hdm
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    path = HOST_TRAIN_PATH
    full = registry.get(GLM4)
    n_layers, why = host_train_depth(full)
    why["host_bytes_before"] = hdm.host_bytes()
    cfg = dataclasses.replace(full, n_layers=n_layers)
    log(f"{path}: {n_layers} of {full.n_layers} layers ({why})")
    opt_cfg = adamw.AdamWConfig(learning_rate=TRAIN_LR, warmup_steps=0)
    rc = host_train_rc(cfg, "host", 1)
    batch = host_batch(cfg, dev)
    t0 = time.time()
    params = M.init_model(cfg, seed=SEED, device=dev)
    state = steps_lib.init_state(params, rc, opt_cfg)
    del params
    free_card()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    pinned = host_pinned_check(path, state_leaves(state))
    steps = {d: steps_lib.build_train_step(
        cfg, dataclasses.replace(rc, sr_prefetch_depth=d), opt_cfg)
        for d in set(HOST_TRAIN_DEPTHS)}
    update, opt_ms = adamw.update, []

    def timed_update(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(*args, **kwargs)
        end.record()
        end.synchronize()
        opt_ms.append(start.elapsed_time(end))
        return out
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    losses, step_ms, copied = [], [], []
    steps_lib.adamw.update = timed_update
    try:
        for depth in HOST_TRAIN_DEPTHS:
            sharding.HOST_COPIED.update(h2d=0, d2h=0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = steps[depth](state, batch)
            end.record()
            losses.append(float(metrics["loss"]))
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            copied.append(dict(sharding.HOST_COPIED))
    finally:
        steps_lib.adamw.update = update
    counts = read_counters()
    if any(counts.values()):
        fail(f"{path}: a kernel launched under grad: {counts}")
    launches, off_path = split_counts(path, counts, ())
    total = torch.cuda.get_device_properties(dev).total_memory
    rates = copy_rates(dev)
    by_depth = {d: [ms for dd, ms in zip(HOST_TRAIN_DEPTHS, step_ms)
                    if dd == d] for d in set(HOST_TRAIN_DEPTHS)}
    weights_ms = (sum(unit_bytes(u) for u in M._outside(state.params, cfg))
                  + 2 * sum(unit_bytes(u) for u in M._units(state.params,
                                                             cfg))) / (
        rates["h2d"] * 1e6)
    res = {"n_layers": n_layers, "depth_rule": why, "init_s": init_s,
           "launches": launches, "off_path_launches": off_path,
           "n_params": n_params, "state_bytes_16": 16 * n_params,
           "card_total": total,
           "state_passes_card": 16 * n_params > total,
           "host_leaves_pinned": pinned, "host_bytes": hdm.host_bytes(),
           "batch": HOST_BATCH, "seq_len": HOST_SEQ,
           "depths": list(HOST_TRAIN_DEPTHS), "losses": losses,
           "ln_vocab": math.log(cfg.vocab_size),
           "first_loss_expected": first_loss(cfg), "step_ms": step_ms,
           "step_ms_by_depth": by_depth, "optimizer_ms": opt_ms,
           "optimizer_share": [o / s for o, s in zip(opt_ms, step_ms)],
           "copied_bytes": copied, "copy_gb_s": rates,
           "h2d_ms_step": [c["h2d"] / (rates["h2d"] * 1e6) for c in copied],
           "d2h_ms_step": [c["d2h"] / (rates["d2h"] * 1e6) for c in copied],
           "layer_copies_ms_step": weights_ms,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "grad_norm": float(metrics["grad_norm"])}
    d0, d1 = min(by_depth[0]), min(by_depth[1])
    res["hidden_share"] = (d0 - d1) / weights_ms
    log(f"{path}: {res}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{path}: non-finite loss {losses}")
    if abs(losses[0] - res["first_loss_expected"]) > 0.5:
        fail(f"{path}: first loss {losses[0]} not within 0.5 of ln V + "
             f"d (0.02)^2 / 2 = {res['first_loss_expected']}")
    if torch.cuda.max_memory_allocated(dev) >= total:
        fail(f"{path}: peak card memory {res['peak_gib']} GiB at the "
             f"card's total")
    del state, steps
    free_card()
    res["host_bytes_after"] = hdm.host_bytes()
    return res


# ------------------------------------------------------- open-loop phase

def open_model(dev, dtype=None, params=None):
    """qwen3-1.7b at full width cut to ``OPEN_LAYERS`` layers: random bf16
    weights drawn on ``dev`` from the seed, or ``params`` widened to
    ``dtype`` (the f32 twin)."""
    import copy
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    cfg = dataclasses.replace(registry.get(ARCH), n_layers=OPEN_LAYERS)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        params = copy.deepcopy(params).float()
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    if params is None:
        params = M.init_model(cfg, seed=SEED, device=dev)
    return cfg, rc, params


def open_config(**knobs):
    """Phase 3's engine knobs (8 slots of 2048 tokens, 256-token chunks)
    with ``knobs``."""
    from repro_torch.serving.config import ServeConfig
    return ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                       store_budget_bytes=16 << 30, seed=SEED, **knobs)


def open_closed(dev, params, cfg, rc, trace):
    """The trace's arrivals served closed: all submitted at once, no
    preemption, no tier (its charges move no token), each request's greedy
    logits rows captured (``capturing_logits``). Returns its tokens, rows
    (on the card) and the restored rids."""
    from repro_torch.serving.engine import Request, ServingEngine
    engine = ServingEngine(params, cfg, rc, config=open_config(), device=dev)
    with capturing_logits() as rows:
        handles = [engine.submit(Request(
            rid=a.rid, prompt=list(a.prompt), max_new_tokens=a.max_new,
            priority=a.priority)) for a in trace]
        engine.run(max_ticks=10_000)
    if not all(h.done() for h in handles):
        fail(f"{OPEN_PATH}: the closed run left requests unfinished")
    return {"tokens": {h.rid: h.result() for h in handles},
            "rows": dict(rows),
            "restored": sorted(h.rid for h in handles if h.request.restored)}


def replay_ops(ops, kw):
    """The scalar oracle's replay of a tier's ``ops`` (run in a worker
    process, beside the card's work)."""
    from repro_torch.sim.engine import replay_page_trace
    return [float(x) for x in replay_page_trace(ops, **kw)]


def open_run(dev, params, cfg, rc, policy, pool):
    """One open-loop run of ``OPEN_LOAD`` with ``policy``: the trace
    driven by ``serving.loadgen.drive_open_loop`` on an engine with a DRAM
    + SSD tier and async tier I/O; the scalar oracle's replay of the
    tier's ops submitted to ``pool``."""
    import torch
    from repro_torch.serving import loadgen
    from repro_torch.serving.engine import ServingEngine
    load = loadgen.LoadConfig(**OPEN_LOAD)
    engine = ServingEngine(params, cfg, rc, config=open_config(
        tier_topology=TOPOLOGY, cxl_async=True, preempt_policy=policy),
        device=dev)
    t0 = time.time()
    handles, depths = loadgen.drive_open_loop(engine,
                                              loadgen.make_trace(load))
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    metrics = loadgen.summarize(engine, handles, depths, load)
    tc = engine.tier.cfg
    replay = pool.submit(replay_ops, list(engine.tier.ops), dict(
        media=tc.media_name, topology=tc.port_medias, sr=tc.sr_enabled,
        ds=tc.ds_enabled, req_bytes=tc.req_bytes,
        dram_cache_bytes=tc.dram_cache_bytes, max_inflight=tc.max_inflight,
        faults=tc.faults))
    st = engine.stats
    return engine, replay, {
        "policy": policy, "wall_s": wall_s,
        "metrics": metrics.as_dict(), "queue_depths": list(depths),
        "tokens": {h.rid: h.tokens() for h in handles},
        "done": sum(h.done() for h in handles),
        "decode_ticks": st["decode_dispatches"],
        "prefill_chunks": st["prefill_dispatches"],
        "ticks": len(depths),
        "swap_out_bytes": st["swap_out_bytes"],
        "swap_in_bytes": st["swap_in_bytes"],
        "restore_stall_ns": st["restore_stall_ns"],
        "restore_overlap_ratio": st["restore_overlap_ratio"],
        "sched_inflight_peak": st["sched_inflight_peak"],
        "tier_ops": len(engine.tier.ops),
        "op_ns": list(engine.tier.op_ns)}


def open_tokens_gate(policy, tokens, closed, bound):
    """Each request's greedy tokens of the open-loop run against the same
    arrival served closed: equal, or parted at a step where the closed
    run's logits of its token and the open run's lie within ``bound`` of
    each other (a near tie; later tokens are conditioned on another one
    and not held). Returns {rid: (step, tokens, gap)} of the partings."""
    parted = {}
    for rid, want in closed["tokens"].items():
        got = tokens[rid]
        if len(got) != len(want):
            fail(f"{OPEN_PATH} {policy}: rid {rid} has {len(got)} tokens, "
                 f"closed {len(want)}")
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is None:
            continue
        rows = closed["rows"].get(rid, [])
        skip = len(want) - len(rows)    # a restored request's first token
        if skip not in (0, 1) or j < skip:
            fail(f"{OPEN_PATH} {policy}: rid {rid} parts from the closed "
                 f"run at token {j} ({got[j]} against {want[j]}), where "
                 f"the closed run sampled no row")
        row = rows[j - skip].float()
        if int(row.argmax()) != want[j]:
            fail(f"{OPEN_PATH}: the closed run's rid {rid} row {j} does not "
                 f"give its own token")
        gap = float(row[want[j]] - row[got[j]])
        if gap > bound:
            fail(f"{OPEN_PATH} {policy}: rid {rid} token {j} is {got[j]} "
                 f"against the closed run's {want[j]}, whose logits are "
                 f"{gap} apart there: not a near tie (bound {bound})")
        parted[rid] = (j, [want[j], got[j]], gap)
    return parted


def open_bound(closed, wide):
    """The bound of a near tie: ``TP_NOISE_X`` times the closed run's
    largest distance from its f32 twin's logits, plus TOL's atol. A
    request's rows are compared while both runs' rows are conditioned on
    the same tokens: up to and including the first step whose argmaxes
    part, and not at all for a restored request whose first token (its
    source's) parted. Returns (bound, that distance, rows compared)."""
    noise, held = 0.0, 0
    for rid, toks in closed["tokens"].items():
        if toks[:len(toks) - len(closed["rows"][rid])] != \
                wide["tokens"][rid][:len(toks) - len(closed["rows"][rid])]:
            continue
        for a, b in zip(closed["rows"][rid], wide["rows"][rid]):
            a, b = a.float(), b.float()
            noise, held = max(noise, float((a - b).abs().max())), held + 1
            if int(a.argmax()) != int(b.argmax()):
                break
    if not held:
        fail(f"{OPEN_PATH}: no row of the closed run held to its f32 twin")
    return TP_NOISE_X * noise + TOL["atol"], noise, held


def serve_open_loop(dev, card):
    """The open-loop phase: the closed run and its f32 twin (the bound of
    a near tie), then the main path -- the trace played once with each
    preemption policy -- with its kernels' launches counted from 0, and
    the gates of each run."""
    import gc
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch.serving import loadgen
    trace = loadgen.make_trace(loadgen.LoadConfig(**OPEN_LOAD))
    cfg, rc, params = open_model(dev)
    closed = open_closed(dev, params, cfg, rc, trace)
    cfg32, rc32, p32 = open_model(dev, "float32", params)
    wide = open_closed(dev, p32, cfg32, rc32, trace)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    if wide["tokens"].keys() != closed["tokens"].keys() or \
            wide["restored"] != closed["restored"]:
        fail(f"{OPEN_PATH}: the f32 twin served or restored other requests")
    bound, noise, held = open_bound(closed, wide)
    del wide
    out = {"n_layers": OPEN_LAYERS, "load": OPEN_LOAD,
           "closed_restored": closed["restored"], "bound": bound,
           "f32_twin_noise": noise, "f32_twin_rows_held": held, "runs": {}}
    log(f"{OPEN_PATH}: closed run of the {len(trace)} arrivals: "
        f"{len(closed['restored'])} restored; near-tie bound {bound:.4f} "
        f"({TP_NOISE_X} x its distance {noise:.4f} from the f32 twin over "
        f"{held} rows + {TOL['atol']}) ({card})")

    # the main path: counts from 0 just before, read just after
    engines, replays = [], {}
    with ProcessPoolExecutor(len(OPEN_POLICIES), mp_context=(
            multiprocessing.get_context("spawn"))) as pool:
        zero_counters()
        for policy in OPEN_POLICIES:
            engine, replays[policy], out["runs"][policy] = open_run(
                dev, params, cfg, rc, policy, pool)
            engines.append(engine)
        torch.cuda.synchronize()
        counts = read_counters()
        launches, off_path = split_counts(
            OPEN_PATH, counts, ("paged_decode", "flash_prefill"))
        out.update(step_costs(engines[-1], params, cfg, rc,
                              list(trace[0].prompt), dev))
        replayed = {policy: r.result() for policy, r in replays.items()}
    out["launches"], out["off_path_launches"] = launches, off_path

    runs = out["runs"]
    ticks = sum(r["decode_ticks"] for r in runs.values())
    chunks = sum(r["prefill_chunks"] for r in runs.values())
    want = {"paged_decode": OPEN_LAYERS * ticks,
            "flash_prefill": OPEN_LAYERS * chunks}
    if launches != want:
        fail(f"{OPEN_PATH}: launches {launches}, want once per layer per "
             f"step {want}")
    for policy, run in runs.items():
        m, name = run["metrics"], f"{OPEN_PATH} {policy}"
        if not (m["completed"] == m["arrivals"] == run["done"]
                == len(trace)) or m["lost_requests"]:
            fail(f"{name}: {m['completed']} of {m['arrivals']} arrivals "
                 f"completed, {m['lost_requests']} lost")
        if m["preemptions"] < 1 or m["prefix_hits"] < 1:
            fail(f"{name}: {m['preemptions']} preemptions, "
                 f"{m['prefix_hits']} prefix hits")
        if policy == "swap" and not (
                run["swap_in_bytes"] == run["swap_out_bytes"] > 0):
            fail(f"{name}: swapped {run['swap_out_bytes']} bytes out, "
                 f"{run['swap_in_bytes']} in")
        got, ref = np.asarray(run.pop("op_ns")), np.asarray(replayed[policy])
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)
        run["op_ns_vs_replay_max_rel"] = float(err.max())
        if got.shape != ref.shape or not np.all(
                np.abs(got - ref) <= OPEN_REPLAY_RTOL * np.abs(ref)):
            fail(f"{name}: the tier's op_ns off the scalar oracle's replay "
                 f"by {float(err.max())} (rtol {OPEN_REPLAY_RTOL})")
        run["parted"] = open_tokens_gate(policy, run.pop("tokens"), closed,
                                         bound)
        log(f"{name}: {m['completed']}/{m['arrivals']} arrivals in "
            f"{run['wall_s']:.2f} s wall, {run['ticks']} ticks "
            f"({run['decode_ticks']} decode, {run['prefill_chunks']} prefill "
            f"chunks), {1e3 * run['wall_s'] / max(run['ticks'], 1):.1f} ms "
            f"wall a tick ({card})")
        log(f"{name}: simulated TTFT p50/p99 {m['ttft_ms_p50']}/"
            f"{m['ttft_ms_p99']} ms, TPOT p50/p99 {m['tpot_ms_p50']}/"
            f"{m['tpot_ms_p99']} ms, goodput {m['goodput_req_s']} req/s "
            f"({m['completed_in_slo']} in SLO), throughput "
            f"{m['throughput_req_s']} req/s, queue depth p50/p99 "
            f"{m['queue_depth_p50']}/{m['queue_depth_p99']}, restore stall "
            f"p50/p99 {m['restore_stall_ms_p50']}/"
            f"{m['restore_stall_ms_p99']} ms, {m['preemptions']} "
            f"preemptions, {m['prefix_hits']} prefix hits, "
            f"{m['sim_time_ms']} ms simulated")
        log(f"{name}: swap {run['swap_out_bytes']} bytes out / "
            f"{run['swap_in_bytes']} in, restore overlap "
            f"{run['restore_overlap_ratio']:.3f}, op_ns vs replay max rel "
            f"{run['op_ns_vs_replay_max_rel']:.2e} over {run['tier_ops']} "
            f"ops; tokens parted from the closed run at near ties: "
            f"{run['parted']}")
    out["wall_s"] = sum(r["wall_s"] for r in runs.values())
    out["launches_per_tick"] = launches["paged_decode"] / ticks
    out["launches_per_chunk"] = launches["flash_prefill"] / chunks
    log(f"{OPEN_PATH}: launches on the main path {launches} "
        f"({out['launches_per_tick']} paged_decode a decode tick, "
        f"{out['launches_per_chunk']} flash_prefill a prefill chunk); "
        f"decode tick "
        f"{out['decode_tick_ms']:.3f} ms, prefill chunk "
        f"{out['prefill_chunk_ms']:.3f} ms (CUDA events) ({card})")
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help=(
        "a checkout of the commit before the f32 flash_prefill (D 256) / "
        "paged_matmul redesign: its two scalar instances are built and "
        "timed beside the new ones"))
    args = ap.parse_args()
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this smoke needs the card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:    # every nvcc starts at once
        built = pool.submit(build.build)
        parent_built = pool.submit(parent_library, args.parent)
        lib_path, parent = built.result(), parent_built.result()
    build.library()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f}s -> {lib_path}; parent's "
        f"flash_prefill and paged_matmul: "
        f"{'built from ' + args.parent if parent else 'not built'}")
    ptxas = ptxas_report((lib_path.parent / "build.log").read_text())
    for row in ptxas:
        log(f"ptxas: {row['kernel']}: {row['used']}; {row['spill']}")
    plans = launch_plans()
    for name, p in plans.items():
        log(f"plan: {name}: {p}")

    with phase("kernel checks"):
        dec = check_decode(dev, 8, 2, 128)
        log(f"paged_decode ok: {dec['shape']}; {dec}")
        dec80 = check_decode(dev, 32, 1, 80)
        log(f"paged_decode ok: {dec80['shape']}; {dec80}")
        dec256 = check_decode(dev, 1, 8, 256)
        log(f"paged_decode ok: {dec256['shape']}; {dec256}")
        pre = check_prefill(dev, 8, 2, 128)
        log(f"flash_prefill ok: {pre['shape']}; {pre}")
        pre80 = check_prefill(dev, 32, 1, 80)
        log(f"flash_prefill ok: {pre80['shape']}; {pre80}")
        # D 64: granite's heads (Hkv 8, G 2) and musicgen's (Hkv 32, G 1)
        # over their serving paths' slots
        dec64 = {GRANITE: check_decode(dev, 8, 2, 64),
                 MUSICGEN: check_decode(dev, 32, 1, 64, MUSICGEN_MAX_SEQ)}
        pre64 = {GRANITE: check_prefill(dev, 8, 2, 64),
                 MUSICGEN: check_prefill(dev, 32, 1, 64, MUSICGEN_MAX_SEQ)}
        for arch in (GRANITE, MUSICGEN):
            log(f"paged_decode ok: {dec64[arch]['shape']}; {dec64[arch]}")
            log(f"flash_prefill ok: {pre64[arch]['shape']}; {pre64[arch]}")
        dec_g4, pre_g4 = check_vlm_kernels(dev)
        dec_g, dec8_g, pre_g = check_group_kernels(dev)
        dec_ml = check_decode_ml(dev)
        log(f"paged_decode m / l output ok (both modes, two ranks' views, "
            f"combined): {dec_ml}")
        dec_dp = check_decode_dp_view(dev)
        log(f"paged_decode m / l at the dp path's rank view ok: "
            f"{dec_dp['shape']}; {dec_dp}")
        dec8 = check_decode_int8(dev, 8, 2, 128)
        log(f"paged_decode int8 ok: {dec8['shape']}; {dec8}")
        dec8_256 = check_decode_int8(dev, 1, 8, 256)
        log(f"paged_decode int8 ok: {dec8_256['shape']}; {dec8_256}")
        dec_edges = check_decode_edges(dev)
        log(f"paged_decode edges ok (both modes): {dec_edges}")
        pre_edges = check_prefill_edges(dev)
        log(f"flash_prefill edges ok: {pre_edges}")
        pre32 = check_prefill_f32(dev)
        log(f"flash_prefill f32 ok: {pre32['shape']}; {pre32}")
        pre256 = check_prefill_d256(dev)
        log(f"flash_prefill D256 ok: {pre256['shape']}; {pre256}")
        pre32_256 = check_prefill_tf32_256(dev, parent)
        log(f"flash_prefill f32 D256 ok: {pre32_256['shape']}; {pre32_256}")
        pre_sc = check_prefill_scalar(dev)
        log(f"flash_prefill scalar ok: {pre_sc['shape']}; {pre_sc}")
        ssd = check_ssd(dev)
        log(f"ssd_scan ok: {ssd['shape']}; {ssd}")
        ssd40 = check_ssd(dev, 40, sweep=False)
        log(f"ssd_scan at a rank's 40 heads ok: {ssd40['shape']}; {ssd40}")
        refused = check_refusals(dev)
        log(f"C entries refuse what check_plan refuses (rc): {refused}")
        mm = check_paged_matmul(dev)
        log(f"paged_matmul ok: {mm['shape']}; {mm}")
        mm32 = check_paged_matmul_f32(dev, parent)
        log(f"paged_matmul f32 ok: {mm32}")
    with phase("small models"):
        small = {arch: check_model_small(dev, arch)
                 for arch in (ARCH, HYBRID, GRANITE, MUSICGEN, VLM, XLSTM)}
        small[f"{ARCH} int8"] = check_model_small(dev, ARCH, "int8")
        for arch, res in small.items():
            log(f"small {arch} (f32) on the card agrees with the CPU: {res}")

    with phase(ARCH):
        run = serve(dev)
        report(ARCH, run)
        check_restores(ARCH, run)
    free_card()

    with phase(HYBRID):
        hyb = serve_fresh(dev, HYBRID, N_HYBRID_REQUESTS,
                          ("paged_decode", "flash_prefill", "ssd_scan"))
        log(f"{HYBRID} chunked vs stepwise prefill: {hyb['stepwise']}")
        report(HYBRID, hyb)
        if hyb["flushes"] <= 0 or hyb["tier_write_ns"] <= 0:
            fail(f"{HYBRID}: no pages flushed to the tier")
    free_card()

    int8_name = f"{ARCH} int8"
    with phase(int8_name):
        run8 = serve(dev, "int8")
        report(int8_name, run8)
        check_int8_run(int8_name, run8, run)
    free_card()

    with phase(GEMMA):
        gem = serve(dev, arch=GEMMA)
        report(GEMMA, gem)
        check_restores(GEMMA, gem)
        check_per_step(GEMMA, gem, "flash_prefill_d256", "paged_decode")
    free_card()

    gem8_name = f"{GEMMA} int8"
    with phase(gem8_name):
        gem8 = serve(dev, "int8", arch=GEMMA)
        report(gem8_name, gem8)
        check_int8_run(gem8_name, gem8, gem)
        check_per_step(gem8_name, gem8, "flash_prefill_tf32_256",
                       "paged_decode_int8")
    free_card()

    with phase(GRANITE):
        gran = serve(dev, arch=GRANITE)
        report(GRANITE, gran)
        log(f"{GRANITE}: (token, expert) pairs dropped at capacity: "
            f"{gran['dropped_pairs']}")
        check_restores(GRANITE, gran, tokens=False)
        check_per_step(GRANITE, gran, "flash_prefill", "paged_decode")
    free_card()

    with phase(MUSICGEN):
        mus = serve(dev, arch=MUSICGEN)
        report(MUSICGEN, mus)
        check_restores(MUSICGEN, mus)
        check_per_step(MUSICGEN, mus, "flash_prefill", "paged_decode")
    free_card()

    with phase(VLM):
        vlm = serve_vlm(dev)
    free_card()

    with phase(XLSTM):
        xl = serve_xlstm(dev)
    free_card()

    groups = {}
    for arch in (GLM4, STARCODER2):
        with phase(arch):
            groups[arch] = serve_group(dev, arch)
        free_card()

    with phase("tp2"):
        tp = serve_tp(dev)
    free_card()

    with phase("dp2xtp2"):
        dp_one = dp_one_rank(dev)
        free_card()
        dp = serve_dp(dev, dp_one)
    free_card()

    with phase(TRAIN_PATH):
        pre_train = check_train_prefill(dev)
        log(f"flash_prefill ok: {pre_train['shape']}; {pre_train}")
        free_card()
        small_train = {arch: train_small(dev, arch) for arch in TRAIN_SMALL}
        for arch, res in small_train.items():
            log(f"small {arch} train step (f32) on the card agrees with "
                f"the CPU: {res}")
        ckpt = train_checkpoint(dev)
        log(f"smoke {ARCH} checkpoint round trip on the card: {ckpt}")
        trained = train_full(dev)
        free_card()
        driver = train_driver(dev)
        log(f"{TRAIN_PATH} through launch/train.py: {driver}")
    free_card()

    with phase(XLSTM_TRAIN_PATH):
        xl_train = train_xlstm(dev)
    free_card()

    with phase(DP_TRAIN_PATH):
        dpt_one = dp_train_one_rank(dev)
        free_card()
        dp_train = train_dp(dev, dpt_one)
    free_card()

    with phase(TP_TRAIN_PATH):
        tp_train = train_tp(dev, dpt_one)
    free_card()

    with phase(TPF_TRAIN_PATH):
        tpf_train = train_tp_families(dev)
    free_card()

    with phase(HOST_SERVE_PATH):
        host_sv = host_serve(dev)
    free_card()

    with phase(HOST_TRAIN_PATH):
        host_tr = {"gate": host_train_gate(dev)}
        host_tr.update(host_train(dev))
    free_card()

    with phase(OPEN_PATH):
        open_loop = serve_open_loop(dev, card)
    free_card()

    runs = {ARCH: run, HYBRID: hyb, int8_name: run8, GEMMA: gem,
            gem8_name: gem8, GRANITE: gran, MUSICGEN: mus, VLM: vlm,
            XLSTM: xl, **groups, **tp, DP_PATH: dp, TRAIN_PATH: trained,
            XLSTM_TRAIN_PATH: xl_train, DP_TRAIN_PATH: dp_train,
            TP_TRAIN_PATH: tp_train, **tpf_train,
            HOST_SERVE_PATH: host_sv, HOST_TRAIN_PATH: host_tr,
            OPEN_PATH: open_loop}
    prefill_src = "src/repro_torch/csrc/flash_prefill.cu"
    matmul_src = "src/repro_torch/csrc/paged_matmul.cu"
    decode_src = "src/repro_torch/csrc/paged_decode.cu"
    decode_tpu = "src/repro/kernels/decode_attention/kernel.py:79"
    prefill_tpu = "src/repro/kernels/flash_attention/kernel.py:77"
    matmul_tpu = "src/repro/kernels/hdm_stream/kernel.py:42"
    kernels = []
    # (row, launch counter, result, source, TPU kernel, the paths whose
    # launches are this row's: None for all of them)
    for name, counter, res, src, replaces, paths in (
            ("paged_decode", "paged_decode", dec, decode_src, decode_tpu,
             (ARCH, HYBRID, GEMMA, HOST_SERVE_PATH, OPEN_PATH)),
            ("paged_decode_d64_granite", "paged_decode", dec64[GRANITE],
             decode_src, decode_tpu, (GRANITE,)),
            ("paged_decode_d64_musicgen", "paged_decode", dec64[MUSICGEN],
             decode_src, decode_tpu, (MUSICGEN,)),
            ("paged_decode_g4_vlm", "paged_decode", dec_g4, decode_src,
             decode_tpu, (VLM,)),
            ("paged_decode_int8", "paged_decode_int8", dec8, decode_src,
             decode_tpu, (int8_name,)),
            ("paged_decode_int8_d256", "paged_decode_int8", dec8_256,
             decode_src, decode_tpu, (gem8_name,)),
            ("paged_decode_g16_glm4", "paged_decode", dec_g[GLM4],
             decode_src, decode_tpu, (GLM4,)),
            ("paged_decode_g12_starcoder2", "paged_decode",
             dec_g[STARCODER2], decode_src, decode_tpu, (STARCODER2,)),
            ("paged_decode_int8_g16", "paged_decode_int8", dec8_g[GLM4],
             decode_src, decode_tpu, ()),
            ("paged_decode_int8_g12", "paged_decode_int8",
             dec8_g[STARCODER2], decode_src, decode_tpu, ()),
            ("paged_decode_ml_tp2", "paged_decode", dec_ml["bf16"],
             decode_src, decode_tpu, (TP_PATH,)),
            ("paged_decode_int8_ml_tp2", "paged_decode_int8",
             dec_ml["int8"], decode_src, decode_tpu, (TP8_PATH,)),
            ("paged_decode_ml_tp2_granite", "paged_decode",
             dec_ml["bf16 d64"], decode_src, decode_tpu, (TPG_PATH,)),
            ("paged_decode_ml_tp2_zamba2", "paged_decode",
             dec_ml["bf16 d80"], decode_src, decode_tpu,
             (TPF_PATHS[HYBRID],)),
            ("paged_decode_ml_tp2_musicgen", "paged_decode",
             dec_ml["bf16 d64 s1024"], decode_src, decode_tpu,
             (TPF_PATHS[MUSICGEN],)),
            ("paged_decode_ml_tp2_vlm", "paged_decode", dec_ml["bf16 g4"],
             decode_src, decode_tpu, (TPF_PATHS[VLM],)),
            ("paged_decode_ml_dp2xtp2", "paged_decode", dec_dp, decode_src,
             decode_tpu, (DP_PATH,)),
            ("flash_prefill", "flash_prefill", pre, prefill_src, prefill_tpu,
             (ARCH, HYBRID, TP_PATH, TPF_PATHS[HYBRID], DP_PATH,
              HOST_SERVE_PATH, OPEN_PATH)),
            ("flash_prefill_g16_glm4", "flash_prefill", pre_g[GLM4],
             prefill_src, prefill_tpu, (GLM4,)),
            ("flash_prefill_g12_starcoder2", "flash_prefill",
             pre_g[STARCODER2], prefill_src, prefill_tpu, (STARCODER2,)),
            ("flash_prefill_d64_granite", "flash_prefill", pre64[GRANITE],
             prefill_src, prefill_tpu, (GRANITE, TPG_PATH)),
            ("flash_prefill_d64_musicgen", "flash_prefill",
             pre64[MUSICGEN], prefill_src, prefill_tpu,
             (MUSICGEN, TPF_PATHS[MUSICGEN])),
            ("flash_prefill_g4_vlm", "flash_prefill", pre_g4, prefill_src,
             prefill_tpu, (VLM, TPF_PATHS[VLM])),
            ("flash_prefill_train", "flash_prefill", pre_train, prefill_src,
             prefill_tpu, (TRAIN_PATH,)),
            ("flash_prefill_tf32", "flash_prefill_tf32", pre32, prefill_src,
             prefill_tpu, None),
            ("flash_prefill_d256", "flash_prefill_d256", pre256, prefill_src,
             prefill_tpu, None),
            ("flash_prefill_tf32_256", "flash_prefill_tf32_256", pre32_256,
             prefill_src, prefill_tpu, None),
            ("flash_prefill_scalar", "flash_prefill_scalar", pre_sc,
             prefill_src, prefill_tpu, None),
            ("ssd_scan", "ssd_scan", ssd, "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/mamba2_scan/kernel.py:68", (HYBRID,)),
            ("ssd_scan_tp2", "ssd_scan", ssd40,
             "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/mamba2_scan/kernel.py:68",
             (TPF_PATHS[HYBRID],)),
            ("paged_matmul", "paged_matmul", mm, matmul_src, matmul_tpu,
             None),
            ("paged_matmul_skinny_f32", "paged_matmul_skinny_f32",
             mm32["skinny_f32"], matmul_src, matmul_tpu, None),
            ("paged_matmul_tile_f32", "paged_matmul_tile_f32",
             mm32["tile_f32"], matmul_src, matmul_tpu, None),
            ("paged_matmul_scalar", "paged_matmul_scalar", mm32["scalar"],
             matmul_src, matmul_tpu, None)):
        by_path = {arch: ({**r["launches"], **r["off_path_launches"]}[counter]
                          if paths is None or arch in paths else 0)
                   for arch, r in runs.items()}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": res["max_abs_err"], "ms": res["ms"],
               "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": res["library_ms"],
               "shape": res["shape"]}
        for key in ("parent_ms", "plans_ms", "padded_rows_share",
                    "group_chunks"):
            if key in res:
                row[key] = res[key]
        if name.endswith(("_granite", "_musicgen")):
            row["note"] = ("the bf16 instance at D 64 on the path of "
                           + name.split("_")[-1] + " (the same kernel and "
                           "count as the row without the suffix, whose "
                           "launches on this path are this row's)")
        if name.endswith("_g4_vlm"):
            row["note"] = ("the bf16 instance at D 128 on the VLM's path "
                           "(8 kv heads of 4 query heads; the decode runs "
                           "its 8-row instance, half of whose rows are "
                           "padding): the same kernel and count as the row "
                           "without the suffix, whose launches on this "
                           "path are this row's")
        if name.endswith(("_glm4", "_starcoder2")):
            row["note"] = ("the bf16 instance at D 128 on the path of "
                           + name.split("_")[-1] + " (its query-head group "
                           "of 16 or 12; the decode splits it over two "
                           "CTAs per kv head): the same kernel and count as "
                           "the row without the suffix, whose launches on "
                           "this path are this row's")
        if name in ("paged_decode_int8_g16", "paged_decode_int8_g12"):
            row["note"] = ("the int8 mode at glm4-9b's / starcoder2-15b's "
                           "heads (split over two CTAs per kv head): held "
                           "and timed here; no path serves these configs "
                           "with int8 pages")
        if "_ml_tp2" in name:
            view = {"_granite": "granite-moe-1b-a400m's heads, D 64, bf16",
                    "_zamba2": "zamba2-2.7b's shared block, Hkv 32, G 1, "
                               "D 80, bf16",
                    "_musicgen": "musicgen-large's heads, Hkv 32, G 1, D "
                                 "64, bf16, 512 of a slot's 1024 tokens",
                    "_vlm": "llama-3.2-vision-11b's heads, Hkv 8, G 4, D "
                            "128, bf16"}
            row["note"] = ("the same kernel with its f32 output and m / l "
                           "(the return_ml partials) at a rank's view on "
                           "the tp 2 path ("
                           + next((v for k, v in view.items()
                                   if name.endswith(k)),
                                  "qwen3-1.7b heads, bf16")
                           + ("" if name.endswith("_musicgen") else
                              ", 1024 of a slot's 2048 tokens")
                           + "): its count is the row's "
                           "counter, read in each rank's process, rank 0's "
                           "here; library: output only")
        if name == "paged_decode_ml_dp2xtp2":
            row["note"] = ("the same kernel with its f32 output and m / l "
                           "at a rank's view on the dp path, mesh (2, 2): "
                           "its data row's 4 of 8 slots, its model rank's "
                           "1024 of a slot's 2048 tokens (qwen3-1.7b's "
                           "heads, bf16); its count is the row's counter, "
                           "read in rank 0's process; library: output "
                           "only")
        if name == "ssd_scan_tp2":
            row["note"] = ("the same kernel at a rank's 40 of zamba2-2.7b's "
                           "80 heads on the tp 2 path (its count read in "
                           "rank 0's process)")
        if name == "flash_prefill_train":
            row["note"] = ("the bf16 instance at D 128 on the use_pallas "
                           "training loss of full-width qwen3-1.7b (a 4096-"
                           "token sequence as one chunk at position 0; "
                           "forward only, no backward): the same kernel and "
                           "count as the row without the suffix, whose "
                           "launches on this path are this row's")
        if name == "paged_decode_int8_d256":
            row["note"] = ("the int8 mode at gemma-2b's shape (one kv head "
                           "of 8 query heads, D 256): the same kernel and "
                           "count as paged_decode_int8, whose launches on "
                           "the gemma-2b int8 path are this row's; not "
                           "redesigned in this slice")
        if name == "flash_prefill_scalar":
            row["note"] = ("bf16 and f32 at head dims 16 and 32 (the smoke "
                           "models); no full-width path runs it")
        if name.startswith("paged_matmul"):
            row["note"] = ("no path of the reference calls it (its engine "
                           "drops the speculative-read weight prefetch on "
                           "one device); ported as its op, stream_matmul; "
                           + {"paged_matmul": "bf16 on tensor cores, times "
                                              "with L2 cold",
                              "paged_matmul_skinny_f32":
                                  "f32 on FFMA at M <= 16, L2 cold",
                              "paged_matmul_tile_f32":
                                  "f32 in 3xTF32 at M > 16, L2 cold",
                              "paged_matmul_scalar":
                                  "f32 over pages of 32 rows, which only "
                                  "the scalar instance takes, L2 warm"}[name])
        kernels.append(row)
    wall_s = time.time() - t_start
    log(f"phases (s): {PHASE_S}")
    log(f"every phase passed in {wall_s:.1f}s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "wall_s": wall_s, "build_s": build_s, "decode": dec,
                   "decode_d80": dec80,
                   "decode_d256": dec256, "prefill_d256": pre256,
                   "decode_int8": dec8, "decode_int8_d256": dec8_256,
                   "decode_edges": dec_edges,
                   "prefill": pre, "prefill_d80": pre80,
                   "prefill_edges": pre_edges, "prefill_f32": pre32,
                   "prefill_f32_d256": pre32_256,
                   "prefill_scalar": pre_sc,
                   "ptxas": ptxas, "plans": plans, "ssd_scan": ssd,
                   "ssd_scan_40_heads": ssd40,
                   "refused_plans": refused,
                   "paged_matmul": mm, "paged_matmul_f32": mm32,
                   "small_model": small, "serve": run,
                   "serve_hybrid": hyb, "serve_int8": run8,
                   "serve_gemma": gem, "serve_gemma_int8": gem8,
                   "decode_d64": dec64, "prefill_d64": pre64,
                   "serve_granite": gran, "serve_musicgen": mus,
                   "decode_g4": dec_g4, "prefill_g4": pre_g4,
                   "serve_vlm": vlm, "serve_xlstm": xl,
                   "decode_groups": dec_g, "decode_int8_groups": dec8_g,
                   "prefill_groups": pre_g, "decode_ml": dec_ml,
                   "serve_groups": groups, "serve_tp": tp,
                   "decode_dp_view": dec_dp, "serve_dp": dp,
                   "prefill_train": pre_train, "train_small": small_train,
                   "train_checkpoint": ckpt, "train": trained,
                   "train_driver": driver, "train_xlstm": xl_train,
                   "train_dp": dp_train, "train_tp": tp_train,
                   "train_tp_families": tpf_train,
                   "serve_host": host_sv,
                   "train_host": host_tr, "serve_open_loop": open_loop,
                   "cut_layers": CUT_LAYERS, "phase_s": PHASE_S,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
