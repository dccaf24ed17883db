#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

(``chip_smoke.py --mesh-rank RANK DIR [cpu]`` is one of phase 22's four
ranks, ``--lm-mesh-rank RANK DIR [cpu]`` one of phase 23's; the script
starts them itself.)

Phases, each of which exits non-zero on failure:

  1. the card (nvidia-smi name and power limit) and the build of every
     kernel from its CUDA source with nvcc (sm_90a), with ptxas's register
     and spill report of each kernel (kept for the `kernels` line);
  2. every kernel against its plain PyTorch version on the card, bit for
     bit (V, rasters and every gate or event counter), over the cases its
     callers give it: the dense kernel over neuron x clamp x v_init x
     rasters at IMDB widths, at the edges of its 16-step chunks (T in
     {1, 15, 16, 17, 33, 120} x every neuron and clamp), at B in
     {1, 37, 300, 4096} x block_b in {1, 8, 32, 64}, on the MNIST FC stack
     (686-120-84-10), the 130-24-3 stack and the conv stack (126, 14) at
     B = 12,544, and stacks on each lower rung of its plan (compact weight
     rows, no readout counts, 4, 2 and 1 lanes); the gated kernel at
     G in {1, 2, 4, 8}, the event-list
     kernel at crossover in {0, 0.15, 0.5, 1}, each over neuron x clamp x
     v_init at IMDB widths, the all-silent and all-ones rasters, ragged
     batches, block_b = 64 and a 130-wide first layer;
  3. the main paths: 64 IMDB requests (6 words x 10 frames, sparsity 0.85,
     random weights from a seed) served at full width by
     `SNNServeEngine` on the `cuda`, `cuda_sparse` (G = 8) and
     `cuda_events` (crossover 1.0) backends, each page megastep one CUDA
     graph replay (the engine's compiled dispatch), each drain's launch
     counts taken over that drain alone (a replay adds its capture's); every request equal to an `int_ref`
     engine on the card (and the first few to `int_ref` on the CPU); the
     `cuda_events` device ledger equal to a `ref_events` engine's and to
     the per-request raster tally; then one profiled drain per backend for
     the device's busy time, its idle share and the time of each kernel;
  4. each kernel's device time at the serving shape (K = 10, B = 32) and at
     B = 4096, beside its plain version's device time, the host time of
     one wrapper call, its bound and (dense) its plan, and the gated and
     event-list times over the dense one; then the dense and gated kernels on
     one structured raster (silent 16-row chunks and silent frames) at
     K = 10, B = 32, with the share of gate sites the gated kernel skipped;
  5. the wkv6 kernel against its plain version (`wkv6_sequential`) on the
     card within 2e-4 relative and absolute: H = 64, K = V = 64 at
     B in {1, 4} and T in {1, 16, 31, 32, 33, 65, 100, 1024, 2048} (the
     kernel's 32-step chunk edges among them), and the JAX tests' small
     shapes (K != V included), each with w drawn from [0.6, 0.999) and with
     w = exp(-e) on every step (the strongest decay the model allows, where
     the output must be finite), from a random initial state; and s0
     continuation (two halves against the whole);
  6. RWKV6-7B at full width (32 layers x 4096, 64 heads of 64, d_ff 14336,
     vocab 65536), bf16 weights drawn on the card from seed 0, served by the
     port's `ServeEngine`: 4 slots, 8 requests (6 prompts of 4 to 16 tokens,
     2 of 1,024), 16 new tokens each, decoded eagerly: every logit finite
     and 32 wkv6 launches per prefill; tokens/s and a profiled drain; the
     compiled engine (tick 1 eager, then one CUDA graph replay a tick)
     serves the same tokens, and both engines' tokens/s (median of 3
     drains in turns, graph captured) and profiled idle share; the kernel held
     against its plain version on the served model's own activations in
     every layer of a 1,024-token prefill; kernel and plain prefill of that
     prompt compared through the whole model (bf16 at full depth reported,
     bf16 cut to 2 layers and float32 at full depth gated); prefill of the
     prompt plus one token against prefill and one decode step (float32);
     the kernel's time at the prefill shapes (B = 1, T = 16 and 1,024);
  7. the per-layer kernel (`fused_snn_step`) against its plain version
     (`fused_snn_layer_ref`) on the card, bit for bit (spikes and V), over
     every neuron x clamp mode with reset 0 and nonzero, a negative LIF
     leak, B in {1, 8, 37, 300}, N_in in {100, 128, 686}, N_out in
     {1, 14, 128}, T in {1, 10, 120}, block_b in {8, 64} and densities 0.1
     and 0.5; then its time at the Fig. 9 case (T = 10, B = 8, 128 x 128)
     and at both IMDB layers (T = 120, B = 8), beside its bound and the
     plain version's time;
  8. the per-layer path: the IMDB stack at the shapes of
     `benchmarks/pipeline_fusion.py` (T = 120, B = 8, threshold 60, leak 2,
     RMP, density 0.1) dispatched layer by layer (two `fused_snn_layer`
     launches, then the int32 readout) against one fused `fused_snn_net`
     launch: the same readout V and rasters; both times and the per-layer
     over fused ratio (with rasters, and without them as serving runs),
     the traffic model, and the Fig. 9 row's instruction counts and energy;
  9. the impulse-mnist conv program at full width (28x28x1 input, convs
     14/14/14, FC 686-120-84-10, T = 10), weights drawn on the card from a
     seed, 64 `mnist_like_batch` images through `present_static` on all five
     backends: every backend equal to `int_ref` on the card (readout V,
     every raster and final V), the gate counters equal to the ones the
     `int_ref` rasters give at the same tiles, the event ledgers equal to
     `ref_events`' and to the raster tally, the encoder's spike maps on the
     card equal to the CPU's (same port code), equal instruction counts on
     every backend with the energy per inference, and each backend's
     `run_network` time; then a profiled `cuda` run for the device time of
     each of its three dense launches (two convs and the FC stack);
 10. impulse-mnist streamed and served at full width, weights drawn on the
     card from a seed, 64 `mnist_like_batch` images of 10 frames: (a) 8
     images streamed 10 ticks one at a time and in megasteps of 3 + 3 + 4
     on all five backends, equal to `run_network` (V, every raster, conv
     maps included); (b) `SNNServeEngine` (validate=True, 32 slots x 2
     pages, K = 5, arrivals 3 frames apart) on `int_ref`, `cuda`,
     `cuda_sparse` (G = 8) and `cuda_events` (crossover 1.0): every
     request equal to the `int_ref` engine's, each `int_ref` request to an
     isolated `run_network` and `sparsity_report` of its image, three
     launches per page megastep (two convs and the fc stack), the
     `cuda_events` ledger equal to a `ref_events` engine's and the pooled
     tally; (c) a `cuda` engine at K = 4 (finishes inside blocks) equal to
     `int_ref` at K = 4; (d) each engine's `max_safe_ticks` and frames/s
     and a profiled `cuda` drain; (e) 40 seeded stacks per CUDA mode whose
     widths straddle the shared-memory limit: `check_kernel_contracts`
     accepts exactly the stacks that launch, and the wrapper raises
     `KernelRefused` naming the same rule for the others;
 11. the bit-level macro oracle (`bitmacro`, numpy on the host) against the
     `cuda` backend on the card, on wrap programs with weights drawn on the
     card: one impulse-mnist image and one 6-word IMDB request, equal V,
     rasters and readout, the macro counts equal to the raster count less
     the readout's, with the host seconds it took;
 12. training, then deployment: (a) the IMDB net's `sentiment_loss` and
     gradients at full width (B = 128, 12 words) on the card against the
     same port code on the CPU (loss within 1e-4 relative, each gradient
     within 1e-3 relative L2, differing raster sites counted), TF32 off,
     and the float backend on the int program == `int_ref` == `cuda`; (b)
     the train step eager and compiled (`compile_train_step`: forward,
     backward and AdamW as one CUDA graph) from one state over one batch
     stream, 10 steps each after a second eager run of 5: after 5 steps
     the compiled run equal to the eager one bit for bit (parameters,
     moments, steps, losses, gradient norms; where two eager runs differ,
     within twice their difference), each run's ms a step, profiled step
     (idle share, device ops: one replay's) and peak bytes; then 400
     compiled steps at `benchmarks/fig9_accuracy.py`'s settings through
     `train_loop` (the loss must fall; cut, and said so, if it would not
     end inside the time limit), the median step time and a profiled
     step, then the LSTM baseline, compiled, and the Fig. 9b row; (c)
     the trained program on every backend and on `float` equal to
     `int_ref` on 1,024 eval reviews, its sparsity, instruction counts and
     energy, and 64 reviews served on `cuda` equal to an `int_ref` engine;
     (d) a checkpointed `train_loop` over the compiled step stopped at 10
     steps and resumed (the restored state copied into the step's
     buffers); (e) 12 compiled impulse-mnist `lenet_loss` steps, finite,
     and the trained conv program on `cuda` == `int_ref`;
 13. the compiled dispatch and the double buffer: phase 3's IMDB drain and
     phase 10's conv drain on `int_ref`, `cuda`, `cuda_sparse` and
     `cuda_events`, each eager (`stream_megastep`), graphed (one CUDA
     graph per page) and graphed with the double-buffered upload: every
     request (logits, V, ticks, finish clock, report), the device ledger
     and the launch counts equal the eager drain's; then the `cuda`
     engine's frames/s in the three modes (median of 5 drains in turns),
     and a profiled drain each for device busy ms, idle share and device
     ops a megastep;
 14. the dense attention family and the spiking FFN: (a) llama3-8b at full
     width (32 layers x 4096, 32 query and 8 KV heads of 128, SwiGLU d_ff
     14336, vocab 128256, RoPE theta 500000), bf16 weights drawn on the
     card from seed 0, served by `ServeEngine` (4 slots, max_len 1,152; 6
     prompts of 4 to 16 tokens and 2 of 1,000, which fall in bucket 1,024;
     16 new tokens each): every prefill and decode logit of an eager drain
     finite, the buckets used and the LRU's contents, the compiled engine
     (one CUDA graph per prefill bucket, a decode graph from tick 2) equal
     to the eager engine token for token, both engines' tokens/s (median
     of 3 drains in turns) and profiled drains, the time to the first
     token per bucket, the KV cache's bytes and the float32 logits head's
     time and memory; (b) on the served model: blocked attention (q chunk
     and kv block 256) against `_sdpa` on layer 0's q, k and v at T =
     1,024 in float32 (the JAX test's tolerance), and, in float32 at full
     depth (cut to 8 layers if the card could not hold it, and said so)
     and reported in bf16, the bucketed prefill (1,000 tokens padded to
     1,024) against the exact-length one (last logits, K/V at the valid
     positions) and prefill of the prompt plus one token against prefill
     and one `decode_step`; (c) llama3.2-1b at full width with the spiking
     FFN (RMP, 8 steps, threshold 0.5), bf16, served the same way
     (compiled == eager, tokens/s), the mean spike rate of a prefill, and
     layer 0's float executor on the card equal to the same port code on
     the CPU, spike sum for spike sum, on the current it recorded;
 15. training the language models (`lm.loss_fn`, `init_train_state`, the
     default `make_train_step`; AdamW with b2 0.95, weight decay 0.1 and a
     cosine warm-up; remat per block): (a) llama3.2-1b at full width (16 x
     2048, 32/8 heads of 64, SwiGLU 8192, vocab 128256, tied embeddings),
     bf16 weights drawn on the card from seed 0 (the one start state of
     every run), 20 steps at B = 8, seq 256, eager and compiled (as
     phase 12(b): a second eager run of 5 steps, the compiled run equal
     to the eager one after 5 steps bit for bit or within twice the eager
     runs' own difference, remat recomputed inside the capture), each
     with its median ms a step, profiled step (idle share, device ops)
     and peak memory: every loss and gradient norm finite, the mean of
     the last 5 eager losses below the first 5's, the state's bytes;
     then in float32 at full width
     cut to 2 layers (B = 2, seq 64): loss and gradients on the card
     against the same port code on the CPU, vocab_chunking 4 against 0,
     remat against none and microbatches 2 against 1, at the CPU tests'
     tolerances; (b) the same model with the spiking FFN, 10 steps at B =
     4, seq 128, eager and compiled as in (a): the loss finite, aux > 0,
     every FFN layer's gradient
     finite and non-zero, ms a step, peak memory and
     `examples/spiking_ffn_lm.py`'s sparsity and macro-energy line (a
     model of the silicon); (c) rwkv6-7b at full width cut to 4 of its 32
     layers, 10 steps at B = 4, seq 256 through the differentiable chunked
     wkv6 in chunks of 16, eager and compiled as in (a): no wkv6 launch in
     the steps, non-zero gradients
     upstream of the recurrence (wr, wk, wv, the decay LoRA, bonus) in
     every layer, the loss at JAX's chunk of 64 reported beside it, and a
     prefill on the trained weights through the kernel, one launch a
     layer, each within 2e-4 of `wkv6_sequential`; (d) `python -m
     repro_torch.launch.train --arch llama3.2-1b --steps 10` (a compiled
     step) as a subprocess: exit 0 and its lines;
 16. the MoE super-block, which launches no port kernel: (a)
     llama4-maverick-400b-a17b with every published width (5120, 40 query
     and 8 KV heads of 128, dense d_ff 16,384, 128 routed experts of d_ff
     8,192 at top-1 plus one shared expert, vocab 202,048) cut to 2 of its
     48 layers, one dense/MoE super-block (37.4 GB of bf16 weights drawn
     on the card from seed 0, each expert into its slot), served as phase
     14 serves: every logit finite, the compiled engine == the eager one
     token for token, tokens/s (median of 3 in turns), the time to the
     first token per bucket (8, 16, 1,024), a profiled drain's idle share
     and top ops, the peak memory, the drop count of each bucketed
     prefill's MoE layer and one decode graph replay against the bytes a
     tick must read; (b) `moe_ffn` at full width on layer 1's input in a
     1,024-token prefill (cap 10, so tokens drop): within 2e-2 relative
     L2 of a float32 per-token reference that rebuilds the keep mask
     itself, dropped tokens == the shared expert bit for bit, and the
     router's top-1 on the card == the CPU's but at near ties (top-2
     logit gap under 1e-4, printed);
 17. deepseek-v2-lite-16b, which launches no port kernel either: (a) every
     published width and all 27 layers (2048, 16 MLA heads with a
     512 + 64 latent, nope/rope/v heads of 128/64/128, a dense first layer
     of d_ff 10,944, 26 MoE layers of 64 routed experts of d_ff 1,408 at
     top-6 plus two shared, vocab 102,400; 31.4 GB of bf16 weights drawn
     on the card from seed 0), served as phase 16 serves but each prompt
     prefilled at its exact length (MLA is not bucketed, as in the JAX
     engine): every logit finite, two eager drains equal and the compiled
     engine == the eager one token for token, tokens/s, the time to the
     first token per prompt length, idle shares, the peak memory, the
     latent cache's bytes against the per-head K/V it stands for, each
     prefill's drops in every MoE layer, and one decode graph replay
     against its bound; (b) top-6 `moe_ffn` at full width on layer 1's
     input in a 1,024-token prefill within 2e-2 relative L2 of the float32
     per-token reference (router top-6 card vs CPU split only at near
     ties), `mla_attention` at full width on layer 0 (prefill of 1,024
     tokens and a decode step over the cache it leaves) within 2e-2 of a
     float32 reference in the absorbed form, and its decode against a
     prefill of one more token; the model's decode against a prefill of
     one more token in bf16 (reported);
 18. jamba-v0.1-52b's hybrid super-block, which launches no port kernel
     either: (a) every published width (4096; 32 query and 8 KV heads of
     128; Mamba d_inner 8,192, state 16, conv 4, dt rank 256; dense d_ff
     14,336; 16 experts of 14,336 at top-2; vocab 65,536) cut to 8 of its
     32 layers, one period-8 super-block (7 Mamba layers, attention at
     place 4, MoE at the odd places; 26.6 GB of bf16 weights drawn on the
     card from seed 0, each expert into its slot), served as phase 17
     serves, each prompt prefilled at its exact length (a Mamba state
     would integrate padding): every logit finite, two eager drains equal
     and the compiled engine == the eager one token for token, tokens/s,
     the time to the first token per prompt length, idle shares, the peak
     memory, the recurrent state's bytes against the K/V those layers
     would hold, each prefill's drops in every MoE layer, and one decode
     graph replay against its bound; (b) `mamba_forward` at full width on
     layer 0's input in a 1,024-token prefill (8 chunks of 128): the
     output and final conv and SSM states within 2e-2 relative L2 of a
     float64 step-by-step recurrence, a prefill then `mamba_decode` of one
     token against a prefill of one more token, and the layer's device ms;
 19. whisper-large-v3, the encoder-decoder family, which launches no port
     kernel: (a) every published width and all 32 encoder and 32 decoder
     layers (1280, 20 heads of 64, gelu d_ff 5,120, vocab 51,866, tied;
     3.07 GB of bf16 weights drawn on the card from seed 0), a
     `prefill_batch_spec` batch from `io_spec.materialize(seed=0)` (B =
     4, 1,500 frames, whisper's 30 s window, and a 187-token prompt),
     max_len 448 (whisper's `max_target_positions`), 64 greedy tokens
     eager twice and with each tick one CUDA graph replay: every logit
     finite, the three runs equal token for token, ``cache["enc_out"]``
     == the encoder's output, the time to the first token split into the
     encoder and the decoder prefill, tokens/s eager and graphed (median
     of 3 in turns), a profiled graphed run, the peak memory, the cache's
     bytes against cached cross K/V, and one replay against its bound
     (JAX's per-tick cross K/V projections counted); (b) in float32 at
     full width and depth, a prefill then a decode step against a
     prefill of one more token, and layer 0's `attention(kv_x=)` against
     a float64 reference;
 20. llava-next-mistral-7b, the vision stub, which launches no port kernel
     either: (a) every published width and all 32 layers (4096, 32/8
     heads of 128, SwiGLU 14,336, vocab 32,000; 14.5 GB of bf16 weights),
     a `prefill_batch_spec` batch (B = 2, 4,096 positions: 1,024 patch
     embeddings and 3,072 tokens), max_len 4,160, 32 greedy tokens as in
     phase 19 (``cache["len"]`` == 4,096 after the prefill); (b) the
     text-only `ServeEngine` (4 requests of 4 to 16 tokens x 16, 4 slots),
     compiled == eager token for token, tokens/s; (c) in float32 at full
     width cut to 2 layers (64 patches + 192 tokens), the prefill on the
     card against the same port code on the CPU, and a prefill then a
     decode step against a prefill of one more token;
 21. the trace pass (`analysis.check_trace`, `trace_cost`): impulse-imdb
     and impulse-mnist compiled on the card with validate=True (range,
     contract and trace passes; the seconds beside a validate=False
     compile, the trace memo emptied first), then `check_trace` of every
     int backend (`TRACE_BACKENDS`) on every surface for the card: every
     check row, the float64-exactness row with its proven bound, one
     kernel node a surface on the `cuda*` backends and none on `int_ref`,
     `kernels.LAUNCH_COUNTS` unmoved by the pass, and the mesh surface on
     a 2 x 2 mesh (each model rank's row-partial tick, one reduction a
     layer, no kernel node); `check_cost_closure` of
     both programs against the JAX package's counts; and the cost model's
     bytes and dense MACs of phase 4's calls against the numbers phase 4
     printed and against a count by formula (`hand_net_bytes`);
 22. the SNN mesh path on `torch.distributed` (`run_network(mesh=)`,
     `SNNServeEngine(mesh=)`): (a) a world of one on NCCL and its (1, 1)
     mesh, IMDB (B = 32, 60 frames) and impulse-mnist (8 images) through
     int_ref, cuda, cuda_sparse (G = 8) and cuda_events, each equal to the
     meshless call bit for bit (rasters, every V, logits, counters) with
     its launches, and the compiled cuda engine on the mesh (page graphs
     captured) equal to the meshless one; (b) four gloo ranks spawned on
     the one card (`--mesh-rank`), all-reduces and all-gathers on CUDA
     tensors: IMDB on (4, 1), (1, 4) and (2, 2) on every int backend, the
     conv program on (4, 1) and (2, 2) with cuda, and a (2, 2) cuda_events
     serving drain (16 requests, 2 pages of 8), each rank holding every
     global result and the drain's requests and ledger to the single-GPU
     run; each rank's kernel launches on (4, 1) (one a call) and the zero
     launches of (1, 4) (the row-partial ticks run no kernel);
 23. LM sharding on `torch.distributed` (DTensor), llama3.2-1b at every
     published width (d_model 2,048, vocab 128,256, tied) on 2 of its 16
     layers, float32 weights drawn on the card, B = 8, T = 256, AdamW,
     fsdp, sequence parallel, vocab chunking 2, remat per block: (a) a
     world of one on NCCL, the sharded step on its (1, 1) mesh against the
     plain step (bit for bit or not, printed); then four gloo ranks on the
     one card (``--lm-mesh-rank``; `dist.collectives` carries DTensor's
     collectives): (c) `compressed_psum_mean` over (4, 1) on each rank's
     gradient tree (its quarter of the batch), 6 steps of error feedback
     against the float32 mean, with the dtype and bytes that crossed the
     wire; (b) two sharded steps on (2, 2) against the single-device
     steps rank 0 runs: losses and gradient norms within 1e-5 relative,
     the clipped step-1 gradient (AdamW's first moment) within 1e-4
     relative L2 a leaf, every parameter within Adam's bound of 2 lr a
     step, the placements kept, and the CPU tests' 1e-5 rule reported
     (seconds a step, each rank's peak memory, the float32 score bytes a
     rank computes a call, here and in (a)); (d) one rwkv6-7b prefill at
     every width on 2 of 32 layers (float32, B = 2, T = 256) on (1, 4),
     each rank launching wkv6 on its 16 of the 64 heads, against the
     prefill rank 0 runs in one process within 2e-4; (e) GPipe on
     ("pipe",) x 4, tanh(x @ w) with w (2,048, 2,048), 8 microbatches of
     4, bit for bit the sequential composition rank 0 computes;
 24. the multi-GPU dry-run (`launch.dryrun`): (a) ``python -m
     repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
     --mesh single`` as a subprocess (a fake process group of 256 ranks
     over fake CUDA tensors): one GPU's flops, bytes, collective bytes,
     peak against the card's memory and the dominant roofline term, its
     argument and output bytes equal to the JAX package's committed
     artifact; (b) the same counter on a world of one over phase 15(a)'s
     eager train step: the largest roofline term at most the measured
     median step, the counted peak within 10 % of the card's; (c)
     `llama3.2-1b` `train_4k` on (16, 16) at 2 layers traced on fake CUDA
     tensors and on the CPU path a torch without CUDA takes for a train
     cell: equal flops, bytes, collectives, operators and memory.

Each phase prints its seconds (`[time]` lines). Then one `kernels` JSON
line with all five kernels, each redesigned for this card (the dense,
gated and event-list modes, wkv6 and fused_snn_step) with
`redesigned_in` and its registers and spills; each fused-network mode
names its paths and its launches in the conv serving drain
(`conv_serving_launches`), in the deployment of the trained IMDB net
(`train_deploy_launches`), in phase 13's graphed drains
(`graphed_launches`) and on phase 22's meshes (`mesh_launches`). The last
line is {"ok": true, "device": {...}}.
Without a CUDA device, or without the repository's src/repro_torch
beside this file, it prints no result and exits 1.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12          # H100 SXM, dense bf16 tensor cores
PEAK_INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core rate
IMDB_WIDTHS = (100, 128, 128, 1)
WIDE_WIDTHS = (130, 24, 3)        # a fan-in spanning two macro row tiles
SEED = 0
GATE_G = 8                        # the cuda_sparse drain's granularity
CROSSOVER = 1.0                   # the cuda_events drain's crossover
KERNEL_SOURCE = "src/repro_torch/kernels/fused_snn_net/csrc/fused_snn_net.cu"
REPLACES = {"fused_snn_net": "src/repro/kernels/fused_snn_net/kernel.py:149",
            "fused_snn_net_gated":
                "src/repro/kernels/fused_snn_net/kernel.py:294",
            "fused_snn_net_events":
                "src/repro/kernels/fused_snn_net/kernel.py:222"}
STEP_SOURCE = ("src/repro_torch/kernels/fused_snn_step/csrc/"
               "fused_snn_step.cu")
STEP_REPLACES = "src/repro/kernels/fused_snn_step/kernel.py:30"
# benchmarks/pipeline_fusion.py: the IMDB stack, 12 words x 10 steps
FUSION_LAYERS = [(100, 128), (128, 128), (128, 1)]
FUSION_T, FUSION_B = 120, 8
FUSION_TH, FUSION_LEAK = 60, 2
MNIST_BATCH = 64
WKV_SOURCE = "src/repro_torch/kernels/wkv6/csrc/wkv6.cu"
WKV_REPLACES = "src/repro/kernels/wkv6/kernel.py:24"
WKV_TOL = 2e-4                    # relative and absolute, the JAX tests' own
PEAK_F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
STRONG_DECAY = math.exp(-math.e)  # w at the model's decay clip
WKV_SMALL = [(2, 64, 2, 64, 64), (1, 128, 3, 64, 64), (2, 100, 2, 32, 32),
             (1, 192, 1, 16, 64)]          # tests/test_kernels.py:82-87
WKV_LENGTHS = (1, 16, 31, 32, 33, 65, 100, 1024, 2048)
REDESIGNED = {"wkv6": "PR 17", "fused_snn_net_gated": "PR 17",
              "fused_snn_net_events": "PR 18", "fused_snn_step": "PR 18",
              "fused_snn_net": "PR 19"}
INT_BACKENDS = ("int_ref", "cuda", "cuda_sparse", "ref_events",
                "cuda_events")   # the integer streaming backends
MNIST_FC = (686, 120, 84, 10)
CONV_STACK = (126, 14)            # an on-macro conv's im2col patch layer
PORT_KERNELS = ("fused_snn_net", "fused_snn_step", "wkv6_kernel")
LONG_PROMPT = 1024
LM_NEW = 16                       # new tokens a request, phases 6 and 14
# Model-level tolerances, relative L2 error of the logits (and, for float32,
# the largest elementwise error over the largest |logit|). With random
# weights this stack amplifies a difference through its depth: a one-ulp
# bf16 rounding difference in one layer grows to order 1 in the logits over
# 32 bf16 layers, while float32 keeps a float32-order difference small. So
# bf16 is gated at 2 layers and reported at 32, float32 is gated at 32.
BF16_CUT_L2 = 2e-2
F32_L2 = 2e-2
F32_DECODE_L2 = 5e-2
BACKEND_OF = {"fused_snn_net": "cuda", "fused_snn_net_gated": "cuda_sparse",
              "fused_snn_net_events": "cuda_events"}
# Phase 12: benchmarks/fig9_accuracy.py's training settings
TRAIN_STEPS, TRAIN_BATCH, TRAIN_WORDS, TRAIN_LR = 400, 128, 12, 5e-3
EVAL_BATCH, EVAL_SEED = 1024, 99_991
SERVE_REVIEWS = 64
LENET_STEPS, LENET_BATCH = 12, 16
TRAIN_DEADLINE_S = 600            # seconds after the script starts
COMPARE_STEPS = 5                 # eager and compiled steps held bit for bit
SNN_COMPARE_STEPS = 10            # the SNN's eager and compiled runs
# card against CPU, same port code: cuBLAS and the CPU BLAS sum f32 terms in
# different orders, and a V within an ulp of its threshold can flip a spike
TRAIN_LOSS_RTOL, TRAIN_GRAD_RL2 = 1e-4, 1e-3
# Phase 13: the compiled dispatch and the double buffer
COMPILED_BACKENDS = ("int_ref", "cuda", "cuda_sparse", "cuda_events")
DISPATCH_MODES = ("eager", "graphed", "graphed_db")
COMPILED_REPEATS = 5              # timed drains per mode, alternating
STEP_KW = {"cuda_sparse": {"gate_granularity": GATE_G},
           "cuda_events": {"event_crossover": CROSSOVER}}
# Phase 14: the dense attention family and the spiking FFN
DENSE_ARCH, SPIKING_ARCH = "llama3-8b", "llama3.2-1b"
SPIKING = {"neuron": "rmp", "timesteps": 8, "threshold": 0.5}
DENSE_MAX_LEN, DENSE_LONG, DENSE_BUCKET = 1152, 1000, 1024
DENSE_F32_CUT = 8                 # float32 depth if 32 layers do not fit
BLOCKED_CHUNK = 256               # q chunk and kv block
BLOCKED_RTOL, BLOCKED_ATOL = 2e-5, 2e-5   # tests/test_blocked_attention.py
# Phase 15: train the language models the port serves
LM_TRAIN_LR = 1e-3
LM_TRAIN_STEPS, LM_TRAIN_B, LM_TRAIN_SEQ = 20, 8, 256
LM_CHECK_LAYERS, LM_CHECK_B, LM_CHECK_SEQ = 2, 2, 64
SPK_TRAIN_STEPS, SPK_TRAIN_B, SPK_TRAIN_SEQ = 10, 4, 128
RWKV_TRAIN_STEPS, RWKV_TRAIN_B, RWKV_TRAIN_SEQ = 10, 4, 256
RWKV_TRAIN_LAYERS = 4             # of 32: the moments of 7.6 B would not fit
RWKV_TRAIN_CHUNK = 16             # the chunked wkv6 cannot overflow at 16
# tests/test_torch_lm_train.py's tolerances: loss, gradients (relative L2),
# vocab chunking's loss, and test_substrate's microbatch ones (loss,
# parameters). cuBLAS picks a product's reduction order (split-K over the
# 128,256-long vocabulary) by its shape, so the chunked head's input
# gradient is summed in another order than the whole head's, as on the
# card against the CPU: vocab chunking's gradients are held within
# LM_GRAD_RL2. The embedding's backward on CUDA sums by atomics, so a
# gradient that should be equal bit for bit (remat) is held within
# LM_NONDET_RL2
LM_LOSS_RTOL, LM_GRAD_RL2, LM_CHUNK_RTOL = 1e-5, 1e-4, 1e-6
LM_MB_LOSS_RTOL, LM_MB_ATOL = 2e-2, 5e-2
LM_NONDET_RL2 = 1e-6
# Phase 16: the MoE super-block of llama4-maverick at full width
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_LAYERS = 2                    # of 48: one dense/MoE super-block (2 would
                                  #   hold about 70 GB of bf16 weights)
MOE_PROMPT = 1024                 # tokens of the full-width moe_ffn check
MOE_REF_RL2 = 2e-2                # bf16 moe_ffn vs the float32 reference
MOE_TIE_GAP = 1e-4                # router logit gap of a card/CPU top-k split
# Phase 17: deepseek-v2-lite (MLA, the dense prelude, top-6) at full depth
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_PROMPT = 1024                 # tokens of the full-width module checks
MLA_REF_RL2 = 2e-2                # bf16 mla_attention vs the float32
                                  #   absorbed reference, and its decode vs
                                  #   a prefill of one more token
# Phase 18: jamba-v0.1-52b's hybrid super-block at full width
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 8                  # of 32: one period-8 super-block (all 32
                                  #   would hold 103 GB of bf16 weights)
JAMBA_PROMPT = 1024               # tokens of the full-width Mamba check
MAMBA_REF_RL2 = 2e-2              # bf16 mamba_forward (output and states)
                                  #   vs the float64 recurrence, and its
                                  #   decode vs a prefill of one more token
# Phase 19: whisper-large-v3 at every published width and full depth
WHISPER_ARCH = "whisper-large-v3"
WHISPER_FRAMES, WHISPER_B = 1500, 4   # whisper's 30 s encoder window
WHISPER_MAX_LEN = 448                 # whisper's max_target_positions
WHISPER_NEW = 64                      # greedy tokens a lane
ATTN_F64_L2 = 1e-4                    # float32 attention(kv_x=) vs float64
# Phase 20: llava-next-mistral-7b at every published width and full depth
LLAVA_ARCH = "llava-next-mistral-7b"
LLAVA_SEQ, LLAVA_B = 4096, 2          # 1,024 patches + 3,072 text tokens
LLAVA_MAX_LEN = 4160
LLAVA_NEW = 32
LLAVA_SERVE_MAX_LEN = 64              # the text-only engine
LLAVA_CUT_LAYERS, LLAVA_CUT_SEQ = 2, 256   # 64 patches + 192 tokens
CARD_CPU_L2 = 1e-4                    # float32 logits, card vs the CPU
MODE_KW = {"fused_snn_net": {},
           "fused_snn_net_gated": {"use_sparse": True,
                                   "gate_granularity": GATE_G},
           "fused_snn_net_events": {"use_events": True,
                                    "event_crossover": CROSSOVER}}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int) -> tuple:
    """(device ms, host ms) per call of ``fn``. A spin kernel first holds
    the stream busy for longer than the host needs to enqueue ``iters``
    calls, so the CUDA events around them time the calls' device work back
    to back and not the host's marshalling; the host time is that of the
    enqueueing loop alone. A call that issues more launches than the
    device's launch queue holds (the plain version's hundreds of small
    ops) blocks the host on the queue, and both times then come out as the
    host-bound time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    budget_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(budget_s * 4e9))   # >= 2 x budget at <= 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def net_bound_ms(T: int, B: int, widths: tuple, *, readout: bool,
                 v_init: bool, emit_rasters: bool, macs: float = None,
                 backend: str = "cuda", block_b: int = 8,
                 gate_granularity: int = 1) -> tuple:
    """Least time the card could take for one fused-network call of
    ``backend``: the bytes `trace_cost.dispatch_cost` charges its kernel
    node (input raster, weights, V in and out, rasters and counters, each
    moved once) against 2 int8 operations per multiply-accumulate:
    ``macs`` (the ones this call's data needs) or the node's dense
    T*B*sum(N_i*N_{i+1}). Returns (ms, bound_by, bytes, dense MACs)."""
    from repro_torch.analysis.trace_cost import dispatch_cost
    cost = dispatch_cost(widths, T, B, readout=readout, v_init=v_init,
                         emit_rasters=emit_rasters, backend=backend,
                         block_b=block_b, gate_granularity=gate_granularity,
                         device="cuda")
    if macs is None:
        macs = cost.macs
    t_bytes = cost.hbm_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_INT8_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", cost.hbm_bytes, cost.macs)


def hand_net_bytes(T: int, B: int, widths: tuple, *, readout: bool,
                   v_init: bool, emit_rasters: bool,
                   counter_bytes: int = 0) -> int:
    """The bytes of one fused-network call by formula (input raster,
    weights, V in and out, rasters, ``counter_bytes``): an independent
    count that phase 21 holds the cost model (`trace_cost`) to on phase
    4's calls."""
    n_spiking = len(widths) - 2 if readout else len(widths) - 1
    weights = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return (T * B * widths[0] + weights
            + 4 * B * sum(widths[1:]) * (2 if v_init else 1)
            + (T * B * sum(widths[1:n_spiking + 1]) if emit_rasters else 0)
            + counter_bytes)


def needed_macs(name: str, counters, T: int, B: int, widths: tuple,
                block_b: int) -> float:
    """Multiply-accumulates the data of one call needs under the kernel's
    own rule: the dense product; the occupied gate blocks' rows for the
    real lanes of each tile (from the skip counts); one weight row per
    event (from the row counts)."""
    outs = widths[1:]
    if name == "fused_snn_net":
        return T * B * sum(a * b for a, b in zip(widths[:-1], outs))
    if name == "fused_snn_net_events":
        return sum(int(rc.sum()) * n for rc, n in
                   zip(counters["row_events"], outs))
    skips = counters if isinstance(counters, list) else [counters]
    lanes = [min(block_b, B - t * block_b) for t in range(-(-B // block_b))]
    bw = 128 // GATE_G
    macs = 0
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], outs)):
        sk = skips[i].cpu().numpy()                    # (tiles, blocks)
        width = [min(bw, n_in - lo) for lo in range(0, n_in, bw)]
        for tile, nb in enumerate(lanes):
            macs += nb * n_out * sum((T - int(sk[tile, g])) * w
                                     for g, w in enumerate(width))
    return macs


def skipped_share(name: str, counters, T: int, B: int, widths: tuple):
    """Share of the gate sites a call skipped: silent (tile, block) gates of
    the gated kernel, silent (frame, row) sites of the event-list kernel;
    None for the dense kernel."""
    if name == "fused_snn_net_gated":
        skips = counters if isinstance(counters, list) else [counters]
        sites = sum(s.numel() for s in skips) * T
        return sum(int(s.sum()) for s in skips) / sites
    if name == "fused_snn_net_events":
        events = sum(int(rc.sum()) for rc in counters["row_events"])
        return 1.0 - events / (T * B * sum(widths[:-1]))
    return None


def counter_bytes(name: str, B: int, widths: tuple, block_b: int) -> int:
    tiles = -(-B // block_b)
    if name == "fused_snn_net_gated":
        return 4 * tiles * sum(-(-n // (128 // GATE_G)) for n in widths[:-1])
    if name == "fused_snn_net_events":
        return 4 * tiles * (sum(widths[:-1]) + len(widths) - 1)
    return 0


def raster(rng, shape, density: float, structured: bool) -> np.ndarray:
    """{0, 1} int8 raster: iid at ``density``, or (``structured``) with
    silent 16-row chunks per lane and whole silent frames on top, so gate
    blocks at every granularity are sometimes silent."""
    spikes = rng.random(shape) < density
    if structured:
        T, B, n = shape
        spikes &= np.repeat(rng.random((T, B, -(-n // 16))) < 0.4, 16,
                            axis=2)[:, :, :n]
        spikes &= rng.random((T, 1, 1)) < 0.7
    return spikes.astype(np.int8)


def net_case(widths, T, B, readout, v_init, seed, dev, density=0.3,
             structured=False, fill=None):
    """Seeded raster (or a constant ``fill``), weights biased positive so V
    reaches the 11-bit limits, thresholds and leaks, optional carried V."""
    rng = np.random.default_rng(seed)
    spikes = (np.full((T, B, widths[0]), fill, np.int8) if fill is not None
              else raster(rng, (T, B, widths[0]), density, structured))
    spikes = torch.from_numpy(spikes).to(dev)
    ws = [torch.from_numpy(rng.integers(-20, 32, (a, b)).astype(np.int8)).to(dev)
          for a, b in zip(widths[:-1], widths[1:])]
    n_spiking = len(ws) - 1 if readout else len(ws)
    ths = tuple(int(x) for x in rng.integers(20, 1000, n_spiking))
    lks = tuple(int(x) for x in rng.integers(0, 120, n_spiking))
    vi = ([torch.from_numpy(rng.integers(-1024, 1024, (B, n)).astype(np.int32))
           .to(dev) for n in widths[1:]] if v_init else None)
    return spikes, ws, ths, lks, vi


def flat_outputs(out) -> list:
    """Rasters, V and every counter tensor of one wrapper result."""
    rasters, vs, counters = out
    if isinstance(counters, dict):
        counters = counters["row_events"] + [counters["dense_fallbacks"]]
    elif torch.is_tensor(counters):
        counters = [counters]
    return list(rasters) + list(vs) + list(counters or [])


def kernel_cases() -> dict:
    """Phase-2 cases per kernel: (widths, T, B, readout, v_init, emit,
    neuron, clamp, block_b, mode kwargs, raster kwargs)."""
    grid = [(n, c, vi) for n in ("if", "lif", "rmp")
            for c in ("saturate", "wrap") for vi in (False, True)]
    dense = [(IMDB_WIDTHS, 10, 256, True, vi, emit, n, c, 8, {}, {})
             for n, c, vi in grid for emit in (False, True)]
    dense += [(IMDB_WIDTHS, 10, 37, True, True, True, "rmp", "wrap", 8, {}, {}),
              (IMDB_WIDTHS, 7, 1, True, False, True, "lif", "saturate", 8, {},
               {}),
              (IMDB_WIDTHS, 10, 300, True, True, True, "rmp", "saturate", 64,
               {}, {}),
              ((126, 14), 10, 784, False, True, True, "lif", "wrap", 8, {}, {}),
              ((126, 14), 3, 785, False, False, True, "rmp", "saturate", 32,
               {}, {})]
    # the dense plan's chunk edges (16 steps a chunk), its lane tiles
    # (block_b does not tile it), and every stack it runs
    dense += [(IMDB_WIDTHS, T, 37, True, T % 2 == 1, k % 2 == 0, n, c, 8, {},
               {}) for T in (1, 15, 16, 17, 33, 120)
              for k, (n, c) in enumerate((n, c) for n in ("if", "lif", "rmp")
                                         for c in ("saturate", "wrap"))]
    dense += [(IMDB_WIDTHS, 10, B, True, k % 2 == 0, k % 3 != 0, n, c, bb,
               {}, {"density": 0.15})
              for k, ((B, bb), (n, c)) in enumerate(zip(
                  [(B, bb) for B in (1, 37, 300, 4096)
                   for bb in (1, 8, 32, 64)],
                  [(n, c) for n in ("if", "lif", "rmp")
                   for c in ("saturate", "wrap")] * 3))]
    dense += [(MNIST_FC, 10, 64, True, False, True, "rmp", "saturate", 8, {},
               {"density": 0.1}),
              (MNIST_FC, 17, 37, True, True, False, "lif", "wrap", 64, {},
               {"density": 0.1}),
              (WIDE_WIDTHS, 10, 300, True, True, True, "if", "wrap", 8, {}, {}),
              (CONV_STACK, 10, 12_544, False, False, True, "rmp", "saturate",
               8, {}, {"density": 0.1}),
              (CONV_STACK, 10, 3136, False, True, True, "rmp", "wrap", 8, {},
               {"density": 0.1})]
    # the plan's lower rungs: compact weight rows, no readout counts, and
    # tiles of 4, 2 and 1 lanes
    dense += [(widths, 17, 9, True, True, True, "rmp", "saturate", 8, {},
               {"density": 0.1})
              for widths in ((100, 1000, 14, 1000, 10), (14, 686, 14, 3000, 1),
                             (14, 4000, 1), (14, 1500, 14, 4000, 1),
                             (14, 4000, 14, 2000, 1))]
    sparse = {"density": 0.15, "structured": True}
    iid85 = {"density": 0.15}
    gated, events = [], []
    for k, (n, c, vi) in enumerate(grid):
        for g in (1, 2, 4, 8):
            gated.append((IMDB_WIDTHS, 10, 256, True, vi, k % 2 == 0, n, c, 8,
                          {"use_sparse": True, "gate_granularity": g}, sparse))
        for x in (0.0, 0.15, 0.5, 1.0):
            events.append((IMDB_WIDTHS, 10, 256, True, vi, k % 2 == 0, n, c,
                           8, {"use_events": True, "event_crossover": x},
                           iid85))
    edge = [(IMDB_WIDTHS, 10, 256, True, False, True, "rmp", "saturate", 8,
             {"fill": 0}),
            (IMDB_WIDTHS, 10, 256, True, True, True, "lif", "wrap", 8,
             {"fill": 1}),
            (IMDB_WIDTHS, 10, 1, True, True, True, "rmp", "wrap", 8, sparse),
            (IMDB_WIDTHS, 10, 37, True, True, True, "if", "saturate", 8,
             sparse),
            (IMDB_WIDTHS, 10, 300, True, True, True, "rmp", "saturate", 8,
             sparse),
            (IMDB_WIDTHS, 10, 300, True, True, True, "lif", "wrap", 64,
             sparse),
            (WIDE_WIDTHS, 10, 300, True, True, True, "rmp", "wrap", 8,
             sparse),
            (WIDE_WIDTHS, 10, 37, True, False, True, "lif", "saturate", 64,
             sparse)]
    for widths, T, B, ro, vi, emit, n, c, bb, rk in edge:
        for g in (1, 2, 4, 8):
            gated.append((widths, T, B, ro, vi, emit, n, c, bb,
                          {"use_sparse": True, "gate_granularity": g}, rk))
        for x in (0.0, 0.15, 0.5, 1.0):
            events.append((widths, T, B, ro, vi, emit, n, c, bb,
                           {"use_events": True, "event_crossover": x}, rk))
    return {"fused_snn_net": dense, "fused_snn_net_gated": gated,
            "fused_snn_net_events": events}


def phase_kernel_vs_plain(ops, dev) -> dict:
    """Phase 2: per kernel, (cases, max |kernel - plain|) over its cases."""
    result = {}
    for name, cases in kernel_cases().items():
        worst = 0
        for n, (widths, T, B, readout, v_init, emit, neuron, clamp, block_b,
                mode_kw, raster_kw) in enumerate(cases):
            spikes, ws, ths, lks, vi = net_case(widths, T, B, readout, v_init,
                                                seed=100 + n, dev=dev,
                                                **raster_kw)
            kw = dict(neuron=neuron, clamp_mode=clamp, readout=readout,
                      emit_rasters=emit, v_init=vi, block_b=block_b, **mode_kw)
            got = flat_outputs(ops.fused_snn_net(spikes, ws, thresholds=ths,
                                                 leaks=lks, **kw))
            want = flat_outputs(ops.fused_snn_net_ref(spikes, ws, ths, lks,
                                                      **kw))
            torch.cuda.synchronize()
            if len(got) != len(want):
                raise AssertionError(f"{name} case {n}: output counts differ")
            for g, w in zip(got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(
                        f"{name} case {n}: {g.dtype}{tuple(g.shape)} != "
                        f"{w.dtype}{tuple(w.shape)}")
                worst = max(worst, int((g.long() - w.long()).abs().max())
                            if g.numel() else 0)
            if worst:
                raise AssertionError(
                    f"{name} case {n} ({widths}, T={T}, B={B}, "
                    f"{neuron}/{clamp}, v_init={v_init}, rasters={emit}, "
                    f"block_b={block_b}, {mode_kw}, {raster_kw}): kernel "
                    f"differs from the plain version by {worst}")
        result[name] = (len(cases), worst)
    return result


def same_request(a, b) -> bool:
    return (np.array_equal(a.v_out, b.v_out)
            and np.array_equal(a.logits, b.logits) and a.ticks == b.ticks
            and all(np.array_equal(x, y) for x, y in
                    zip(a.report.row_events, b.report.row_events)))


def host_program(program):
    """``program``'s copy on the CPU (its arrays carried across)."""
    from repro_torch.core import pipeline

    def arr(x):
        return x.cpu().numpy() if torch.is_tensor(x) else x
    return pipeline.program_from_arrays(
        [{"kind": ly.kind, "n_in": ly.n_in, "n_out": ly.n_out,
          "w": arr(ly.w), "threshold": arr(ly.threshold),
          "leak": arr(ly.leak), "scale": ly.scale, "stride": ly.stride,
          "state_shape": ly.state_shape} for ly in program.layers],
        neuron=program.neuron, timesteps=program.timesteps,
        clamp_mode=program.clamp_mode, device="cpu", cfg=program.cfg)


def phase_serving(dev) -> dict:
    """Phase 3: the main paths, 64 IMDB requests through the cuda,
    cuda_sparse and cuda_events engines."""
    from repro_torch import kernels
    from repro_torch.configs.impulse_snn import IMDB
    from repro_torch.core import pipeline, snn
    from repro_torch.launch.serve_snn import make_requests
    from repro_torch.serve import SNNServeEngine

    program = pipeline.compile_network(IMDB, snn.init_fc_snn(SEED, IMDB),
                                       domain="int", device=dev)
    cfg = dict(batch_slots=32, pages=2, megastep=10, device=dev)
    step_kw = {"cuda_sparse": {"gate_granularity": GATE_G},
               "cuda_events": {"event_crossover": CROSSOVER}}

    def requests():
        return make_requests(program, 64, 6, IMDB.timesteps, 0.85, SEED)

    def drain(backend, window=None):
        eng = SNNServeEngine(program, backend=backend,
                             step_kw=step_kw.get(backend), **cfg)
        for r in requests():
            eng.submit(r)
        torch.cuda.synchronize()
        with window or contextlib.nullcontext():
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return sorted(done, key=lambda r: r.rid), dt, eng

    ref, dt_ref, _ = drain("int_ref")
    if len(ref) != 64 or any(r.ticks != 60 for r in ref):
        raise AssertionError("the int_ref engine did not serve 64 x 60 frames")
    cpu_eng = SNNServeEngine(host_program(program), backend="int_ref",
                             batch_slots=4, megastep=10, device="cpu")
    for r in requests()[:6]:
        cpu_eng.submit(r)
    cpu = sorted(cpu_eng.run_until_drained(), key=lambda r: r.rid)
    bad = [a.rid for a, b in zip(ref, cpu) if not same_request(a, b)]
    if bad:
        raise AssertionError(f"requests {bad}: int_ref on the card != int_ref "
                             "on the CPU")
    out = {"frames": sum(r.ticks for r in ref), "int_ref_s": dt_ref,
           "int_ref_frames_per_s": sum(r.ticks for r in ref) / dt_ref,
           "engines": {}}
    for backend in ("cuda", "cuda_sparse", "cuda_events"):
        drain(backend)                             # warm-up, not counted
        kernels.reset_launch_counts()
        served, dt, eng = drain(backend)
        launches = dict(kernels.LAUNCH_COUNTS)
        for r in served:
            if (r.v_out.shape != (1,) or r.logits.shape != (1,)
                    or not np.isfinite(r.logits).all()):
                raise AssertionError(f"{backend} request {r.rid}: bad readout "
                                     f"{r.logits}")
        bad = [a.rid for a, b in zip(served, ref) if not same_request(a, b)]
        if len(served) != 64 or bad:
            raise AssertionError(f"{backend} engine != int_ref engine on the "
                                 f"card (requests {bad})")
        name = [k for k, b in BACKEND_OF.items() if b == backend][0]
        if launches[name] < 1:
            raise AssertionError(f"the {backend} drain never launched {name}")
        row = {"s": dt, "frames_per_s": out["frames"] / dt,
               "launches": launches,
               "skipped_row_fraction":
                   eng.aggregate_report().skipped_row_fraction}
        if backend == "cuda_events":
            row.update(event_ledger(drain, eng))
        row["profile"] = profile_drain(drain, backend)
        out["engines"][backend] = row
    return out


def event_ledger(drain, eng) -> dict:
    """The cuda_events engine's device ledger against a ref_events engine's
    and against the per-request raster tally (exact: every lane is full
    and 60 frames is a multiple of K, so no lane runs ghost ticks)."""
    _, _, host_eng = drain("ref_events")
    got, want = eng.device_event_stats(), host_eng.device_event_stats()
    tally = eng.aggregate_report().row_events
    if got.frames != want.frames or not all(
            np.array_equal(a, b) and np.array_equal(a, c)
            for a, b, c in zip(got.row_events, want.row_events, tally)):
        raise AssertionError("the cuda_events device ledger differs from the "
                             "ref_events engine's or from the raster tally")
    return {"device_skipped_row_fraction": eng.device_skipped_row_fraction(),
            "ref_events_device_skipped_row_fraction":
                host_eng.device_skipped_row_fraction(),
            "device_row_events": [int(r.sum()) for r in got.row_events],
            "dense_fallbacks": list(got.dense_fallbacks),
            "device_ticks": eng.device_ticks}


def device_events(prof) -> list:
    """(name, ms) of every device (CUDA) event a finished torch.profiler
    recorded, read from its raw kineto events. `prof.events()` gives the
    same events but first builds a Python tree over every host event too,
    which took minutes a phase over the LM drains' hundreds of thousands
    of host ops."""
    from torch.autograd import DeviceType
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def profile_drain(drain, *args) -> dict:
    """One more drain (``drain(*args, window=...)``, returning its wall
    time second) under torch.profiler, which the drain turns on around its
    timed part only (``window``), so an engine's build (a compiled
    engine's warm-up and capture) stays outside: the drain's wall time,
    the device time of the eight largest kernels and copies it ran and of
    every kernel of the port, its device op count, and the share of the
    wall time the device was idle. The profiler slows the host, so the
    wall time here is not the drain's throughput."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, wall_s, _ = drain(*args, window=prof)
    by_name: dict = {}
    for name, ms_e in device_events(prof):
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + ms_e, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "device_ops": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:60], "ms": ms, "count": n}
                    for k, (ms, n) in top],
            "port_kernels": [{"name": k[:60], "ms": ms, "count": n}
                             for k, (ms, n) in by_name.items()
                             if any(x in k for x in PORT_KERNELS)]}


def phase_timing(ops, dev, name: str, B: int, structured: bool = False
                 ) -> dict:
    """Phase 4: kernel ``name`` at the main path's shape (K = 10 frames,
    IMDB widths, carried V, rasters on, 85 % input sparsity, its drain's
    mode options) and batch ``B``; iid spikes, or (``structured``) the
    `raster` with silent 16-row chunks and silent frames."""
    rng = np.random.default_rng(SEED)
    T, block_b = 10, 8
    spikes = torch.from_numpy(
        raster(rng, (T, B, 100), 0.15, True) if structured
        else (rng.random((T, B, 100)) > 0.85).astype(np.int8)).to(dev)
    ws = [torch.from_numpy(rng.integers(-31, 32, (a, b)).astype(np.int8)).to(dev)
          for a, b in zip(IMDB_WIDTHS[:-1], IMDB_WIDTHS[1:])]
    vi = [torch.zeros((B, n), dtype=torch.int32, device=dev)
          for n in IMDB_WIDTHS[1:]]
    kw = dict(neuron="rmp", clamp_mode="saturate", v_init=vi, block_b=block_b,
              **MODE_KW[name])
    ths, lks = (53, 61), (3, 3)

    def kernel():
        return ops.fused_snn_net(spikes, ws, thresholds=ths, leaks=lks, **kw)

    def plain():
        return ops.fused_snn_net_ref(spikes, ws, ths, lks, **kw)

    counters = kernel()[2]
    ms, wrapper_ms = device_ms(kernel, 200)
    plain_ms, _ = device_ms(plain, 20)
    bound_ms, bound_by, moved, dense_macs = net_bound_ms(
        T, B, IMDB_WIDTHS, readout=True, v_init=True, emit_rasters=True,
        macs=needed_macs(name, counters, T, B, IMDB_WIDTHS, block_b),
        backend=BACKEND_OF[name], block_b=block_b,
        gate_granularity=MODE_KW[name].get("gate_granularity", 1))
    out = {"T": T, "B": B, "structured": structured, "ms": ms,
           "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
           "dense_macs": dense_macs,
           "skipped_share": skipped_share(name, counters, T, B, IMDB_WIDTHS)}
    if name == "fused_snn_net":
        from repro_torch.kernels.fused_snn_net.kernel import dense_plan
        plan = dense_plan(IMDB_WIDTHS, T, B)
        out["plan"] = {k: plan[k] for k in ("lanes", "tc", "grid", "bytes")}
    return out


def wkv_case(dev, BH: int, T: int, K: int, V: int, seed: int,
             strong: bool) -> tuple:
    """Seeded (B*H, T, K/V) float32 inputs drawn on ``dev`` as the JAX tests
    draw them (r, k, v ~ N(0, 0.25), u ~ N(0, 0.09)), w ~ U[0.6, 0.999) or
    exp(-e) on every step (``strong``), and a N(0, 1) initial state."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k = normal((BH, T, K), 0.5), normal((BH, T, K), 0.5)
    v = normal((BH, T, V), 0.5)
    w = (torch.full((BH, T, K), STRONG_DECAY, device=dev) if strong else
         0.6 + 0.399 * torch.rand((BH, T, K), generator=gen, device=dev))
    return r, k, v, w, normal((BH, K), 0.3), normal((BH, K, V), 1.0)


def wkv_diff(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, every element finite and within WKV_TOL relative
    plus WKV_TOL absolute)."""
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= WKV_TOL + WKV_TOL * want.abs()).all())
    return float(diff.max()), ok


def phase_wkv6_vs_plain(dev, heads: int = 64, head: int = 64,
                        batches=(1, 4), lengths=WKV_LENGTHS,
                        small=WKV_SMALL) -> dict:
    """Phase 5: the wkv6 kernel against `wkv6_sequential` on the card, each
    case from a random initial state. Returns the cases and the worst
    max |diff| of y and of the state."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    cases = [(f"H={heads} B={B}", B * heads, T, head, head, strong)
             for B in batches for T in lengths for strong in (False, True)]
    cases += [(f"small H={H} B={B}", B * H, T, K, V, strong)
              for B, T, H, K, V in small for strong in (False, True)]
    cont = [c for c in cases if c[2] == max(lengths) or c[3] != c[4]]
    worst = [0.0, 0.0]
    rows = []
    for n, (label, BH, T, K, V, strong) in enumerate(cases + cont):
        r, k, v, w, u, s0 = wkv_case(dev, BH, T, K, V, 500 + n, strong)
        halves = n >= len(cases)
        if halves:                  # the second half from the first's state
            h = T // 2
            y1, s1 = wkv_kernel.wkv6_cuda(r[:, :h].contiguous(),
                                          k[:, :h].contiguous(),
                                          v[:, :h].contiguous(),
                                          w[:, :h].contiguous(), u, s0)
            y2, s = wkv_kernel.wkv6_cuda(r[:, h:].contiguous(),
                                         k[:, h:].contiguous(),
                                         v[:, h:].contiguous(),
                                         w[:, h:].contiguous(), u, s1)
            y = torch.cat([y1, y2], dim=1)
        else:
            y, s = wkv_kernel.wkv6_cuda(r, k, v, w, u, s0)
        y_p, s_p = wkv_ref.wkv6_sequential(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        (dy, ok_y), (ds, ok_s) = wkv_diff(y, y_p), wkv_diff(s, s_p)
        row = (f"{label} T={T} K={K} V={V} "
               f"w={'exp(-e)' if strong else 'U[0.6,0.999)'}"
               f"{' two halves' if halves else ''}: max|dy| {dy:.3e}, "
               f"max|ds| {ds:.3e}")
        if not (ok_y and ok_s):
            raise AssertionError(f"wkv6 kernel != plain version beyond "
                                 f"{WKV_TOL} rel + abs (or not finite): {row}")
        worst = [max(worst[0], dy), max(worst[1], ds)]
        rows.append(row)
    return {"rows": rows, "max_abs_err_y": worst[0],
            "max_abs_err_s": worst[1]}


def wkv_bound_ms(BH: int, T: int, K: int, V: int) -> tuple:
    """Least time for one wkv6 call: r, k, w, v, u and s0 read once, y and
    the final state written once (float32), against 4 float32 operations
    per state element per step (a multiply-add into y, a multiply and a
    multiply-add into S) at the card's non-tensor-core float32 rate.
    Returns (ms, bound_by)."""
    moved = 4 * (BH * T * (3 * K + V) + BH * K + 2 * BH * K * V
                 + BH * T * V)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * BH * T * K * V / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_wkv6_timing(dev, T: int, B: int = 1, H: int = 64, K: int = 64
                      ) -> dict:
    """The wkv6 kernel at a prefill shape (B = 1 prompt, H heads of K),
    beside its plain version and its bound."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    args = wkv_case(dev, B * H, T, K, K, SEED, False)
    ms, wrapper_ms = device_ms(lambda: wkv_kernel.wkv6_cuda(*args), 50)
    plain_ms, _ = device_ms(lambda: wkv_ref.wkv6_sequential(*args), 3)
    bound_ms, bound_by = wkv_bound_ms(B * H, T, K, K)
    return {"B": B, "T": T, "H": H, "K": K, "ms": ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


@contextlib.contextmanager
def model_wkv6(fn):
    """Run the RWKV blocks with ``fn`` as their wkv function (a swap made
    by this script only; the port has no switch for it)."""
    from repro_torch.models import rwkv
    orig = rwkv.wkv6
    rwkv.wkv6 = fn
    try:
        yield
    finally:
        rwkv.wkv6 = orig


def plain_wkv6(r, k, v, w, u, s0=None, use_kernel=True, chunk=64):
    """The model-layout wkv6 with `wkv6_sequential` in place of the kernel
    (the serving route's; the model passes the route's keywords)."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    if not use_kernel:
        raise AssertionError("plain_wkv6 stands in for the kernel route")
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    B, _, H, _ = r.shape
    return wkv_ops.from_bh_layout(
        *wkv_ref.wkv6_sequential(*wkv_ops.to_bh_layout(r, k, v, w, u, s0)),
        B, H)


@contextlib.contextmanager
def recorded_logits():
    """Wrap `lm.prefill` and `lm.decode_step` (as the engine calls them) to
    record, per call, its kind, its logits' shape and whether every logit is
    finite (a device flag, read after the run)."""
    from repro_torch.models import lm
    seen = []
    orig = {"prefill": lm.prefill, "decode_step": lm.decode_step}

    def wrap(kind):
        def call(*args, **kw):
            logits, cache = orig[kind](*args, **kw)
            seen.append((kind, tuple(logits.shape),
                         torch.isfinite(logits).all()))
            return logits, cache
        return call
    lm.prefill, lm.decode_step = wrap("prefill"), wrap("decode_step")
    try:
        yield seen
    finally:
        lm.prefill, lm.decode_step = orig["prefill"], orig["decode_step"]


def rel_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Relative L2 error and largest elementwise error over the largest
    |want|."""
    got, want = got.float(), want.float()
    return {"rel_l2": float((got - want).norm() / want.norm()),
            "max_rel": float((got - want).abs().max() / want.abs().max())}


def logit_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """`rel_diff`, and whether the argmax tokens agree."""
    return {**rel_diff(got, want), "argmax_equal": bool(torch.equal(
        got.argmax(-1), want.argmax(-1)))}


def lm_requests(cfg, long_prompts: list, n_short: int = 6) -> list:
    """Phases 6 and 14's 8 requests: ``n_short`` prompts of 4 to 16 tokens
    (the launcher's) and the long prompts, LM_NEW new tokens each."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Request
    reqs = make_requests(cfg, n_short, LM_NEW, SEED)
    return reqs + [Request(rid=n_short + i, prompt=p, max_new_tokens=LM_NEW)
                   for i, p in enumerate(long_prompts)]


def lm_drainer(params, cfg, max_len: int, long_prompts: list,
               n_short: int = 6):
    """(drain, EagerEngine): ``drain(cls, eng, window)`` serves
    `lm_requests` on ``eng`` (kept from an earlier drain, its graphs
    captured) or on a new 4-slot engine of class ``cls`` (the eager engine
    by default), timed around the drain alone (inside ``window``), and
    returns (requests by rid, seconds, engine)."""
    from repro_torch.serve import ServeEngine

    class EagerEngine(ServeEngine):
        _compiled = False

    def drain(cls=EagerEngine, eng=None, window=None):
        if eng is None:
            eng = cls(params, cfg, batch_slots=4, max_len=max_len)
        eng.finished = []
        for r in lm_requests(cfg, long_prompts, n_short):
            eng.submit(r)
        torch.cuda.synchronize()
        with window or contextlib.nullcontext():
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return sorted(done, key=lambda r: r.rid), dt, eng
    return drain, EagerEngine


def free_cuda() -> None:
    gc.collect()             # engines and their graphs hold the params
    torch.cuda.empty_cache()


def compiled_decode(drain, served: list, eager_cls, graphed_cls,
                    repeats: int = 3, label: str = "rwkv",
                    keep: dict = None, profile: bool = True) -> dict:
    """Phases 6 and 14's compiled dispatch: a fresh compiled engine (tick 1
    eager, then one graph replay a tick; phase 14 also one graph per
    prefill bucket) serves the eager drain's tokens; then each engine, its
    first drain done (its graphs captured), drains again ``repeats`` times
    in turns for the median tokens/s, and (``profile``) once under the
    profiler. The two engines go into ``keep`` when it is given."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    got, dt_fresh, geng = drain(graphed_cls)
    kernels_launched = {k: v for k, v in kernels.LAUNCH_COUNTS.items() if v}
    if [r.out_tokens for r in got] != [r.out_tokens for r in served]:
        raise AssertionError(f"the graphed {label} drain served other tokens "
                             "than the eager drain")
    if geng._decode is None or geng._decode.graph is None:
        raise AssertionError(f"the graphed {label} drain replayed no graph")
    fresh_ticks = geng.decode_ticks
    engines = {"eager": drain(eager_cls)[2], "graphed": geng}
    tokens = sum(len(r.out_tokens) for r in got)
    times = {k: [] for k in engines}
    for i in range(repeats):
        for k in (("eager", "graphed") if i % 2 == 0
                  else ("graphed", "eager")):
            again, dt, _ = drain(eng=engines[k])
            if len(again) != len(served):
                raise AssertionError(f"the {k} engine's repeat drain served "
                                     f"{len(again)} requests")
            times[k].append(dt)
    out = {"fresh_graphed_s": dt_fresh, "fresh_decode_ticks": fresh_ticks,
           "launches": kernels_launched}
    for k, eng in engines.items():
        out[k] = {"tokens_per_s": tokens / float(np.median(times[k])),
                  "s": times[k]}
        if not profile:
            continue
        prof = profile_drain(drain, None, eng)
        out[k].update({"device_busy_ms": prof["device_busy_ms"],
                  "device_idle_share": prof["device_idle_share"],
                  "device_ops": prof["device_ops"],
                  "profiled_wall_ms": prof["wall_ms"], "top": prof["top"]})
    if keep is not None:
        keep.update(engines)
    return out


def phase_rwkv(dev, cfg, long_prompt: int = LONG_PROMPT,
               cut_layers: int = 2) -> dict:
    """Phase 6: ``cfg`` served by the port's ServeEngine, bf16 weights from
    seed 0 drawn on ``dev``; then the kernel held against its plain version
    inside the model, and the float32 model's checks."""
    from repro_torch import kernels
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    params = lm.init_params(SEED, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params": sum(a.numel() for a in leaves(params))}
    rng = np.random.default_rng(SEED + 1)
    long_prompts = [rng.integers(0, cfg.vocab_size, long_prompt)
                    for _ in range(2)]

    drain, EagerEngine = lm_drainer(params, cfg, 2 * long_prompt,
                                    long_prompts)

    drain()                                        # warm-up, not counted
    kernels.reset_launch_counts()
    # the eager drain: its decode_step calls are the ticks, each checked
    with recorded_logits() as seen:
        served, dt = drain()[:2]        # the engine (and its params) not kept
    launches = dict(kernels.LAUNCH_COUNTS)
    prefills = sum(kind == "prefill" for kind, _, _ in seen)
    bad_shape = [(kind, shape) for kind, shape, _ in seen
                 if shape != ((1 if kind == "prefill" else 4), cfg.vocab_size)]
    if not all(bool(flag) for _, _, flag in seen) or bad_shape:
        raise AssertionError(f"non-finite logits or bad shapes {bad_shape}")
    if len(served) != 8 or any(len(r.out_tokens) != 16 for r in served):
        raise AssertionError("the engine did not serve 8 requests x 16 "
                             "tokens")
    if prefills != 8 or launches["wkv6"] != cfg.n_layers * prefills:
        raise AssertionError(f"{launches['wkv6']} wkv6 launches for "
                             f"{prefills} prefills of {cfg.n_layers} layers")
    tokens = sum(len(r.out_tokens) for r in served)
    out.update({"drain_s": dt, "tokens": tokens, "tokens_per_s": tokens / dt,
                "prefills": prefills, "launches": launches,
                "decode_ticks": sum(k == "decode_step" for k, _, _ in seen),
                "first_tokens": [r.out_tokens[:4] for r in served]})
    out["profile"] = profile_drain(drain)
    out["compiled"] = compiled_decode(drain, served, EagerEngine, ServeEngine)

    # The kernel on the served model's own activations, layer by layer. Its
    # y and S reach thousands and hundreds there (decays up to 0.9997 over
    # 1,024 steps, activations well above unit scale), and a y element that
    # cancels to near zero keeps the float32 error of its terms, so each
    # layer is held by relative L2 error: |dy| / |y| and |dS| / |S| within
    # WKV_TOL. The median |y| is kept beside it to show the scale.
    from repro_torch.models import rwkv
    model_fn, calls = rwkv.wkv6, []

    def recording(*args, **kw):
        y, s = model_fn(*args, **kw)
        calls.append((args, kw, y, s))
        return y, s

    toks = torch.as_tensor(long_prompts[0][None], device=dev)
    with model_wkv6(recording):
        logits_k, _ = lm.prefill(params, {"tokens": toks}, cfg, long_prompt)
    rows = []
    for n, (args, kw, y, s) in enumerate(calls):
        y_p, s_p = plain_wkv6(*args, **kw)
        row = {"layer": n,
               "rel_l2_y": float((y - y_p).norm() / y_p.norm()),
               "rel_l2_s": float((s - s_p).norm() / s_p.norm()),
               "max_abs_err_y": float((y - y_p).abs().max()),
               "max_abs_err_s": float((s - s_p).abs().max()),
               "median_abs_y": float(y_p.abs().median()),
               "max_abs_y": float(y_p.abs().max()),
               "finite": bool(torch.isfinite(y).all()
                              and torch.isfinite(s).all())}
        if not (row["finite"] and row["rel_l2_y"] <= WKV_TOL
                and row["rel_l2_s"] <= WKV_TOL):
            raise AssertionError(f"wkv6 kernel != plain version on the "
                                 f"model's activations beyond {WKV_TOL} "
                                 f"relative L2: {row}")
        rows.append(row)
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"{len(calls)} wkv6 calls in one prefill")
    out["layers"] = {"calls": len(calls), "tolerance_rel_l2": WKV_TOL,
                     "rows": rows}
    del calls
    with model_wkv6(plain_wkv6):
        logits_p, _ = lm.prefill(params, {"tokens": toks}, cfg, long_prompt)
    out["bf16_full_depth"] = logit_diff(logits_k, logits_p)

    cut = dict(params, blocks=lm.tree_map(lambda a: a[:cut_layers],
                                          params["blocks"]))
    cfg_cut = dataclasses.replace(cfg, n_layers=cut_layers)
    logits_k, _ = lm.prefill(cut, {"tokens": toks}, cfg_cut, long_prompt)
    with model_wkv6(plain_wkv6):
        logits_p, _ = lm.prefill(cut, {"tokens": toks}, cfg_cut, long_prompt)
    out["bf16_cut"] = d = logit_diff(logits_k, logits_p)
    d["layers"] = cut_layers
    if not (d["rel_l2"] <= BF16_CUT_L2 and d["argmax_equal"]):
        raise AssertionError(f"bf16 {cut_layers}-layer prefill: kernel and "
                             f"plain differ beyond {BF16_CUT_L2}: {d}")
    del params, cut
    free_cuda()

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    params = lm.init_params(SEED, cfg, dtype=torch.float32, device=dev)
    logits_k, cache = lm.prefill(params, {"tokens": toks}, cfg, long_prompt)
    with model_wkv6(plain_wkv6):
        logits_p, _ = lm.prefill(params, {"tokens": toks}, cfg, long_prompt)
    out["f32_full_depth"] = d = logit_diff(logits_k, logits_p)
    if not (d["rel_l2"] <= F32_L2 and d["max_rel"] <= F32_L2
            and d["argmax_equal"]):
        raise AssertionError(f"float32 prefill: kernel and plain differ "
                             f"beyond {F32_L2}: {d}")
    nxt = logits_k.argmax(-1)[:, None]
    full, _ = lm.prefill(params, {"tokens": torch.cat([toks, nxt], 1)}, cfg,
                         long_prompt + 1)
    dec, _ = lm.decode_step(params, nxt, cache, cfg)
    out["f32_prefill_vs_decode"] = d = logit_diff(dec, full)
    if not (d["rel_l2"] <= F32_DECODE_L2 and d["max_rel"] <= F32_DECODE_L2):
        raise AssertionError(f"float32: prefill of prompt + 1 token and "
                             f"prefill + decode differ beyond "
                             f"{F32_DECODE_L2}: {d}")
    del params
    torch.cuda.empty_cache()
    return out


def step_cases() -> list:
    """Phase-7 cases: every (neuron, clamp, reset) combination on every
    shape row (T, B, N_in, N_out, block_b, density). The rows cover each
    value of each axis; the first three are the Fig. 9 case and the two
    IMDB layers of the per-layer path."""
    shapes = [(10, 8, 128, 128, 8, 0.1), (120, 8, 100, 128, 8, 0.1),
              (120, 8, 128, 128, 8, 0.1), (1, 1, 100, 1, 8, 0.5),
              (10, 37, 686, 14, 8, 0.5), (10, 300, 686, 128, 64, 0.1),
              (1, 300, 128, 14, 64, 0.5), (120, 37, 100, 1, 64, 0.5)]
    return [(shape, neuron, clamp, reset) for shape in shapes
            for neuron in ("if", "lif", "rmp")
            for clamp in ("saturate", "wrap") for reset in (0, 1)]


def step_case(dev, T, B, n_in, n_out, density, seed):
    """Seeded raster and weights biased positive, so V reaches the 11-bit
    limits."""
    rng = np.random.default_rng(seed)
    spikes = torch.from_numpy(
        (rng.random((T, B, n_in)) < density).astype(np.int8)).to(dev)
    wq = torch.from_numpy(
        rng.integers(-20, 32, (n_in, n_out)).astype(np.int8)).to(dev)
    return spikes, wq, rng


def phase_step_vs_plain(dev) -> dict:
    """Phase 7: the fused_snn_step kernel against `fused_snn_layer_ref` on
    the card. Returns the cases and the worst max |diff|."""
    from repro_torch.kernels.fused_snn_step.ops import fused_snn_layer
    from repro_torch.kernels.fused_snn_step.ref import fused_snn_layer_ref
    worst = 0
    cases = step_cases()
    for n, ((T, B, n_in, n_out, block_b, density), neuron, clamp,
            reset) in enumerate(cases):
        spikes, wq, rng = step_case(dev, T, B, n_in, n_out, density, 700 + n)
        kw = dict(neuron=neuron, clamp_mode=clamp,
                  threshold=int(rng.integers(20, 1000)),
                  leak=(-int(rng.integers(1, 60)) if neuron == "lif"
                        else int(rng.integers(0, 60))),
                  reset=int(rng.integers(-500, 500)) if reset else 0)
        got = fused_snn_layer(spikes, wq, block_b=block_b, **kw)
        want = fused_snn_layer_ref(spikes, wq, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"fused_snn_step case {n}: "
                                     f"{g.dtype}{tuple(g.shape)} != "
                                     f"{w.dtype}{tuple(w.shape)}")
            worst = max(worst, int((g.long() - w.long()).abs().max()))
        if worst:
            raise AssertionError(
                f"fused_snn_step case {n} (T={T}, B={B}, {n_in}->{n_out}, "
                f"block_b={block_b}, density {density}, {kw}): kernel "
                f"differs from the plain version by {worst}")
    return {"cases": len(cases), "max_abs_err": worst}


def phase_step_timing(dev, label: str, spikes, wq, **kw) -> dict:
    """The fused_snn_step kernel on one layer call, beside its plain
    version and its bound (the function moves the input raster, the
    weights, the output raster and V once)."""
    from repro_torch.kernels.fused_snn_step.ops import fused_snn_layer
    from repro_torch.kernels.fused_snn_step.ref import fused_snn_layer_ref
    T, B, n_in = spikes.shape
    ms, wrapper_ms = device_ms(lambda: fused_snn_layer(spikes, wq, **kw), 200)
    plain_ms, _ = device_ms(lambda: fused_snn_layer_ref(spikes, wq, **kw), 5)
    bound_ms, bound_by, _, _ = net_bound_ms(T, B, (n_in, wq.shape[1]),
                                            readout=False, v_init=False,
                                            emit_rasters=True)
    return {"case": label, "T": T, "B": B, "n_in": n_in,
            "n_out": int(wq.shape[1]), "ms": ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def fusion_hbm_bytes(emit_rasters: bool, fused: bool) -> int:
    """`benchmarks/pipeline_fusion.py::_hbm_bytes`: int8 spike rasters and
    int32 V crossing device memory per inference batch. Per-layer dispatch
    stores each spiking layer's output raster, loads it in the next layer
    and writes V per layer; the fused network reads the input raster and
    writes the final V (and the rasters in accounting mode)."""
    bytes_ = FUSION_T * FUSION_B * FUSION_LAYERS[0][0]
    for i, (n_in, n_out) in enumerate(FUSION_LAYERS):
        is_readout = i == len(FUSION_LAYERS) - 1
        if fused:
            if emit_rasters and not is_readout:
                bytes_ += FUSION_T * FUSION_B * n_out
        else:
            if not is_readout:
                bytes_ += 2 * FUSION_T * FUSION_B * n_out
            bytes_ += 4 * FUSION_B * n_out
    bytes_ += 4 * FUSION_B * FUSION_LAYERS[-1][1]
    return bytes_


def phase_per_layer(dev) -> tuple:
    """Phase 8: the per-layer path (two fused_snn_step launches and the
    int32 readout) against one fused-network launch on the IMDB stack.
    Returns its results and each spiking layer's (input raster, weights)."""
    from repro_torch import kernels
    from repro_torch.core import energy
    from repro_torch.core.isa import InstrCount, int_matmul
    from repro_torch.kernels.fused_snn_net.ops import fused_snn_net
    from repro_torch.kernels.fused_snn_step.ops import fused_snn_layer
    rng = np.random.default_rng(SEED)
    spikes = torch.from_numpy(
        (rng.random((FUSION_T, FUSION_B, FUSION_LAYERS[0][0])) < 0.1)
        .astype(np.int8)).to(dev)
    ws = [torch.from_numpy(rng.integers(-31, 32, shp).astype(np.int8)).to(dev)
          for shp in FUSION_LAYERS]

    def per_layer():
        cur, rasters = spikes, []
        for w in ws[:-1]:
            cur, _ = fused_snn_layer(cur, w, threshold=FUSION_TH,
                                     leak=FUSION_LEAK, neuron="rmp")
            rasters.append(cur)
        ro = int_matmul(cur.reshape(-1, cur.shape[-1]), ws[-1])
        return rasters, ro.reshape(FUSION_T, FUSION_B, -1).sum(
            dim=0, dtype=torch.int32)

    def fused(emit_rasters=True):
        return fused_snn_net(spikes, ws, thresholds=(FUSION_TH,) * 2,
                             leaks=(FUSION_LEAK,) * 2, neuron="rmp",
                             emit_rasters=emit_rasters)

    kernels.reset_launch_counts()
    rasters, v_layer = per_layer()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    if launches["fused_snn_step"] != 2:
        raise AssertionError(f"the per-layer path launched fused_snn_step "
                             f"{launches['fused_snn_step']} times, not 2")
    r_fused, v_fused, _ = fused()
    torch.cuda.synchronize()
    if not torch.equal(v_layer, v_fused[-1]) or not all(
            torch.equal(a, b) for a, b in zip(rasters, r_fused)):
        raise AssertionError("per-layer dispatch and the fused network "
                             "differ in readout V or rasters")
    layer_ms, _ = device_ms(per_layer, 100)
    fused_ms, _ = device_ms(fused, 100)
    serving_ms, _ = device_ms(lambda: fused(False), 100)
    events = int(step_case(dev, 10, 8, 128, 128, 0.15, SEED)[0].sum())
    cnt = InstrCount(acc_w2v=2 * events, spike_check=2 * 8 * 10,
                     acc_v2v=2 * 8 * 10)
    return {
        "launches": launches, "identical": True,
        "readout_v": v_layer[:, 0].tolist(),
        "spike_rates": [float(r.float().mean()) for r in rasters],
        "per_layer_ms": layer_ms, "fused_accounting_ms": fused_ms,
        "fused_serving_ms": serving_ms,
        "per_layer_over_fused": layer_ms / fused_ms,
        "per_layer_over_fused_serving": layer_ms / serving_ms,
        "hbm_bytes": {"per_layer": fusion_hbm_bytes(True, False),
                      "fused_accounting": fusion_hbm_bytes(True, True),
                      "fused_serving": fusion_hbm_bytes(False, True)},
        "fig9": {"events": events, "instr": cnt._asdict(),
                 "instr_total": cnt.total,
                 "macro_energy_nj": energy.sequence_energy_j(cnt) * 1e9}}, [
        (spikes, ws[0]), (rasters[0], ws[1])]


def gate_skip_counts(raster: np.ndarray, block_b: int, granularity: int
                     ) -> np.ndarray:
    """(tiles, blocks) gate skips a (T, F, n) input raster gives at
    ``block_b`` lanes per tile and blocks of 128/G rows: per tile and block,
    the timesteps whose spikes there are all 0 (missing lanes silent)."""
    T, F, n = raster.shape
    tiles = -(-F // block_b)
    r = np.zeros((T, tiles * block_b, n), np.int64)
    r[:, :F] = raster
    r = r.reshape(T, tiles, block_b, n)
    bw = n if granularity == 1 else 128 // granularity
    return np.stack([(r[..., lo:lo + bw].sum(axis=(2, 3)) == 0).sum(axis=0)
                     for lo in range(0, n, bw)], axis=1).astype(np.int32)


def phase_conv(dev) -> dict:
    """Phase 9: impulse-mnist at full width on all five backends."""
    from repro_torch import kernels
    from repro_torch.configs.impulse_snn import MNIST
    from repro_torch.core import energy, mapping, pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch

    program = pipeline.compile_network(
        MNIST, snn.init_lenet_snn(SEED, MNIST, device=dev), domain="int",
        device=dev)
    x = torch.from_numpy(mnist_like_batch(MNIST_BATCH, SEED)[0]).to(dev)
    xs = pipeline.present_static(x, MNIST.timesteps)
    step_kw = {"cuda_sparse": {"gate_granularity": GATE_G},
               "cuda_events": {"event_crossover": CROSSOVER}}
    runs, out = {}, {"backends": {}}
    for backend in ("int_ref", "cuda", "cuda_sparse", "ref_events",
                    "cuda_events"):
        kw = step_kw.get(backend, {})
        pipeline.run_network(program, xs, backend, **kw)   # warm-up
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.run_network(program, xs, backend, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items() if v}
        name = {b: k for k, b in BACKEND_OF.items()}.get(backend)
        if name and launches.get(name, 0) != len(program.int_conv_stack) + 1:
            raise AssertionError(f"{backend} launched {launches}, not one "
                                 f"{name} per conv layer and one for the "
                                 "fc stack")
        if name is None and launches:
            raise AssertionError(f"{backend} launched kernels: {launches}")
        counts = pipeline.count_network_instructions(program, res.rasters)
        report = pipeline.sparsity_report(program, res.rasters)
        if tuple(report.instruction_counts()) != tuple(counts):
            raise AssertionError(f"{backend}: the report's instruction counts "
                                 "differ from the raster count")
        runs[backend] = res
        out["backends"][backend] = {
            "run_network_s": dt, "launches": launches,
            "instr": counts._asdict(), "instr_total": counts.total,
            "energy_per_inference_nj":
                energy.energy_per_inference_j(counts, MNIST_BATCH) * 1e9,
            "layer_sparsity": list(report.layer_sparsity),
            "skipped_row_fraction": report.skipped_row_fraction}
    ref = runs["int_ref"]
    if (tuple(ref.v_out.shape) != (MNIST_BATCH, 10)
            or not torch.isfinite(ref.logits).all()):
        raise AssertionError(f"bad readout {tuple(ref.v_out.shape)}")
    for backend, res in runs.items():
        same = (torch.equal(res.v_out, ref.v_out)
                and len(res.rasters) == len(ref.rasters) == 5
                and all(torch.equal(a, b) for a, b in
                        zip(res.rasters + res.v_final,
                            ref.rasters + ref.v_final)))
        if not same:
            raise AssertionError(f"{backend} differs from int_ref on the "
                                 "card")
        if out["backends"][backend]["instr"] != out["backends"]["int_ref"][
                "instr"]:
            raise AssertionError(f"{backend}: instruction counts differ")

    # gate counters: what int_ref's input rasters give at the kernel's tiles
    inputs = []
    for spec, r in zip(program.macro_stack, ref.rasters):
        if spec.kind == "conv":
            r = mapping.im2col_raster(r, spec.w.shape[0], spec.stride)
        inputs.append(r.reshape(r.shape[0], -1, spec.n_in).cpu().numpy())
    want = [gate_skip_counts(r, 8, GATE_G) for r in inputs]
    aux = runs["cuda_sparse"].aux
    got = [s[0] for s in aux["conv_skip_counts"]] + list(aux["skip_counts"])
    if len(got) != len(want) or not all(np.array_equal(a, b)
                                        for a, b in zip(got, want)):
        raise AssertionError("cuda_sparse gate counters differ from the "
                             "int_ref rasters' silent blocks")
    tally = [r.astype(np.int64).sum(axis=(0, 1)) for r in inputs]
    for backend in ("ref_events", "cuda_events"):
        aux = runs[backend].aux
        frames = [r.shape[0] * r.shape[1] for r in inputs]
        if aux["row_event_frames"] != frames or not all(
                np.array_equal(a, b) for a, b in zip(aux["row_events"],
                                                     tally)):
            raise AssertionError(f"{backend} row events differ from the "
                                 "int_ref raster tally")
    out["skipped_block_fraction"] = runs["cuda_sparse"].aux[
        "skipped_block_fraction"]
    out["conv_skipped_blocks"] = [int(s.sum()) for s in want[:2]]
    out["event_dense_fallbacks"] = runs["cuda_events"].aux.get(
        "event_dense_fallbacks")

    # the encoder on the CPU, same port code, same program and images
    spikes_cpu, v_cpu = pipeline.encode(host_program(program), xs.cpu())
    if not (torch.equal(spikes_cpu, ref.rasters[0].cpu()) and torch.equal(
            v_cpu.view(torch.int32), ref.v_final[0].cpu().view(torch.int32))):
        raise AssertionError("the encoder's spike maps or V on the card "
                             "differ from the CPU's")
    out["encoder_spike_rate"] = float(ref.rasters[0].float().mean())
    out["predictions"] = ref.v_out.argmax(dim=1)[:16].tolist()
    out["cuda_dense_launch_ms"] = dense_launch_ms(
        lambda: pipeline.run_network(program, xs, "cuda"))
    return out


def stream_equals_run(program, xs, backend, kw, ref) -> None:
    """Phase 10(a): ``xs`` (T, B, ...) streamed tick by tick and in
    megasteps of 3 + 3 + 4 on ``backend`` equals its `run_network` result
    ``ref``: readout V, every raster and every final V, conv maps
    included."""
    from repro_torch.core import pipeline
    T, B = xs.shape[:2]
    for blocks in ([1] * T, [3, 3, 4]):
        state = pipeline.init_stream_state(program, B, backend)
        rasters, t = [], 0
        for k in blocks:
            if blocks[0] == 1:
                state, out = pipeline.stream_step(program, state, xs[t],
                                                  backend, **kw)
                rasters.append([r[None] for r in out.rasters])
            else:
                state, out = pipeline.stream_megastep(program, state,
                                                      xs[t:t + k], backend,
                                                      **kw)
                rasters.append(out.rasters)
            t += k
        full = [torch.cat([r[i] for r in rasters])
                for i in range(len(rasters[0]))]
        same = (torch.equal(out.v_out, ref.v_out)
                and len(full) == len(ref.rasters) == 5
                and all(torch.equal(a, b) for a, b in
                        zip(list(state.vs) + full, ref.v_final + ref.rasters)))
        if not same:
            raise AssertionError(f"{backend}: streaming in blocks {blocks} "
                                 "differs from run_network on the card")


def fc_geometry(widths):
    """A weightless FC program of logical ``widths`` (its geometry alone,
    what `check_kernel_contracts` reads)."""
    from repro_torch.core.pipeline import LayerSpec, SNNProgram
    layers = [LayerSpec(kind="encoder", n_in=widths[0], n_out=widths[0],
                        state_shape=(widths[0],))]
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        last = j == len(widths) - 2
        layers.append(LayerSpec(kind="readout" if last else "fc", n_in=a,
                                n_out=b, threshold=None if last else 5,
                                leak=None if last else 0, state_shape=(b,)))
    return SNNProgram(cfg=None, neuron="rmp", timesteps=10,
                      layers=tuple(layers))


def phase_contracts_vs_launch(ops, dev, n: int = 40) -> dict:
    """Phase 10(e): ``n`` seeded stacks per CUDA mode, 1 to 18 layers of
    widths that straddle `SMEM_LIMIT`: `check_kernel_contracts` accepts
    exactly the stacks whose launch succeeds, and the wrapper raises
    `KernelRefused` naming the same rule for exactly the refused ones."""
    from repro_torch.analysis import ContractError, check_kernel_contracts
    from repro_torch.kernels.fused_snn_net.kernel import KernelRefused
    rng = np.random.default_rng(SEED + 10)
    choices = np.array((14, 84, 126, 128, 686, 1000, 2000, 4000, 12_000))
    out = {}
    for backend, mode in (("cuda", "dense"), ("cuda_sparse", "gated"),
                          ("cuda_events", "events")):
        launched, refused = 0, {}
        for _ in range(n):
            L = int(rng.integers(1, 19))
            top = rng.choice((130, 700, 2000, 12_000))
            widths = tuple(int(x) for x in rng.choice(choices[choices <= top],
                                                      L + 1))
            T = int(rng.choice((5, 10, 17)))
            B = int(rng.choice((1, 32, 300)))
            block_b = int(rng.choice((8, 64, 256)))
            G = int(rng.choice((1, 8))) if mode == "gated" else 1
            try:
                check_kernel_contracts(fc_geometry(widths), backend,
                                       frames=T, batch=B, block_b=block_b,
                                       gate_granularity=G)
                want = None
            except ContractError as e:
                want = e.contract
            spikes = torch.from_numpy((rng.random((T, B, widths[0])) < 0.2)
                                      .astype(np.int8)).to(dev)
            ws = [torch.ones((a, b), dtype=torch.int8, device=dev)
                  for a, b in zip(widths[:-1], widths[1:])]
            k = len(ws) - 1
            try:
                ops.fused_snn_net(spikes, ws, thresholds=(5,) * k,
                                  leaks=(0,) * k, block_b=block_b,
                                  use_sparse=mode == "gated",
                                  gate_granularity=G,
                                  use_events=mode == "events")
                torch.cuda.synchronize()
                got = None
            except KernelRefused as e:
                got = e.contract
            if got != want:
                raise AssertionError(
                    f"{backend}: widths {widths}, T={T}, B={B}, block_b="
                    f"{block_b}, G={G}: the contract pass says {want}, the "
                    f"launch {got}")
            if got is None:
                launched += 1
            else:
                refused[got] = refused.get(got, 0) + 1
        if not launched or not refused:
            raise AssertionError(f"{backend}: the sweep did not both launch "
                                 f"and refuse ({launched}, {refused})")
        out[backend] = {"launched": launched, "refused": refused}
    return out


def phase_conv_serving(dev, ops) -> dict:
    """Phase 10: impulse-mnist streamed and served at full width."""
    from repro_torch import kernels
    from repro_torch.configs.impulse_snn import MNIST
    from repro_torch.core import pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch
    from repro_torch.launch.serve_snn import image_requests
    from repro_torch.serve import SNNServeEngine

    program = pipeline.compile_network(
        MNIST, snn.init_lenet_snn(SEED, MNIST, device=dev), domain="int",
        device=dev)
    images = mnist_like_batch(MNIST_BATCH, SEED)[0]
    T = MNIST.timesteps
    step_kw = {"cuda_sparse": {"gate_granularity": GATE_G},
               "cuda_events": {"event_crossover": CROSSOVER}}
    out = {"streaming": {}, "engines": {}}

    # (a) streaming: 8 images, 10 ticks, on every backend
    xs = pipeline.present_static(torch.from_numpy(images[:8]).to(dev), T)
    base = pipeline.run_network(program, xs, "int_ref")
    for backend in INT_BACKENDS:
        kw = step_kw.get(backend, {})
        ref = pipeline.run_network(program, xs, backend, **kw)
        if not (torch.equal(ref.v_out, base.v_out) and all(
                torch.equal(a, b) for a, b in zip(ref.rasters, base.rasters))):
            raise AssertionError(f"{backend} run_network != int_ref")
        t0 = time.perf_counter()
        stream_equals_run(program, xs, backend, kw, ref)
        torch.cuda.synchronize()
        out["streaming"][backend] = {"s": time.perf_counter() - t0}

    # (b) serving: 64 requests of 10 frames, arrivals 3 frames apart
    def requests():
        return image_requests(images, T, stagger=3)

    def drain(backend, K=5, window=None):
        eng = SNNServeEngine(program, backend=backend, batch_slots=32,
                             pages=2, megastep=K, device=dev,
                             step_kw=step_kw.get(backend))
        for r in requests():
            eng.submit(r)
        torch.cuda.synchronize()
        with window or contextlib.nullcontext():
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return sorted(done, key=lambda r: r.rid), dt, eng

    ref, dt_ref, ref_eng = drain("int_ref")
    if len(ref) != MNIST_BATCH or any(r.ticks != T for r in ref):
        raise AssertionError("the int_ref engine did not serve 64 x 10 frames")
    for r in ref:                                   # isolated runs
        iso = pipeline.run_network(program, pipeline.present_static(
            torch.from_numpy(images[r.rid:r.rid + 1]).to(dev), T), "int_ref")
        rep = pipeline.sparsity_report(program, iso.rasters)
        if (not np.array_equal(r.v_out, iso.v_out[0].cpu().numpy())
                or not np.array_equal(r.logits, iso.logits[0].cpu().numpy())
                or r.report.events != rep.events
                or r.report.layer_frames != rep.layer_frames):
            raise AssertionError(f"request {r.rid} != its isolated run")
    frames = sum(r.ticks for r in ref)
    out["frames"] = frames
    out["int_ref"] = {"s": dt_ref, "frames_per_s": frames / dt_ref,
                      "max_safe_ticks": ref_eng.max_safe_ticks}
    for backend in ("cuda", "cuda_sparse", "cuda_events"):
        drain(backend)                               # warm-up, not counted
        kernels.reset_launch_counts()
        served, dt, eng = drain(backend)
        launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items() if v}
        bad = [a.rid for a, b in zip(served, ref) if not same_request(a, b)]
        if len(served) != MNIST_BATCH or bad or any(
                a.report.layer_frames != b.report.layer_frames
                for a, b in zip(served, ref)):
            raise AssertionError(f"{backend} conv engine != int_ref engine "
                                 f"(requests {bad})")
        name = {b: k for k, b in BACKEND_OF.items()}[backend]
        if launches.get(name, 0) != 3 * eng.dispatches or set(launches) != {
                name}:
            raise AssertionError(f"{backend}: launches {launches} in "
                                 f"{eng.dispatches} megasteps, not 3 {name} "
                                 "each")
        row = {"s": dt, "frames_per_s": frames / dt, "launches": launches,
               "megasteps": eng.dispatches,
               "launches_per_megastep": launches[name] / eng.dispatches,
               "max_safe_ticks": eng.max_safe_ticks,
               "skipped_row_fraction":
                   eng.aggregate_report().skipped_row_fraction}
        if backend == "cuda_events":
            _, _, host = drain("ref_events")
            got, want = eng.device_event_stats(), host.device_event_stats()
            tally = eng.aggregate_report().row_events
            if got.frames != want.frames or not all(
                    np.array_equal(a, b) and np.array_equal(a, c)
                    for a, b, c in zip(got.row_events, want.row_events,
                                       tally)):
                raise AssertionError("the conv cuda_events ledger differs "
                                     "from ref_events' or the raster tally")
            row["device_skipped_row_fraction"] = \
                eng.device_skipped_row_fraction()
            row["dense_fallbacks"] = list(got.dense_fallbacks)
        if backend == "cuda":
            row["profile"] = profile_drain(drain, backend)
        out["engines"][backend] = row

    # (c) finishes inside a block: K = 4 against int_ref at K = 4
    ref4, _, _ = drain("int_ref", 4)
    got4, dt4, eng4 = drain("cuda", 4)
    bad = [a.rid for a, b in zip(got4, ref4) if not same_request(a, b)]
    if bad or any(a.finish_clock != b.finish_clock
                  for a, b in zip(got4, ref4)):
        raise AssertionError(f"cuda at K=4 != int_ref at K=4 (requests {bad})")
    if any(not np.array_equal(a.v_out, b.v_out) for a, b in zip(got4, ref)):
        raise AssertionError("the K=4 engine's outputs differ from K=5's")
    out["cuda_k4"] = {"s": dt4, "frames_per_s": frames / dt4,
                      "megasteps": eng4.dispatches}
    out["contracts"] = phase_contracts_vs_launch(ops, dev)
    out["predictions"] = [int(np.argmax(r.logits)) for r in ref[:16]]
    return out


def phase_macro_oracle(dev) -> dict:
    """Phase 11: the bit-level macro oracle (`bitmacro`, on the host)
    against the `cuda` backend on the card, on wrap programs with weights
    drawn on the card: one impulse-mnist image and one 6-word IMDB
    request."""
    from repro_torch import kernels
    from repro_torch.configs.impulse_snn import IMDB, MNIST
    from repro_torch.core import isa, pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch
    from repro_torch.launch.serve_snn import make_requests
    out = {}
    mnist = pipeline.compile_network(
        MNIST, snn.init_lenet_snn(SEED, MNIST, device=dev), domain="int",
        clamp_mode="wrap", device=dev)
    imdb = pipeline.compile_network(IMDB, snn.init_fc_snn(SEED, IMDB),
                                    domain="int", clamp_mode="wrap",
                                    device=dev)
    x = torch.from_numpy(mnist_like_batch(1, SEED)[0]).to(dev)
    words = make_requests(imdb, 1, 6, IMDB.timesteps, 0.85, SEED)[0].frames
    cases = {"impulse-mnist": (mnist, pipeline.present_static(
                 x, MNIST.timesteps)),
             "impulse-imdb": (imdb, torch.from_numpy(words[:, None]).to(dev))}
    for name, (program, xs) in cases.items():
        kernels.reset_launch_counts()
        card = pipeline.run_network(program, xs, "cuda")
        torch.cuda.synchronize()
        if kernels.LAUNCH_COUNTS["fused_snn_net"] != len(
                program.int_conv_stack) + 1:
            raise AssertionError(f"{name}: cuda launched "
                                 f"{kernels.LAUNCH_COUNTS}")
        t0 = time.perf_counter()
        res = pipeline.run_network(program, xs, "bitmacro")
        dt = time.perf_counter() - t0
        same = (torch.equal(res.v_out, card.v_out)
                and torch.equal(res.logits, card.logits)
                and len(res.rasters) == len(card.rasters)
                and all(torch.equal(a, b) for a, b in
                        zip(res.rasters + res.v_final,
                            card.rasters + card.v_final)))
        if not same:
            raise AssertionError(f"{name}: bitmacro != cuda on the card")
        counts = res.aux["macro_counts"]
        ro = program.macro_stack[-1]
        readout = isa.count_layer_instructions(card.rasters[-1], ro.n_in,
                                               ro.n_out, "none")
        total = pipeline.count_network_instructions(program, card.rasters)
        if tuple(counts + readout) != tuple(total):
            raise AssertionError(f"{name}: macro counts {counts} + readout "
                                 f"{readout} != raster count {total}")
        out[name] = {"bitmacro_s": dt, "frames": int(xs.shape[0]),
                     "macro_counts": counts._asdict(),
                     "readout_counts": readout._asdict()}
    return out


# ---------------------------------------------------------------------------
# Phase 12: train the paper's IMDB SNN and deploy it
# ---------------------------------------------------------------------------

def imdb_train_cfg():
    """`benchmarks/fig9_accuracy.py`'s IMDB config: threshold init 0.5."""
    from repro_torch.configs.impulse_snn import IMDB
    return dataclasses.replace(IMDB, spiking=dataclasses.replace(
        IMDB.spiking, threshold=0.5))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 on the host (0 when both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den else num


def one_train_step(params_np: dict, x, y, cfg, device) -> tuple:
    """One `make_train_step` step of `sentiment_loss` on ``device`` from
    the numpy weights, with SGD at lr 1 and no clip, so the step's change
    of each parameter (old - new) is its gradient: the loss, the step's
    ``grad_norm``, the gradients, and the float program's rasters on the
    batch."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import pipeline, snn
    from repro_torch.optim import sgd
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves
    params = snn.params_from_arrays(params_np, device)
    opt = sgd(1.0, momentum=0.0)
    step = make_train_step(
        RunConfig(model=None, shape=None), opt,
        lambda p, b: snn.sentiment_loss(p, b["x"], b["y"], cfg,
                                        device=device),
        max_grad_norm=math.inf)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    new, metrics = step(state, {"x": torch.from_numpy(x).to(device),
                                "y": torch.from_numpy(y).to(device)})
    grads = [a - b for a, b in zip(tree_leaves(params),
                                   tree_leaves(new.params))]
    with torch.no_grad():
        prog = pipeline.compile_network(cfg, params, device=device)
        res = pipeline.run_network(prog, pipeline.present_words(
            torch.as_tensor(x, device=device), cfg.timesteps), "float",
            collect_rasters=True)
    return metrics["loss"], metrics["grad_norm"], grads, res.rasters


def phase_train_step_vs_cpu(dev, batch: int = 128, words: int = 12) -> dict:
    """Phase 12(a): one train step of `sentiment_loss` at full width on the
    card and through the same port code on the CPU, from the same seeded
    numpy weights (the port's own `init_fc_snn`: the card's machine has no
    JAX to seed them): the loss, the gradient norm and every gradient;
    then the float backend on the int program of those weights against
    `int_ref` and `cuda` on the card."""
    from repro_torch.core import pipeline, snn
    from repro_torch.data.synthetic import (make_sentiment_vocab,
                                            sentiment_batch)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float path needs f32")
    cfg = imdb_train_cfg()
    params_np = {k: ([{"w": ly["w"].numpy()} for ly in v] if k == "layers"
                     else v.numpy())
                 for k, v in snn.init_fc_snn(SEED, cfg).items()}
    x, y = sentiment_batch(make_sentiment_vocab(0), batch, words, seed=0)
    card = one_train_step(params_np, x, y, cfg, dev)
    host = one_train_step(params_np, x, y, cfg, torch.device("cpu"))
    loss_rel = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    norm_rel = abs(float(card[1]) - float(host[1])) / abs(float(host[1]))
    grad_rel = [rel_l2(a, b) for a, b in zip(card[2], host[2])]
    flips = [int((a.cpu() != b).sum()) for a, b in zip(card[3], host[3])]
    if (loss_rel > TRAIN_LOSS_RTOL or norm_rel > TRAIN_GRAD_RL2
            or max(grad_rel) > TRAIN_GRAD_RL2):
        raise AssertionError(
            f"the card's loss / gradients differ from the CPU's: loss "
            f"{loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}), grad norm "
            f"{norm_rel:.3e} and grads {grad_rel} (tol {TRAIN_GRAD_RL2}); "
            f"raster sites that differ: {flips}")
    prog = pipeline.compile_network(cfg, params_np, domain="int", device=dev)
    xs = pipeline.present_words(torch.from_numpy(x).to(dev), cfg.timesteps)
    f = pipeline.run_network(prog, xs, "float", collect_rasters=True)
    for backend in ("int_ref", "cuda"):
        r = pipeline.run_network(prog, xs, backend)
        same = (torch.equal(f.logits, r.logits) and all(
            torch.equal(a, b.float()) for a, b in zip(f.rasters, r.rasters))
            and all(torch.equal(a, b.float())
                    for a, b in zip(f.v_final, r.v_final)))
        if not same:
            raise AssertionError(f"the float backend on the int program != "
                                 f"{backend} on the card")
    return {"loss_card": float(card[0]), "loss_cpu": float(host[0]),
            "loss_rel_diff": loss_rel, "grad_norm_rel_diff": norm_rel,
            "grad_rel_l2": grad_rel, "raster_sites_differing": flips,
            "raster_sites": [int(r.numel()) for r in host[3]],
            "float_on_int_program": "== int_ref == cuda"}


def profile_step(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the device's
    busy ms and idle share, and the number of device operations (kernels
    and copies) it ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = device_events(prof)
    busy = sum(ms for _, ms in ops)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_ops": len(ops),
            "kernels": sum(1 for name, _ in ops if not name.startswith("Mem"))}


def timed_steps(dev, step, state, batch_of, steps: int, *,
                profile: bool = True, at_compare=None) -> dict:
    """``steps`` calls of ``step`` (eager, or compiled: a graph replay
    after the first call, which captures) from ``state``, batch s =
    ``batch_of(s)`` on the card before its step and each step ending in
    `torch.cuda.synchronize()`: the losses and gradient norms, ms a step
    and the median of the last half, ``at_compare(state)`` after
    COMPARE_STEPS steps, a profiled further step (for a compiled step one
    replay) and the run's peak bytes allocated (its start state included,
    other live tensors not) and the peak reserved. The state stays in the
    result."""
    torch.cuda.synchronize()
    others = torch.cuda.memory_allocated() - tree_bytes(state)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for s in range(steps):
        batch = batch_of(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if s + 1 == COMPARE_STEPS and at_compare is not None:
            at_compare(state)
    out = {"steps": steps, "losses": losses, "grad_norms": norms,
           "ms_per_step": ms,
           "median_ms_per_step": float(np.median(ms[steps // 2:]))}
    if profile:
        batch = batch_of(steps)
        out["profiled_step"] = profile_step(lambda: step(state, batch))
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - others
    out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    out["state"] = state
    return out


def state_differences(x, y) -> dict:
    """{leaf path: largest |x - y|} over the leaves of two train states
    that differ."""
    from repro_torch.tree import tree_flatten_with_paths
    out = {}
    for (path, a), (_, b) in zip(tree_flatten_with_paths(x),
                                 tree_flatten_with_paths(y)):
        if not torch.equal(a, b):
            out["/".join(map(str, path))] = float(
                (a.double() - b.double()).abs().max())
    return out


def metric_differences(x: dict, y: dict) -> dict:
    """{metric[i]: |x - y|} over the first COMPARE_STEPS losses and
    gradient norms of two `timed_steps` runs that differ."""
    return {f"{key}[{i}]": abs(x[key][i] - y[key][i])
            for key in ("losses", "grad_norms") for i in range(COMPARE_STEPS)
            if x[key][i] != y[key][i]}


def eager_vs_compiled(dev, step, start: list, batch_of, steps: int) -> dict:
    """The eager ``step`` and `compile_train_step` of it from one state,
    the `TrainState` on the card that ``start`` holds (no run changes it:
    an eager step builds new tensors, the compiled one copies it into its
    buffers), over one batch stream: ``eager_ref`` (COMPARE_STEPS steps,
    not profiled), then ``compiled`` and ``eager`` (``steps`` steps each;
    the eager run takes the state out of ``start``, so that it is freed
    after its first step as in an eager loop, and keeps its own). After COMPARE_STEPS steps each is held to
    ``eager_ref`` on the card: the compiled run must equal it bit for bit
    (state leaves, losses, gradient norms) where the two eager runs agree;
    where they differ (an atomic sum in a backward), each differing value
    of the compiled run must lie within twice the eager runs' own
    difference, and none may differ where they agree. A capture error
    raises: there is no eager fallback."""
    from repro_torch.train import compile_train_step
    runs = {"eager_ref": timed_steps(dev, step, start[0], batch_of,
                                     COMPARE_STEPS, profile=False)}
    ref = runs["eager_ref"].pop("state")
    leaf_diffs = {}
    for label in ("compiled", "eager"):
        free_cuda()
        fn = compile_train_step(step, dev) if label == "compiled" else step
        runs[label] = timed_steps(
            dev, fn, start.pop() if label == "eager" else start[0],
            batch_of, steps,
            at_compare=lambda state, label=label: leaf_diffs.__setitem__(
                label, state_differences(state, ref)))
        if label == "compiled":
            # no reference to the graph may outlive ``fn``: its private
            # memory pool is freed with it
            if next(iter(fn.graphs.values()))[1].graph is None:
                raise AssertionError("the compiled train step captured no "
                                     "CUDA graph")
            del runs[label]["state"]
        del fn
    del ref
    own = {**leaf_diffs["eager"],
           **metric_differences(runs["eager"], runs["eager_ref"])}
    got = {**leaf_diffs["compiled"],
           **metric_differences(runs["compiled"], runs["eager_ref"])}
    bad = sorted(set(got) - set(own)) + [k for k in got
                                         if k in own and got[k] > 2 * own[k]]
    compare = {"steps": COMPARE_STEPS, "bit_for_bit": not got,
               "eager_repeat_differs": own, "compiled_differs": got}
    if bad:
        raise AssertionError(f"the compiled train step != the eager one "
                             f"beyond the eager runs' own difference at "
                             f"{bad}: {compare}")
    return {"compare": compare, **runs}


def train_run(dev, loss_fn, params, batch_fn, steps: int, *,
              log_every: int = 1, ckpt_dir=None, start=None, step=None):
    """``steps`` AdamW steps (lr 5e-3, no decay, no clip: the Fig. 9
    benchmark's optimizer) through `make_train_step`, compiled
    (`compile_train_step`: one CUDA graph a step), and `train_loop`, batch
    s from ``batch_fn(s)``; ``start`` continues a `TrainState` and
    ``step`` a compiled step (its state is its buffers)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.optim import adamw
    from repro_torch.train import (LoopConfig, TrainState, compile_train_step,
                                   make_train_step, train_loop)
    opt = adamw(lambda s: TRAIN_LR, weight_decay=0.0)
    if step is None:
        step = compile_train_step(make_train_step(
            RunConfig(model=None, shape=None), opt, loss_fn,
            max_grad_norm=math.inf), dev)
    state = start if start is not None else TrainState(
        params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                              device=dev))
    loader = ShardedLoader(lambda s, i, n: batch_fn(s),
                           start_step=int(state.step))
    res = train_loop(step, state, loader,
                     LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                ckpt_every=5, log_every=log_every),
                     device_put_fn=lambda b: {k: torch.from_numpy(v).to(dev)
                                              for k, v in b.items()})
    return res, step


def accuracy(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float(((logits > 0) == (y > 0.5)).float().mean())


def phase_snn_compiled(dev) -> dict:
    """Phase 12(b), first: the IMDB SNN's train step at phase 12(b)'s
    settings (AdamW lr 5e-3 without decay, no clip, B = 128, 12 words,
    batch s from seed s) eager and compiled from one state (seed 0) over
    one batch stream (`eager_vs_compiled`, SNN_COMPARE_STEPS steps): equal
    bit for bit, each run's ms a step, profiled step and peak bytes."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import snn
    from repro_torch.data.synthetic import (make_sentiment_vocab,
                                            sentiment_batch)
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, make_train_step
    cfg = imdb_train_cfg()
    ds = make_sentiment_vocab(0)
    opt = adamw(lambda s: TRAIN_LR, weight_decay=0.0)
    step = make_train_step(RunConfig(model=None, shape=None), opt,
                           lambda p, b: snn.sentiment_loss(
                               p, b["x"], b["y"], cfg, device=dev),
                           max_grad_norm=math.inf)
    params = snn.init_fc_snn(SEED, cfg, device=dev)
    start = [TrainState(params, opt.init(params),
                        torch.zeros((), dtype=torch.int32, device=dev))]
    del params

    def batch_of(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in zip(
            ("x", "y"), sentiment_batch(ds, TRAIN_BATCH, TRAIN_WORDS,
                                        seed=s))}
    out = eager_vs_compiled(dev, step, start, batch_of, SNN_COMPARE_STEPS)
    del out["eager"]["state"]
    return out


def phase_train(dev, deadline: float) -> dict:
    """Phase 12(b): the IMDB SNN trained at `benchmarks/fig9_accuracy.py`'s
    settings (threshold 0.5, batch 128, 12 words, AdamW lr 5e-3 without
    decay, 400 steps, batch s from seed s) through the compiled step, then
    the LSTM baseline the same way; the Fig. 9b row on the eval batch
    (1,024 reviews, seed 99,991). The steps are cut, and the cut printed,
    if 400 would not end before ``deadline`` (a `time.perf_counter`
    value)."""
    from repro_torch.core import snn
    from repro_torch.data.synthetic import (make_sentiment_vocab,
                                            sentiment_batch)
    from repro_torch.models import lstm_baseline as lstm
    from repro_torch.tree import tree_map
    cfg = imdb_train_cfg()
    ds = make_sentiment_vocab(0)

    def batch_fn(s):
        return dict(zip(("x", "y"), sentiment_batch(ds, TRAIN_BATCH,
                                                    TRAIN_WORDS, seed=s)))

    def snn_loss(p, b):
        return snn.sentiment_loss(p, b["x"], b["y"], cfg, device=dev)

    params = snn.init_fc_snn(SEED, cfg, device=dev)
    n_snn = snn.param_count(params)
    t0 = time.perf_counter()
    first, step = train_run(dev, snn_loss, params, batch_fn, 10)
    per_step = float(np.median([m["sec_per_step"]
                                for m in first.metrics_history]))
    steps = min(TRAIN_STEPS, 10 + int((deadline - time.perf_counter())
                                      / per_step))
    if steps < 50:
        raise AssertionError(f"only {steps} training steps fit the time left")
    if steps < TRAIN_STEPS:
        print(f"[phase 12] training cut to {steps} of {TRAIN_STEPS} steps "
              f"({per_step * 1e3:.1f} ms a step) to end inside the time "
              "limit")
    res, _ = train_run(dev, snn_loss, params, batch_fn, steps,
                       start=first.state, step=step)
    train_s = time.perf_counter() - t0
    hist = first.metrics_history + res.metrics_history
    losses = [m["loss"] for m in hist]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{len(losses)} logged losses of {steps} steps, "
                             f"finite: {np.isfinite(losses).all()}")
    head, tail = float(np.mean(losses[:25])), float(np.mean(losses[-25:]))
    if not tail < head:
        raise AssertionError(f"the loss did not fall: first 25 steps "
                             f"{head:.4f}, last 25 {tail:.4f}")
    # the compiled step's state is its buffers, which the profiled step
    # advances
    trained = tree_map(lambda x: x.clone(), res.state.params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_fn(0).items()}
    prof = profile_step(lambda: step(res.state, batch))
    xb, yb = sentiment_batch(ds, EVAL_BATCH, TRAIN_WORDS, seed=EVAL_SEED)
    x, y = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
    with torch.no_grad():
        logits, _ = snn.sentiment_apply(trained, x, cfg, device=dev)
    acc_snn = accuracy(logits, y)

    lp = lstm.init_lstm(SEED + 1, device=dev)
    n_lstm = lstm.param_count(lp)
    t1 = time.perf_counter()
    lres, _ = train_run(dev, lambda p, b: lstm.lstm_loss(p, b["x"], b["y"]),
                        lp, batch_fn, steps, log_every=50)
    lstm_s = time.perf_counter() - t1
    with torch.no_grad():
        acc_lstm = accuracy(lstm.lstm_apply(lres.state.params, x), y)
    return {
        "steps": steps, "cut": steps < TRAIN_STEPS,
        "loss_every_50": {i + 1: losses[i] for i in range(0, steps, 50)},
        "loss_last": losses[-1], "loss_first25": head, "loss_last25": tail,
        "median_ms_per_step": 1e3 * float(np.median(
            [m["sec_per_step"] for m in hist[1:]])),
        "train_s": train_s, "profiled_step": prof,
        "fig9b": {"snn_params": n_snn, "lstm_params": n_lstm,
                  "ratio": n_lstm / n_snn, "snn_acc": acc_snn,
                  "lstm_acc": acc_lstm,
                  "gap_pp": 100 * (acc_lstm - acc_snn), "lstm_s": lstm_s,
                  "lstm_last_loss": lres.metrics_history[-1]["loss"]},
        "params": trained, "eval": (x, y, logits)}


def print_compiled(tag: str, res: dict, card: str) -> None:
    """`eager_vs_compiled`'s runs: ms a step (median of the last half;
    the compiled run's first step is its capture), the profiled step's
    idle share and device ops (one graph replay for the compiled step),
    the peak bytes, and the comparison."""
    for label in ("eager", "compiled"):
        r, p = res[label], res[label]["profiled_step"]
        print(f"{tag} {label} step: median {r['median_ms_per_step']:.3f} ms "
              f"a step (last {r['steps'] - r['steps'] // 2} of "
              f"{r['steps']}; first {r['ms_per_step'][0]:.1f} ms); profiled "
              f"step {p['wall_ms']:.3f} ms, device busy "
              f"{p['device_busy_ms']:.3f} ms, idle "
              f"{p['device_idle_share']:.4f}, {p['device_ops']} device ops; "
              f"peak {r['peak_bytes']} bytes allocated, "
              f"{r['peak_reserved_bytes']} reserved ({card})")
    c = res["compare"]
    print(f"{tag} compiled vs eager after {c['steps']} steps from one state "
          f"and batch stream: "
          + ("bit for bit" if c["bit_for_bit"] else
             "within twice the eager runs' own difference")
          + f" (eager repeat differs at {len(c['eager_repeat_differs'])} "
          f"values, compiled at {len(c['compiled_differs'])}): "
          f"{json.dumps(c)}")
    print(f"{tag} runs: " + json.dumps({k: v for k, v in res.items()
                                         if k != "compare"}))


def phase_deploy(dev, params, x, y, float_logits) -> dict:
    """Phase 12(c): the trained network compiled to the int domain and run
    on the eval batch through every backend, each equal to `int_ref` bit
    for bit, with the launch counts of this deployment alone; then 64 eval
    reviews served on `cuda`, each equal to an `int_ref` engine."""
    from repro_torch import kernels
    from repro_torch.core import energy, pipeline
    from repro_torch.serve import SNNRequest, SNNServeEngine
    cfg = imdb_train_cfg()
    prog = pipeline.compile_network(cfg, params, domain="int", device=dev)
    xs = pipeline.present_words(x, cfg.timesteps)
    kernels.reset_launch_counts()
    ref = pipeline.run_network(prog, xs, "int_ref")
    runs = {"cuda": pipeline.run_network(prog, xs, "cuda"),
            "cuda_sparse": pipeline.run_network(prog, xs, "cuda_sparse",
                                                gate_granularity=GATE_G),
            "ref_events": pipeline.run_network(prog, xs, "ref_events"),
            "cuda_events": pipeline.run_network(prog, xs, "cuda_events",
                                                event_crossover=CROSSOVER),
            "float": pipeline.run_network(prog, xs, "float",
                                          collect_rasters=True)}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    for name in BACKEND_OF:
        if launches[name] < 1:
            raise AssertionError(f"deploying the trained net never launched "
                                 f"{name}")
    for backend, r in runs.items():
        same = (torch.equal(r.logits, ref.logits)
                and len(r.rasters) == len(ref.rasters) and all(
                    torch.equal(a.to(b.dtype), b)
                    for a, b in zip(r.rasters, ref.rasters))
                and all(torch.equal(a.to(b.dtype), b)
                        for a, b in zip(r.v_final, ref.v_final)))
        if not same:
            raise AssertionError(f"the trained program on {backend} != "
                                 "int_ref (logits, rasters or final V)")
    logits = ref.logits[:, 0]
    counts = pipeline.count_network_instructions(prog, ref.rasters)
    e = energy.snn_energy_j(counts)
    n = x.shape[0]

    def requests():
        frames = xs[:, :SERVE_REVIEWS].cpu().numpy()
        return [SNNRequest(rid=i, frames=frames[:, i].copy())
                for i in range(SERVE_REVIEWS)]

    def serve(backend):
        eng = SNNServeEngine(prog, backend=backend, batch_slots=32, pages=2,
                             megastep=cfg.timesteps, device=dev)
        for r in requests():
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = sorted(eng.run_until_drained(), key=lambda r: r.rid)
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0, eng

    want, ref_s, _ = serve("int_ref")
    serve("cuda")                                  # warm-up
    got, cuda_s, eng = serve("cuda")
    bad = [a.rid for a, b in zip(got, want) if not same_request(a, b)]
    if len(got) != SERVE_REVIEWS or bad:
        raise AssertionError(f"served trained reviews {bad} on cuda != the "
                             "int_ref engine")
    frames = sum(r.ticks for r in got)
    return {
        "int_acc": accuracy(logits, y),
        "agreement_with_float": float(((logits > 0) == (float_logits > 0))
                                      .float().mean()),
        "input_sparsity": [1.0 - float(r.float().mean())
                           for r in ref.rasters],
        "instructions_per_inference": {
            k: v / n for k, v in counts._asdict().items()},
        "nj_per_inference": e / n * 1e9,
        "backends_equal_int_ref": sorted(runs),
        "launches": launches,
        "served": {"reviews": SERVE_REVIEWS, "frames": frames,
                   "cuda_frames_per_s": frames / cuda_s,
                   "int_ref_frames_per_s": frames / ref_s,
                   "max_safe_ticks": eng.max_safe_ticks}}


def phase_checkpoint(dev) -> dict:
    """Phase 12(d): a `train_loop` with a checkpoint directory stopped
    after 10 steps and restarted to 15 from a fresh state: it resumes from
    step 10 with the saved parameters bit for bit; an uninterrupted
    15-step run is compared too."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import snn
    from repro_torch.data.synthetic import (make_sentiment_vocab,
                                            sentiment_batch)
    cfg = imdb_train_cfg()
    ds = make_sentiment_vocab(0)

    def batch_fn(s):
        return dict(zip(("x", "y"), sentiment_batch(ds, TRAIN_BATCH,
                                                    TRAIN_WORDS, seed=s)))

    def loss(p, b):
        return snn.sentiment_loss(p, b["x"], b["y"], cfg, device=dev)

    def fresh():
        return snn.init_fc_snn(SEED, cfg, device=dev)

    with tempfile.TemporaryDirectory() as d:
        first, _ = train_run(dev, loss, fresh(), batch_fn, 10, ckpt_dir=d)
        _, saved = CheckpointManager(d).restore(like=first.state)
        second, _ = train_run(dev, loss, fresh(), batch_fn, 15, ckpt_dir=d)
        steps = CheckpointManager(d).all_steps()
    whole, _ = train_run(dev, loss, fresh(), batch_fn, 15)
    from repro_torch.tree import tree_leaves
    exact = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(saved), tree_leaves(first.state)))
    if second.resumed_from != 10 or int(second.state.step) != 15 or not exact:
        raise AssertionError(f"checkpoint restart: resumed_from "
                             f"{second.resumed_from}, step "
                             f"{int(second.state.step)}, restored == saved: "
                             f"{exact}")
    return {"resumed_from": second.resumed_from, "saved_steps": steps,
            "restored_equals_saved": exact,
            "resumed_equals_uninterrupted": all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(second.state.params),
                    tree_leaves(whole.state.params)))}


def phase_lenet_train(dev) -> dict:
    """Phase 12(e): 12 `lenet_loss` steps of impulse-mnist at batch 16
    (batch s = `mnist_like_batch(16, s)`), every loss finite; the trained
    conv program on `cuda` equal to `int_ref` bit for bit."""
    from repro_torch.configs.impulse_snn import MNIST
    from repro_torch.core import pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch

    def batch_fn(s):
        return dict(zip(("x", "y"), mnist_like_batch(LENET_BATCH, seed=s)))

    t0 = time.perf_counter()
    res, _ = train_run(dev, lambda p, b: snn.lenet_loss(
        p, b["x"], b["y"], MNIST, device=dev),
        snn.init_lenet_snn(SEED, MNIST, device=dev), batch_fn, LENET_STEPS)
    losses = [m["loss"] for m in res.metrics_history]
    if len(losses) != LENET_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"LeNet losses {losses}")
    prog = pipeline.compile_network(MNIST, res.state.params, domain="int",
                                    device=dev)
    xs = pipeline.present_static(torch.from_numpy(
        batch_fn(1000)["x"]).to(dev), MNIST.timesteps)
    a = pipeline.run_network(prog, xs, "cuda")
    b = pipeline.run_network(prog, xs, "int_ref")
    if not (torch.equal(a.v_out, b.v_out) and all(
            torch.equal(p, q) for p, q in zip(a.rasters, b.rasters))):
        raise AssertionError("the trained conv program on cuda != int_ref")
    return {"losses": losses, "s": time.perf_counter() - t0,
            "ms_per_step": [1e3 * m["sec_per_step"]
                            for m in res.metrics_history],
            "cuda_equals_int_ref": True}


def dispatch_engine(mode: str):
    """The engine class and double-buffer flag of a dispatch mode: the
    eager `stream_megastep` dispatch, the compiled one (CUDA graphs), or
    the compiled one with the double-buffered upload."""
    from repro_torch.serve import SNNServeEngine

    class EagerEngine(SNNServeEngine):
        _compiled = False
    return {"eager": (EagerEngine, False), "graphed": (SNNServeEngine, False),
            "graphed_db": (SNNServeEngine, True)}[mode]


def compiled_drains(dev) -> dict:
    """Phase 13's two drains: phase 3's IMDB drain (64 x 60 frames, 32
    slots x 2 pages, K = 10) and phase 10's conv drain (64 impulse-mnist
    images x 10 frames arriving 3 frames apart, K = 5), as (program,
    requests, engine options)."""
    from repro_torch.configs.impulse_snn import IMDB, MNIST
    from repro_torch.core import pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch
    from repro_torch.launch.serve_snn import image_requests, make_requests

    imdb = pipeline.compile_network(IMDB, snn.init_fc_snn(SEED, IMDB),
                                    domain="int", device=dev)
    mnist = pipeline.compile_network(
        MNIST, snn.init_lenet_snn(SEED, MNIST, device=dev), domain="int",
        device=dev)
    images = mnist_like_batch(MNIST_BATCH, SEED)[0]
    return {
        "imdb": (imdb, lambda: make_requests(imdb, 64, 6, IMDB.timesteps,
                                             0.85, SEED),
                 dict(batch_slots=32, pages=2, megastep=10)),
        "conv": (mnist, lambda: image_requests(images, MNIST.timesteps,
                                               stagger=3),
                 dict(batch_slots=32, pages=2, megastep=5))}


def same_served(a, b) -> bool:
    """Two requests served alike: logits, V, ticks, finish clock and the
    whole per-request report."""
    return (same_request(a, b) and a.finish_clock == b.finish_clock
            and a.report.events == b.report.events
            and a.report.layer_frames == b.report.layer_frames)


def phase_compiled(dev) -> dict:
    """Phase 13: each drain of `compiled_drains` on every compiled backend,
    eager, graphed and graphed with the double buffer: every request, the
    device ledger and the launch counts equal the eager drain's; then the
    `cuda` engine's frames/s in each mode (median of alternating drains)
    and one profiled drain each."""
    from repro_torch import kernels

    out = {}
    for name, (program, requests, kw) in compiled_drains(dev).items():
        def drain(backend, mode, window=None):
            cls, db = dispatch_engine(mode)
            eng = cls(program, backend=backend, step_kw=STEP_KW.get(backend),
                      double_buffer=db, device=dev, **kw)
            for r in requests():
                eng.submit(r)
            torch.cuda.synchronize()
            with window or contextlib.nullcontext():
                t0 = time.perf_counter()
                done = eng.run_until_drained()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            return sorted(done, key=lambda r: r.rid), dt, eng

        rows = {}
        for backend in COMPILED_BACKENDS:
            drain(backend, "eager")                  # warm-up, not counted
            kernels.reset_launch_counts()
            ref, _, ref_eng = drain(backend, "eager")
            want = dict(kernels.LAUNCH_COUNTS)
            row = {"launches": {k: v for k, v in want.items() if v},
                   "megasteps": ref_eng.dispatches}
            for mode in DISPATCH_MODES[1:]:
                kernels.reset_launch_counts()
                got, _, eng = drain(backend, mode)
                launches = dict(kernels.LAUNCH_COUNTS)
                bad = [a.rid for a, b in zip(got, ref)
                       if not same_served(a, b)]
                if len(got) != len(ref) or bad:
                    raise AssertionError(f"{name} {backend} {mode} != eager "
                                         f"(requests {bad})")
                if launches != want:
                    raise AssertionError(f"{name} {backend} {mode}: launches "
                                         f"{launches}, eager {want}")
                if any(d._run.graph is None for d in eng._dispatch):
                    raise AssertionError(f"{name} {backend} {mode}: a page "
                                         "dispatched without its graph")
                if backend == "cuda_events":
                    a, b = eng.device_event_stats(), \
                        ref_eng.device_event_stats()
                    if a.frames != b.frames or a.dense_fallbacks != \
                            b.dense_fallbacks or not all(
                                np.array_equal(x, y) for x, y in
                                zip(a.row_events, b.row_events)):
                        raise AssertionError(f"{name} {mode}: the device "
                                             "ledger != the eager drain's")
                if mode == "graphed_db":
                    row["staged_used"] = eng._staged_used
                    row["staged_rebuilt"] = eng._staged_rebuilt
            rows[backend] = row
        frames = sum(r.ticks for r in ref)
        times = {mode: [] for mode in DISPATCH_MODES}
        for i in range(COMPILED_REPEATS):             # in turns
            order = DISPATCH_MODES if i % 2 == 0 else DISPATCH_MODES[::-1]
            for mode in order:
                times[mode].append(drain("cuda", mode)[1])
        timing = {}
        for mode in DISPATCH_MODES:
            prof = profile_drain(drain, "cuda", mode)
            timing[mode] = {
                "frames_per_s": frames / float(np.median(times[mode])),
                "s": times[mode], "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "device_ops_per_megastep":
                    prof["device_ops"] / rows["cuda"]["megasteps"],
                "profiled_wall_ms": prof["wall_ms"], "top": prof["top"][:4]}
        out[name] = {"frames": frames, "backends": rows, "cuda": timing}
    return out


def dense_launch_ms(fn) -> list:
    """Device ms of each dense fused-network launch of one ``fn()`` under
    torch.profiler, in launch order (after one call unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "fused_snn_net_kernel" in e.name)
    return [ms for _, ms in launches]


def kernel_usage(usage: dict) -> dict:
    """ptxas registers and spills by kernel name: `fused_snn_net.cu`'s
    three kernels under their launch-count names, every wkv6 instantiation
    as ``wkv6<K, COLS>``, every fused_snn_step instantiation as
    ``fused_snn_step<NEURON, WRAP>`` and under ``fused_snn_step`` the one
    that uses the most registers."""
    import re
    out = {}
    for entry, row in usage.items():
        m = re.search(r"wkv6_kernelILi(\d+)ELi(\d+)E", entry)
        if m:
            out[f"wkv6<{m.group(1)}, {m.group(2)}>"] = row
        m = re.search(r"fused_snn_step_kernelILi(\d+)ELi(\d+)E", entry)
        if m:
            out[f"fused_snn_step<{m.group(1)}, {m.group(2)}>"] = row
            if row["registers"] >= out.get("fused_snn_step",
                                           {"registers": -1})["registers"]:
                out["fused_snn_step"] = row
        for name in ("fused_snn_net_gated", "fused_snn_net_events"):
            if name in entry:
                out[name] = row
        if "fused_snn_net_kernel" in entry:
            out["fused_snn_net"] = row
    return out


# ---------------------------------------------------------------------------
# Phase 14: the dense attention family and the spiking FFN
# ---------------------------------------------------------------------------

def bucket_ttft(eng, prompt, repeats: int = 3) -> float:
    """Median seconds from a prompt to its first token on the host: the
    engine's prefill (a graph replay on a compiled engine) and the argmax
    read."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng._prefill(prompt)
        int(torch.argmax(logits[0]))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def serve_dense(dev, cfg, params, label: str, long_prompts: list,
                profile: bool = True, repeat_equal: bool = False) -> dict:
    """Phase 14(a)/(c): ``cfg`` served by the port's ServeEngine (4 slots,
    DENSE_MAX_LEN): an eager warm-up drain, then an eager drain with every
    prefill and decode logit checked finite (``repeat_equal``: and its
    tokens equal to the warm-up's), then the compiled engine (one graph
    per prefill bucket, a decode graph from tick 2) against it and both
    engines' tokens/s and profiled drains, the buckets and the LRU's
    contents, and the time to the first token per bucket. An engine that
    prefills at the exact length (MLA) keys those by length, and its
    prefills run eagerly."""
    from repro_torch import kernels
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import tree_leaves
    from repro_torch.serve.graphed import StaticPrefill

    drain, EagerEngine = lm_drainer(params, cfg, DENSE_MAX_LEN, long_prompts)
    warm = drain()[0]                              # warm-up, not counted
    kernels.reset_launch_counts()
    with recorded_logits() as seen:
        served, dt, eager = drain()
    if repeat_equal and ([r.out_tokens for r in served]
                         != [r.out_tokens for r in warm]):
        raise AssertionError(f"{label}: two eager drains served other "
                             "tokens")
    launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items() if v}
    bad_shape = [(kind, shape) for kind, shape, _ in seen
                 if shape != ((1 if kind == "prefill" else 4), cfg.vocab_size)]
    if not all(bool(flag) for _, _, flag in seen) or bad_shape:
        raise AssertionError(f"{label}: non-finite logits or bad shapes "
                             f"{bad_shape}")
    if len(served) != 8 or any(len(r.out_tokens) != LM_NEW
                               for r in served):
        raise AssertionError(f"{label}: the engine did not serve 8 requests "
                             f"x {LM_NEW} tokens")
    reqs = lm_requests(cfg, long_prompts)
    buckets = sorted({eager._prefill_bucket(len(r.prompt)) for r in reqs})
    long_bucket = DENSE_BUCKET if eager._bucket_prompts else DENSE_LONG
    if long_bucket not in buckets or sorted(eager._prefill_cache) != buckets:
        raise AssertionError(f"{label}: buckets {buckets}, LRU "
                             f"{list(eager._prefill_cache)}")
    tokens = sum(len(r.out_tokens) for r in served)
    out = {"drain_s": dt, "tokens": tokens, "tokens_per_s": tokens / dt,
           "prefills": sum(k == "prefill" for k, _, _ in seen),
           "decode_ticks": sum(k == "decode_step" for k, _, _ in seen),
           "logits_checked": len(seen), "port_kernel_launches": launches,
           "buckets": buckets, "first_tokens": [r.out_tokens[:4]
                                                for r in served]}
    engines: dict = {}
    out["compiled"] = compiled_decode(drain, served, EagerEngine, ServeEngine,
                                      label=label, keep=engines,
                                      profile=profile)
    geng = engines["graphed"]
    prefills = list(geng._prefill_cache.values())
    if not (list(geng._prefill_cache) and all(
            isinstance(f, StaticPrefill) == geng._bucket_prompts
            and (not geng._bucket_prompts or f._run.graph is not None)
            for f in prefills)):
        raise AssertionError(f"{label}: a prefill bucket was not graphed, "
                             "or an exact-length prefill was")
    out["lru"] = list(geng._prefill_cache)
    out["kv_cache_bytes"] = sum(t.nbytes for t in tree_leaves(
        {k: v for k, v in geng.cache.items() if k != "len"}))
    by_bucket = {}
    for r in reqs:
        by_bucket.setdefault(geng._prefill_bucket(len(r.prompt)), r.prompt)
    out["ttft_ms"] = {
        mode: {b: 1e3 * bucket_ttft(eng, p) for b, p in by_bucket.items()}
        for mode, eng in (("graphed", geng), ("eager", engines["eager"]))}
    # device ms of one decode graph replay; the replays advance the served
    # engine's lanes past their requests, and nothing reads them after
    out["decode_tick_ms"] = device_ms(geng._decode, 10)[0]
    return out


def logits_head_cost(params, cfg, B: int = 4) -> dict:
    """The float32 head of `lm._logits` (the reference's arithmetic: the
    bf16 head cast to float32 on every call) at a decode tick's B rows:
    its device ms (CUDA events, 20 calls) and the memory it allocates."""
    from repro_torch.models import lm
    x = torch.randn((B, 1, cfg.d_model), device=params["embed"].device,
                    dtype=params["embed"].dtype)
    lm._logits(params, x, cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        lm._logits(params, x, cfg)
    end.record()
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / 20,
            "temp_bytes": torch.cuda.max_memory_allocated() - base,
            "head_f32_bytes": cfg.vocab_size * cfg.d_model * 4}


def layer0_qkv(params, cfg, toks: torch.Tensor):
    """Layer 0's rotated q, k and v on ``toks`` (1, T), as float32."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    p0 = lm.tree_map(lambda a: a[0], params["blocks"])["pos0"]
    h = lm._norm(params["embed"][toks], p0["norm1"], cfg)
    T, hd = toks.shape[1], cfg.head_dim
    pos = torch.arange(T, device=toks.device)[None]
    q = L.apply_rope((h @ p0["attn"]["wq"]).reshape(1, T, -1, hd), pos,
                     cfg.rope_theta)
    k = L.apply_rope((h @ p0["attn"]["wk"]).reshape(1, T, -1, hd), pos,
                     cfg.rope_theta)
    v = (h @ p0["attn"]["wv"]).reshape(1, T, -1, hd)
    return q.float(), k.float(), v.float()


def padded_vs_exact(params, cfg, prompt: np.ndarray) -> dict:
    """A prompt prefilled right-padded to its bucket (with its length)
    against its exact-length prefill: last-token logits, and K/V at the
    valid positions of every layer."""
    from repro_torch.models import lm
    dev = params["embed"].device
    n = len(prompt)
    padded = torch.zeros((1, DENSE_BUCKET), dtype=torch.int64, device=dev)
    padded[0, :n] = torch.as_tensor(prompt, device=dev)
    lp, cp = lm.prefill(params, {"tokens": padded}, cfg, DENSE_MAX_LEN,
                        length=n)
    le, ce = lm.prefill(params, {"tokens": padded[:, :n]}, cfg,
                        DENSE_MAX_LEN)
    out = logit_diff(lp, le)
    for leaf in ("k", "v"):
        out[leaf] = rel_diff(cp["blocks"]["pos0"][leaf][:, :, :n],
                             ce["blocks"]["pos0"][leaf][:, :, :n])
    out["len_equal"] = bool(torch.equal(cp["len"], ce["len"]))
    return out


def prefill_vs_decode(params, cfg, prompt: np.ndarray) -> dict:
    """Prefill of the prompt plus one token against prefill then one
    decode step: the last logits."""
    from repro_torch.models import lm
    toks = torch.as_tensor(prompt[None], device=params["embed"].device)
    logits, cache = lm.prefill(params, {"tokens": toks}, cfg, DENSE_MAX_LEN)
    nxt = logits.argmax(-1)[:, None]
    full, _ = lm.prefill(params, {"tokens": torch.cat([toks, nxt], 1)}, cfg,
                         DENSE_MAX_LEN)
    dec, _ = lm.decode_step(params, nxt, cache, cfg)
    return logit_diff(dec, full)


def phase_dense(dev, cfg) -> dict:
    """Phase 14(a)-(b): ``cfg`` at full width, bf16 weights from seed 0
    drawn on ``dev``, served; then the numerics on the served model, and
    in float32 (full depth if the card holds it, else DENSE_F32_CUT
    layers)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    free_cuda()
    t0 = time.perf_counter()
    params = lm.init_params(SEED, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params": sum(a.numel() for a in leaves(params)),
           "param_count": cfg.param_count()}
    rng = np.random.default_rng(SEED + 1)
    long_prompts = [rng.integers(0, cfg.vocab_size, DENSE_LONG)
                    for _ in range(2)]
    out["serve"] = serve_dense(dev, cfg, params, cfg.arch_id, long_prompts)
    free_cuda()
    out["logits_head"] = logits_head_cost(params, cfg)

    # (b) numerics on the served (bf16) model, reported
    out["bf16_padded_vs_exact"] = padded_vs_exact(params, cfg,
                                                  long_prompts[0])
    out["bf16_prefill_vs_decode"] = prefill_vs_decode(params, cfg,
                                                      long_prompts[0])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, DENSE_BUCKET)[None],
                           device=dev)
    q, k, v = layer0_qkv(params, cfg, toks)
    plain = L._sdpa(q, k, v, causal=True,
                    q_pos=torch.arange(DENSE_BUCKET, device=dev)[None])
    blocked = L.blocked_attention(q, k, v, causal=True,
                                  q_chunk=BLOCKED_CHUNK, kv_block=BLOCKED_CHUNK)
    err = (blocked - plain).abs()
    worst = float((err / (BLOCKED_ATOL + BLOCKED_RTOL * plain.abs())).max())
    out["blocked_vs_sdpa"] = d = {
        "T": DENSE_BUCKET, "q_chunk": BLOCKED_CHUNK, "kv_block": BLOCKED_CHUNK,
        "max_abs_err": float(err.max()), "max_abs_ref": float(plain.abs().max()),
        "worst_err_over_tol": worst,
        "tolerance": f"{BLOCKED_ATOL} + {BLOCKED_RTOL} * |ref|"}
    if not worst <= 1.0:
        raise AssertionError(f"blocked attention != _sdpa on layer 0 beyond "
                             f"the tolerance: {d}")
    del params, q, k, v, plain, blocked
    free_cuda()

    # float32: the gated comparisons
    need = 4 * cfg.param_count() * 1.2
    free = torch.cuda.mem_get_info(dev)[0]
    cfg32 = cfg
    if free < need:
        cfg32 = dataclasses.replace(cfg, n_layers=DENSE_F32_CUT)
    out["f32_layers"] = cfg32.n_layers
    params = lm.init_params(SEED, cfg32, dtype=torch.float32, device=dev)
    out["f32_padded_vs_exact"] = d = padded_vs_exact(params, cfg32,
                                                     long_prompts[0])
    if not (d["rel_l2"] <= F32_L2 and d["max_rel"] <= F32_L2
            and d["argmax_equal"] and d["len_equal"]
            and all(d[leaf]["rel_l2"] <= F32_L2 for leaf in ("k", "v"))):
        raise AssertionError(f"float32: bucketed and exact-length prefill "
                             f"differ beyond {F32_L2}: {d}")
    out["f32_prefill_vs_decode"] = d = prefill_vs_decode(params, cfg32,
                                                         long_prompts[0])
    if not (d["rel_l2"] <= F32_DECODE_L2 and d["max_rel"] <= F32_DECODE_L2):
        raise AssertionError(f"float32: prefill of prompt + 1 token and "
                             f"prefill + decode differ beyond "
                             f"{F32_DECODE_L2}: {d}")
    del params
    free_cuda()
    return out


@contextlib.contextmanager
def recorded_spiking():
    """Wrap `pipeline.run_network` as the spiking FFN calls it: record each
    call's mean spike rate (a device scalar) and, from the first call, its
    program's state shape, input current and spike sums."""
    from repro_torch.core import pipeline
    orig, seen = pipeline.run_network, {"rates": [], "first": None}

    def call(program, xs, *args, **kw):
        res = orig(program, xs, *args, **kw)
        seen["rates"].append(res.aux["spike_rates"].mean())
        if seen["first"] is None:
            seen["first"] = (xs.clone(), res.aux["spike_sums"][0].clone())
        return res
    pipeline.run_network = call
    try:
        yield seen
    finally:
        pipeline.run_network = orig


def phase_spiking(dev, cfg) -> dict:
    """Phase 14(c): ``cfg`` with the spiking FFN at full width, bf16
    weights from seed 0, served compiled and eager; the mean spike rate of
    an eager drain; layer 0's float executor on the card against the same
    port code on the CPU, on the current it recorded."""
    from repro_torch.core import pipeline
    from repro_torch.models import lm
    params = lm.init_params(SEED, cfg, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(SEED + 2)
    long_prompts = [rng.integers(0, cfg.vocab_size, DENSE_LONG)
                    for _ in range(2)]
    out = {"params": sum(a.numel() for a in leaves(params))}
    out["serve"] = serve_dense(dev, cfg, params, cfg.arch_id, long_prompts,
                               profile=False)
    with recorded_spiking() as seen:
        toks = torch.as_tensor(long_prompts[0][None], device=dev)
        lm.prefill(params, {"tokens": toks}, cfg, DENSE_MAX_LEN)
    rates = torch.stack(seen["rates"])
    current, sums = seen["first"]
    program = pipeline.rate_coded_program(cfg.spiking,
                                          tuple(current.shape[1:]),
                                          device="cpu")
    res = pipeline.run_network(program, current.cpu(), "float",
                               collect_sums=True, static_input=True)
    cpu_sums = res.aux["spike_sums"][0]
    differ = int((cpu_sums != sums.cpu()).sum())
    out["prefill_spike_rate"] = {"mean": float(rates.mean()),
                                 "per_layer": [float(r) for r in rates]}
    out["spike_sums_card_vs_cpu"] = d = {
        "shape": list(current.shape), "differing": differ,
        "spikes": float(cpu_sums.sum()), "bit_equal": differ == 0}
    if differ:
        raise AssertionError(f"spiking FFN: the card's spike sums differ from "
                             f"the CPU's: {d}")
    del params
    free_cuda()
    return out


def print_dense(dense: dict, cfg, card: str) -> None:
    """Phase 14(a)-(b)'s lines."""
    srv = dense.pop("serve")
    comp = srv.pop("compiled")
    print(f"[phase 14] (a) {cfg.arch_id}: {dense['params']} params (bf16; "
          f"param_count {dense['param_count']} + final_norm) drawn on the "
          f"card in {dense['init_s']:.2f} s; eager engine: 8 requests (6 of "
          f"4 to 16 tokens, 2 of {DENSE_LONG}) x {LM_NEW} tokens, 4 "
          f"slots, max_len {DENSE_MAX_LEN}, {srv['tokens_per_s']:.2f} "
          f"tokens/s ({srv['drain_s']:.3f} s), every logit finite "
          f"({srv['logits_checked']} prefill and decode calls); buckets "
          f"{srv['buckets']}; port kernel launches "
          f"{srv['port_kernel_launches'] or 'none (no kernel on this path)'}")
    print(f"[phase 14] (a) compiled engine (one CUDA graph per prefill "
          f"bucket, a decode graph from tick 2) == eager engine, token for "
          f"token; LRU {srv['lru']}; tokens/s (median of 3 in turns): eager "
          f"{comp['eager']['tokens_per_s']:.2f}, graphed "
          f"{comp['graphed']['tokens_per_s']:.2f}; device idle eager "
          f"{comp['eager']['device_idle_share']:.3f}, graphed "
          f"{comp['graphed']['device_idle_share']:.3f} ({card})")
    print(f"[phase 14] (a) time to first token per bucket (ms, median of "
          f"3): {json.dumps(srv['ttft_ms'])} ({card})")
    print(f"[phase 14] (a) KV cache {srv['kv_cache_bytes']} bytes; float32 "
          f"logits head at B = 4: {json.dumps(dense['logits_head'])}; one "
          f"decode graph replay {srv['decode_tick_ms']:.3f} ms ({card})")
    print(f"[phase 14] (a) drains: {json.dumps(comp)} ({card})")
    d = dense["blocked_vs_sdpa"]
    print(f"[phase 14] (b) blocked_attention (q_chunk {d['q_chunk']}, "
          f"kv_block {d['kv_block']}) vs _sdpa on layer 0's q, k, v at "
          f"T = {d['T']}, float32: max |err| {d['max_abs_err']:.3e} "
          f"(max |ref| {d['max_abs_ref']:.3f}), worst err / tol "
          f"{d['worst_err_over_tol']:.3f}, tol {d['tolerance']}: ok")
    print(f"[phase 14] (b) bucketed ({DENSE_LONG} -> {DENSE_BUCKET}) vs "
          f"exact prefill, float32 at {dense['f32_layers']} layers (tol "
          f"{F32_L2} rel L2 and max rel, K/V rel L2): "
          f"{json.dumps(dense['f32_padded_vs_exact'])}: ok; bf16 at full "
          f"depth (reported): {json.dumps(dense['bf16_padded_vs_exact'])}")
    print(f"[phase 14] (b) prefill of prompt + 1 vs prefill + decode_step, "
          f"float32 at {dense['f32_layers']} layers (tol {F32_DECODE_L2}): "
          f"{json.dumps(dense['f32_prefill_vs_decode'])}: ok; bf16 at full "
          f"depth (reported): {json.dumps(dense['bf16_prefill_vs_decode'])}")


# ---------------------------------------------------------------------------
# Phase 15: train the language models the port serves
# ---------------------------------------------------------------------------

def lm_run(cfg, B: int, seq: int, total: int, **parallel):
    """The training run of phase 15: AdamW with the JAX package's defaults
    (b2 0.95, weight decay 0.1) at lr 1e-3 with a cosine warm-up of 2
    steps (the JAX tests' tiny run), remat per block unless given."""
    from repro_torch.configs.base import ParallelConfig, RunConfig, ShapeConfig
    parallel.setdefault("remat", "block")
    return RunConfig(model=cfg, shape=ShapeConfig("phase15", seq, B, "train"),
                     parallel=ParallelConfig(**parallel), optimizer="adamw",
                     learning_rate=LM_TRAIN_LR, warmup_steps=2)


def lm_batch(cfg, B: int, seq: int, step: int, dev) -> dict:
    """Batch ``step`` of `lm_batch_fn` (seed 0) on ``dev``."""
    from repro_torch.data.loader import lm_batch_fn
    return {k: torch.as_tensor(v, device=dev) for k, v in
            lm_batch_fn(cfg.vocab_size, B, seq, SEED)(step, 0, 1).items()}


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if torch.is_tensor(x))


def train_lm(dev, run, steps: int) -> dict:
    """``run``'s train step from `init_train_state` (bf16 weights drawn on
    the card from seed 0, the one start state), eager and compiled
    (`eager_vs_compiled`: ``steps`` steps each, one batch stream): the
    eager run's losses and gradient norms (all finite),
    median ms a step of the last half, profiled step and peak memory, the
    state's bytes, the compiled run's the same (its losses finite too)
    and the comparison after COMPARE_STEPS steps. The eager run's state
    stays in the result."""
    from repro_torch.train import init_train_state, make_train_step
    free_cuda()
    t0 = time.perf_counter()
    state, opt = init_train_state(SEED, run, total_steps=steps, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"params": sum(a.numel() for a in leaves(state.params)),
           "init_s": init_s,
           "state_bytes": tree_bytes(state.params) + tree_bytes(
               state.opt_state)}
    cfg, B, seq = run.model, run.shape.global_batch, run.shape.seq_len
    t0 = time.perf_counter()
    start = [state]
    del state
    res = eager_vs_compiled(dev, make_train_step(run, opt), start,
                            lambda s: lm_batch(cfg, B, seq, s, dev), steps)
    out["eager_vs_compiled_s"] = time.perf_counter() - t0
    for label in ("eager", "compiled"):
        r = res[label]
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"{cfg.arch_id} ({label}): a loss or grad "
                                 f"norm is not finite: {r['losses']}, "
                                 f"{r['grad_norms']}")
    out["state"] = res["eager"].pop("state")
    out.update(res["eager"])
    out["compiled_runs"] = res
    return out


def loss_and_grads(params, batch, cfg, parallel) -> tuple:
    """(loss, aux, gradient tree) of `lm.loss_fn` by autograd."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_unflatten_like
    xs = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, aux = lm.loss_fn(tree_unflatten_like(params, xs), batch, cfg,
                           parallel)
    grads = torch.autograd.grad(loss, xs)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_unflatten_like(params, list(grads)))


def grads_diff(got, want) -> dict:
    """The largest relative L2 difference over the leaves, and its leaf."""
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    rows = [(rel_l2(a, b), "/".join(map(str, path))) for (path, a), b in
            zip(tree_flatten_with_paths(got), tree_leaves(want))]
    worst, leaf = max(rows)
    return {"max_rel_l2": worst, "leaf": leaf}


def lm_checks_f32(dev, cfg) -> dict:
    """Phase 15(a), float32 at full width cut to LM_CHECK_LAYERS layers
    (weights drawn on the card from seed 0, B = LM_CHECK_B, seq
    LM_CHECK_SEQ, TF32 off): loss and gradients on the card against the
    same port code on the CPU; vocab_chunking 4 against 0, remat "block"
    against "none" (the embedding's backward sums by atomics on the card,
    so the gradients are held within LM_NONDET_RL2, not bit for bit) and
    microbatches 2 against 1 (one AdamW step), at the CPU tests'
    tolerances (vocab chunking's gradients at the card-against-CPU one)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.train_state import _make_opt
    from repro_torch.tree import tree_leaves, tree_map
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the checks need f32")
    cut = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    params = lm.init_params(SEED, cut, dtype=torch.float32, device=dev)
    batch = lm_batch(cut, LM_CHECK_B, LM_CHECK_SEQ, 0, dev)
    none = ParallelConfig(remat="none")
    loss, _, grads = loss_and_grads(params, batch, cut, none)
    host = tree_map(lambda a: a.cpu(), params)
    h_loss, _, h_grads = loss_and_grads(
        host, {k: v.cpu() for k, v in batch.items()}, cut, none)
    out = {"layers": LM_CHECK_LAYERS, "batch": LM_CHECK_B,
           "seq": LM_CHECK_SEQ}
    out["card_vs_cpu"] = d = {
        "loss_card": float(loss), "loss_cpu": float(h_loss),
        "loss_rel": abs(float(loss) - float(h_loss)) / abs(float(h_loss)),
        **grads_diff(grads, h_grads)}
    if d["loss_rel"] > LM_LOSS_RTOL or d["max_rel_l2"] > LM_GRAD_RL2:
        raise AssertionError(f"float32 loss / gradients: card != CPU beyond "
                             f"{LM_LOSS_RTOL} / {LM_GRAD_RL2}: {d}")
    del host, h_grads
    c_loss, _, c_grads = loss_and_grads(params, batch, cut, ParallelConfig(
        remat="none", vocab_chunking=4))
    out["vocab_chunking_4_vs_0"] = d = {
        "loss_rel": abs(float(c_loss) - float(loss)) / abs(float(loss)),
        **grads_diff(c_grads, grads)}
    if d["loss_rel"] > LM_CHUNK_RTOL or d["max_rel_l2"] > LM_GRAD_RL2:
        raise AssertionError(f"vocab_chunking=4 != 0 beyond {LM_CHUNK_RTOL} "
                             f"(loss) / {LM_GRAD_RL2} (gradients): {d}")
    del c_grads
    r_loss, _, r_grads = loss_and_grads(params, batch, cut,
                                        ParallelConfig(remat="block"))
    out["remat_block_vs_none"] = d = {
        "loss_equal": bool(torch.equal(r_loss, loss)),
        **grads_diff(r_grads, grads)}
    if not d["loss_equal"] or d["max_rel_l2"] > LM_NONDET_RL2:
        raise AssertionError(f"remat block != none (loss bit for bit, "
                             f"gradients within {LM_NONDET_RL2}): {d}")
    del r_grads, grads
    stepped = {}
    for mb in (1, 2):
        run = lm_run(cut, LM_CHECK_B, LM_CHECK_SEQ, 8, remat="none",
                     microbatches=mb)
        opt = _make_opt(run, 8)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        stepped[mb] = make_train_step(run, opt)(state, batch)
    (s1, m1), (s2, m2) = stepped[1], stepped[2]
    first = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(s1.params), tree_leaves(s2.params))]
    out["microbatches_2_vs_1"] = d = {
        "loss_rel": abs(float(m2["loss"]) - float(m1["loss"]))
        / abs(float(m1["loss"])), "max_abs_param_diff": max(first)}
    if d["loss_rel"] > LM_MB_LOSS_RTOL or d["max_abs_param_diff"] > LM_MB_ATOL:
        raise AssertionError(f"microbatches 2 != 1 beyond {LM_MB_LOSS_RTOL} "
                             f"/ {LM_MB_ATOL}: {d}")
    del params, stepped, s1, s2
    free_cuda()
    return out


def spiking_energy(params, cfg, B: int, seq: int, dev) -> dict:
    """`examples/spiking_ffn_lm.py`'s sparsity and macro-energy line, with
    the port's `core.energy` and `core.mapping`: the FFNs' mean spike rate
    on batch 999 (the loss's aux over the layers), mapped onto IMPULSE
    macros. A model of the silicon, not a number of the card."""
    from repro_torch.core import energy, mapping
    from repro_torch.core.isa import InstrCount
    from repro_torch.models import lm
    with torch.no_grad():
        _, aux = lm.loss_fn(params, lm_batch(cfg, B, seq, 999, dev), cfg)
    rate = float(aux["aux"]) / cfg.n_layers
    sparsity = 1.0 - rate
    tokens = B * seq
    tiles = mapping.fc_tiling(cfg.d_model, cfg.d_ff)
    T = cfg.spiking.timesteps
    events = rate * cfg.d_model * T * tokens * cfg.n_layers
    per_step = 2 * T * tokens * cfg.n_layers * tiles.col_tiles
    counts = InstrCount(acc_w2v=int(2 * events * tiles.col_tiles),
                        spike_check=per_step, acc_v2v=per_step)
    e = energy.sequence_energy_j(counts)
    return {"ffn_spike_sparsity": sparsity, "tokens": tokens,
            "macro_ffn_energy_nj": e * 1e9,
            "macro_pj_per_token": e / tokens * 1e12,
            "edp_reduction_vs_dense_firing": energy.edp_reduction(sparsity),
            "what": "IMPULSE macro energy model at point D, not the card"}


def phase_lm_train(dev, cfg) -> dict:
    """Phase 15(a): ``cfg`` (llama3.2-1b) at full width, bf16, trained
    LM_TRAIN_STEPS steps at B = LM_TRAIN_B, seq LM_TRAIN_SEQ, eager and
    compiled (`train_lm`): every loss finite and the mean of the last 5
    eager ones below the first 5's; then the float32 checks of
    `lm_checks_f32`."""
    out = train_lm(dev, lm_run(cfg, LM_TRAIN_B, LM_TRAIN_SEQ,
                               LM_TRAIN_STEPS), LM_TRAIN_STEPS)
    del out["state"]
    losses = out["losses"]
    out["loss_first5"] = float(np.mean(losses[:5]))
    out["loss_last5"] = float(np.mean(losses[-5:]))
    if not out["loss_last5"] < out["loss_first5"]:
        raise AssertionError(f"{cfg.arch_id}: the loss did not fall: "
                             f"{losses}")
    free_cuda()
    out["f32_checks"] = lm_checks_f32(dev, cfg)
    return out


def phase_spiking_train(dev, cfg) -> dict:
    """Phase 15(b): ``cfg`` with the spiking FFN at full width, bf16,
    SPK_TRAIN_STEPS steps at B = SPK_TRAIN_B, seq SPK_TRAIN_SEQ, eager and
    compiled (`train_lm`); then on the eager run's trained weights: the loss finite, aux > 0 and every FFN leaf's
    gradient (each layer's slice) finite and non-zero; and the example's
    sparsity and macro-energy line."""
    out = train_lm(dev, lm_run(cfg, SPK_TRAIN_B, SPK_TRAIN_SEQ,
                               SPK_TRAIN_STEPS), SPK_TRAIN_STEPS)
    params = out.pop("state").params
    batch = lm_batch(cfg, SPK_TRAIN_B, SPK_TRAIN_SEQ, SPK_TRAIN_STEPS + 1,
                     dev)
    run = lm_run(cfg, SPK_TRAIN_B, SPK_TRAIN_SEQ, SPK_TRAIN_STEPS)
    loss, aux, grads = loss_and_grads(params, batch, cfg, run.parallel)
    ffn = grads["blocks"]["pos0"]["ffn"]
    zero = [f"{name}[{i}]" for name, g in ffn.items()
            for i in range(g.shape[0]) if not g[i].abs().sum() > 0]
    finite = all(bool(torch.isfinite(g).all()) for g in ffn.values())
    out["trained"] = d = {"loss": float(loss), "aux": float(aux["aux"]),
                          "ffn_grad_finite": finite,
                          "ffn_grad_zero_slices": zero}
    if not (math.isfinite(d["loss"]) and d["aux"] > 0 and finite
            and not zero):
        raise AssertionError(f"spiking FFN training: {d}")
    out["energy"] = spiking_energy(params, cfg, SPK_TRAIN_B, SPK_TRAIN_SEQ,
                                   dev)
    del params, grads, ffn
    free_cuda()
    return out


def phase_rwkv_train(dev, cfg) -> dict:
    """Phase 15(c): ``cfg`` (rwkv6-7b) at full width cut to
    RWKV_TRAIN_LAYERS layers (AdamW's float32 moments alone for 7.6 B
    parameters exceed the card's 80 GB), bf16, RWKV_TRAIN_STEPS steps at
    B = RWKV_TRAIN_B, seq RWKV_TRAIN_SEQ through the differentiable
    chunked wkv6 in chunks of RWKV_TRAIN_CHUNK, eager and compiled
    (`train_lm`): no wkv6 launch in the steps; on the trained weights every leaf upstream of the recurrence
    (wr, wk, wv, decay_w1, decay_w2, bonus, each layer) gets a non-zero
    gradient; the loss at JAX's chunk of 64 on the first batch (reported);
    then a prefill on the trained weights launches the kernel once a layer,
    each launch within WKV_TOL relative L2 of `wkv6_sequential`."""
    from repro_torch import kernels
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm, rwkv
    cut = dataclasses.replace(cfg, n_layers=RWKV_TRAIN_LAYERS)
    run = lm_run(cut, RWKV_TRAIN_B, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS,
                 wkv_chunk=RWKV_TRAIN_CHUNK)
    kernels.reset_launch_counts()
    out = train_lm(dev, run, RWKV_TRAIN_STEPS)
    out["wkv6_launches_in_training"] = kernels.LAUNCH_COUNTS["wkv6"]
    if kernels.LAUNCH_COUNTS["wkv6"]:
        raise AssertionError("the train steps launched the forward-only "
                             "wkv6 kernel")
    params = out.pop("state").params
    batch = lm_batch(cut, RWKV_TRAIN_B, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS + 1,
                     dev)
    loss, _, grads = loss_and_grads(params, batch, cut, run.parallel)
    tm = grads["blocks"]["pos0"]["rwkv"]["tm"]
    upstream = ("wr", "wk", "wv", "decay_w1", "decay_w2", "bonus")
    sums = {name: [float(tm[name][i].float().abs().sum())
                   for i in range(cut.n_layers)] for name in upstream}
    out["upstream_grad_abs_sums"] = sums
    if not (math.isfinite(float(loss))
            and all(x > 0 and math.isfinite(x)
                    for v in sums.values() for x in v)):
        raise AssertionError(f"rwkv training: loss {float(loss)}, gradients "
                             f"upstream of wkv6 {sums}")
    del grads, tm
    with torch.no_grad():
        first = lm_batch(cut, RWKV_TRAIN_B, RWKV_TRAIN_SEQ, 0, dev)
        jax_chunk, _ = lm.loss_fn(params, first, cut, ParallelConfig(
            wkv_chunk=64))
        ours, _ = lm.loss_fn(params, first, cut, run.parallel)
    out["loss_batch0_trained"] = {
        f"chunk_{RWKV_TRAIN_CHUNK}": float(ours),
        "chunk_64_jax_default": float(jax_chunk)}

    model_fn, calls = rwkv.wkv6, []

    def recording(*args, **kw):
        y, s = model_fn(*args, **kw)
        calls.append((args, kw, y, s))
        return y, s
    toks = first["tokens"][:1]
    kernels.reset_launch_counts()
    with torch.no_grad(), model_wkv6(recording):
        logits, _ = lm.prefill(params, {"tokens": toks}, cut, toks.shape[1])
    launches = kernels.LAUNCH_COUNTS["wkv6"]
    rows = []
    for n, (args, kw, y, s) in enumerate(calls):
        y_p, s_p = plain_wkv6(*args, **kw)
        rows.append({"layer": n,
                     "rel_l2_y": float((y - y_p).norm() / y_p.norm()),
                     "rel_l2_s": float((s - s_p).norm() / s_p.norm())})
    out["prefill_on_trained"] = d = {
        "wkv6_launches": launches, "rows": rows,
        "logits_finite": bool(torch.isfinite(logits).all())}
    if (launches != cut.n_layers or len(rows) != cut.n_layers
            or not d["logits_finite"]
            or any(max(r["rel_l2_y"], r["rel_l2_s"]) > WKV_TOL
                   for r in rows)):
        raise AssertionError(f"prefill on the trained weights: {d}")
    del params, calls
    free_cuda()
    return out


def phase_train_launcher() -> dict:
    """Phase 15(d): `python -m repro_torch.launch.train --arch llama3.2-1b
    --steps 10` as a subprocess (the reduced config, on the card): exit 0
    and its lines."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3.2-1b", "--steps", "10"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(root / "src")})
    lines = res.stdout.strip().splitlines()
    out = {"cmd": " ".join(cmd[1:]), "rc": res.returncode, "lines": lines,
           "s": time.perf_counter() - t0}
    if (res.returncode != 0 or len(lines) != 4
            or not lines[-1].startswith("done: 3 logs")
            or [x.split(" loss ")[0] for x in lines[:3]]
            != ["step 1", "step 5", "step 10"]):
        raise AssertionError(f"the train launcher: {out}; stderr "
                             f"{res.stderr[-2000:]}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the MoE super-block (llama4-maverick) at full width
# ---------------------------------------------------------------------------

def moe_drops(x, p, cfg, capacity_factor: float = 1.25) -> torch.Tensor:
    """(token, choice) pairs past their expert's capacity in one `moe_ffn`
    call on ``x`` (B, T, d) with its default groups, counted from the
    router's top-k by a per-group bincount (no sort): a device scalar."""
    from repro_torch.models import layers as L
    m = cfg.moe
    B, T, d = x.shape
    G = B if T > 1 else 1
    n = B * T // G
    probs = torch.softmax(x.reshape(G, n, d).float() @ p["router"], -1)
    eidx = L._topk_first(probs, m.top_k)[1].reshape(G, n * m.top_k)
    cap = max(int(np.ceil(n * m.top_k / m.n_experts * capacity_factor)), 4)
    counts = torch.zeros((G, m.n_experts), dtype=torch.long,
                         device=x.device).scatter_add_(
        1, eidx, torch.ones_like(eidx))
    return (counts - cap).clamp(min=0).sum()


@contextlib.contextmanager
def recorded_moe():
    """Wrap `layers.moe_ffn` as the model calls it: record each call's
    input (a copy) and its drop count (`moe_drops`, a device scalar)."""
    from repro_torch.models import layers as L
    orig, seen = L.moe_ffn, []

    def call(x, p, cfg, **kw):
        seen.append((x.clone(), moe_drops(x, p, cfg)))
        return orig(x, p, cfg, **kw)
    L.moe_ffn = call
    try:
        yield seen
    finally:
        L.moe_ffn = orig


def prefill_drops(params, cfg, long_prompts: list) -> list:
    """Each request's prefill as the engine pads it to its bucket (the
    padding is routed too), with the drop count of its MoE layer."""
    from repro_torch.serve import ServeEngine

    class EagerEngine(ServeEngine):
        _compiled = False
    eng = EagerEngine(params, cfg, batch_slots=4, max_len=DENSE_MAX_LEN)
    rows = []
    for r in lm_requests(cfg, long_prompts):
        with recorded_moe() as seen:
            eng._prefill(r.prompt)
        rows.append({"rid": r.rid, "len": len(r.prompt),
                     "bucket": eng._prefill_bucket(len(r.prompt)),
                     "drops": [int(n) for _, n in seen]})
    return rows


def moe_cap(cfg, n: int) -> int:
    """`moe_ffn`'s expert capacity for a group of ``n`` tokens."""
    m = cfg.moe
    return max(int(np.ceil(n * m.top_k / m.n_experts * 1.25)), 4)


def moe_reference(x, p, cfg) -> tuple:
    """An independent float32 per-token reference of top-k `moe_ffn` on
    ``x`` (1, n, d): each token's k experts are the k largest of its
    float32 router logits, their gates the router's softmax over all
    experts renormalised over those k; the keep mask is rebuilt as the
    first ``cap`` assignments of each expert in flat (token, choice)
    order; a token gets its kept experts' outputs times their gates plus
    the shared experts', all in float32 from the bf16 weights. Returns
    (out (1, n, d) float32, keep (n, k), experts (n, k))."""
    import torch.nn.functional as F
    m = cfg.moe
    if x.shape[0] != 1:
        raise ValueError("the reference covers the routing of one row")
    xf = x[0].float()
    n, k = xf.shape[0], m.top_k
    cap = moe_cap(cfg, n)
    logits = xf @ p["router"]
    top = logits.topk(k, dim=-1).indices                     # (n, k)
    probs = torch.softmax(logits, dim=-1).gather(-1, top)
    gates = probs / probs.sum(-1, keepdim=True)
    onehot = F.one_hot(top.reshape(-1), m.n_experts)         # flat order
    keep = (((onehot.cumsum(0) * onehot).sum(-1) - 1) < cap).reshape(n, k)

    def swiglu(h, g, u, dn):
        return (F.silu(h @ g.float()) * (h @ u.float())) @ dn.float()
    sh = p["shared"]
    out = swiglu(xf, sh["gate"], sh["up"], sh["down"])
    ex = p["experts"]
    for e in torch.unique(top[keep]).tolist():
        t, j = ((top == e) & keep).nonzero(as_tuple=True)
        out.index_add_(0, t, gates[t, j, None] * swiglu(
            xf[t], ex["gate"][e], ex["up"][e], ex["down"][e]))
    return out[None], keep, top


def moe_ffn_checks(params, cfg, prompt: np.ndarray) -> dict:
    """Phases 16(b) and 17(b): `moe_ffn` at full width on layer 1's served
    weights (the first MoE layer) and its input in a prefill of
    ``prompt``: the float32 per-token reference, tokens that lost every
    expert == the shared experts, the router's top-k on the card against
    the CPU's (near ties only: the gap between the k-th and (k+1)-th
    logits), and the call's device ms beside the bytes it must read. At
    top-1 some tokens must drop."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    dev = params["embed"].device
    k = cfg.moe.top_k
    j = next(j for j in range(lm.super_period(cfg))
             if cfg.is_moe_layer(lm.n_prelude(cfg) + j))
    p1 = lm.tree_map(lambda a: a[0], params["blocks"])[f"pos{j}"]["moe"]
    with recorded_moe() as seen:
        lm.prefill(params, {"tokens": torch.as_tensor(prompt[None],
                                                      device=dev)},
                   cfg, DENSE_MAX_LEN)
    x = seen[0][0]
    n = x.shape[1]
    cap = moe_cap(cfg, n)
    y, lb = L.moe_ffn(x, p1, cfg)
    ref, keep, top = moe_reference(x, p1, cfg)
    shared = L.ffn(x, p1["shared"], "swiglu")
    dropped = ~keep.any(-1)
    out = {"tokens": n, "cap": cap, "drops": int((~keep).sum()),
           "drops_by_count": int(moe_drops(x, p1, cfg)),
           "lb_aux": float(lb),
           "dropped_equal_shared": bool(torch.equal(y[0, dropped],
                                                    shared[0, dropped])),
           "vs_f32_reference": rel_diff(y[0].float(), ref[0]),
           "tolerance_rel_l2": MOE_REF_RL2}
    # the router's top-k on the card against the CPU's (TF32 off)
    xc, rc = x[0].float().cpu(), p1["router"].cpu()
    logits_cpu = xc @ rc
    top_cpu = logits_cpu.topk(k, dim=-1).indices
    split = (top_cpu.sort(-1).values != top.cpu().sort(-1).values).any(
        -1).nonzero().flatten()
    vals = logits_cpu.topk(k + 1, dim=-1).values
    gaps = (vals[:, k - 1] - vals[:, k])
    out[f"router_top{k}_card_vs_cpu"] = {
        "disagree": int(split.numel()),
        "gaps_of_disagreements": [float(gaps[i]) for i in split],
        "smallest_gap": float(gaps.min()), "tie_bound": MOE_TIE_GAP}
    expert_bytes = sum(t.nbytes for t in p1["experts"].values())
    other = p1["router"].nbytes + tree_bytes(p1["shared"])
    out["ms"] = {
        "prefill": device_ms(lambda: L.moe_ffn(x, p1, cfg), 5)[0],
        "decode_B4": device_ms(lambda: L.moe_ffn(
            x[:, :4].transpose(0, 1), p1, cfg), 5)[0],
        "bound": (expert_bytes + other) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes (all experts' weights, read once)"}
    if not ((out["drops"] > 0 or k > 1)
            and out["drops"] == out["drops_by_count"]
            and out["dropped_equal_shared"]):
        raise AssertionError(f"moe_ffn: the drops on {n} tokens at cap {cap} "
                             f"are not what the reference rebuilt: {out}")
    if not out["vs_f32_reference"]["rel_l2"] <= MOE_REF_RL2:
        raise AssertionError(f"moe_ffn: bf16 output vs the float32 "
                             f"reference beyond {MOE_REF_RL2}: {out}")
    if not all(g < MOE_TIE_GAP for g in
               out[f"router_top{k}_card_vs_cpu"]["gaps_of_disagreements"]):
        raise AssertionError(f"router top-{k}: a card/CPU disagreement is "
                             f"not a near tie: "
                             f"{out[f'router_top{k}_card_vs_cpu']}")
    return out


def lm_weights(dev, cfg) -> tuple:
    """``cfg``'s bf16 weights from seed 0 drawn on ``dev``, and their
    seconds, counts, bytes and the init's peak memory."""
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(SEED, cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    return params, {"init_s": time.perf_counter() - t0,
                    "params": sum(a.numel() for a in leaves(params)),
                    "param_count": cfg.param_count(),
                    "param_bytes": tree_bytes(params),
                    "init_peak_bytes": torch.cuda.max_memory_allocated()}


def served_model(dev, cfg, seed_offset: int, repeat_equal: bool = False
                 ) -> tuple:
    """Phases 16-18's serving part: ``cfg``'s bf16 weights from seed 0
    drawn on ``dev`` (the seconds, parameter counts, bytes and init peak),
    two long prompts from seed SEED + ``seed_offset``, and `serve_dense`
    with the port kernels it launched, its seconds and the peak memory.
    Returns (params, out, rng, long_prompts)."""
    from repro_torch import kernels
    params, out = lm_weights(dev, cfg)
    out["active_param_count"] = cfg.active_param_count()
    rng = np.random.default_rng(SEED + seed_offset)
    long_prompts = [rng.integers(0, cfg.vocab_size, DENSE_LONG)
                    for _ in range(2)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out["serve"] = serve_dense(dev, cfg, params, cfg.arch_id, long_prompts,
                               repeat_equal=repeat_equal)
    out["seconds"] = {"init": out["init_s"],
                      "serve": time.perf_counter() - t0}
    out["port_kernel_launches"] = {k: v for k, v in
                                   kernels.LAUNCH_COUNTS.items() if v}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    free_cuda()
    return params, out, rng, long_prompts


def phase_moe(dev, cfg) -> dict:
    """Phase 16: ``cfg`` (llama4-maverick at every published width, cut to
    one dense/MoE super-block) with bf16 weights from seed 0 drawn on
    ``dev``: (a) served by ServeEngine as phase 14 serves (eager and
    graphed drains, buckets 8, 16 and 1,024, TTFT, a profiled drain), the
    peak memory, each prefill's drops and a decode tick's bound; (b)
    `moe_ffn` at full width against its references."""
    params, out, rng, long_prompts = served_model(dev, cfg, 3)
    # the bytes a decode tick must read: every weight but the embedding's
    # unread rows (the dense bucket product touches all experts)
    tick = out["param_bytes"] - params["embed"].nbytes + 4 * cfg.d_model * 2
    out["decode_tick_bound"] = {
        "bytes": tick, "ms": tick / PEAK_BYTES_PER_S * 1e3,
        "measured_ms": out["serve"]["decode_tick_ms"]}
    out["prefill_drops"] = prefill_drops(params, cfg, long_prompts)
    out["moe_ffn"] = moe_ffn_checks(
        params, cfg, rng.integers(0, cfg.vocab_size, MOE_PROMPT))
    del params
    free_cuda()
    return out


def print_moe(moe: dict, cfg, card: str) -> None:
    """Phase 16's lines."""
    srv = moe.pop("serve")
    comp = srv.pop("compiled")
    f = moe.pop("moe_ffn")
    print(f"[phase 16] (a) {cfg.arch_id} at full width cut to {cfg.n_layers}"
          f" of 48 layers (one dense/MoE super-block): {moe['params']} "
          f"params (bf16, {moe['param_bytes']} bytes) drawn on the card in "
          f"{moe['init_s']:.2f} s (init peak {moe['init_peak_bytes']} "
          f"bytes); eager engine: 8 requests (6 of 4 to 16 tokens, 2 of "
          f"{DENSE_LONG}) x {LM_NEW} tokens, 4 slots, {srv['tokens_per_s']:.2f}"
          f" tokens/s, every logit finite ({srv['logits_checked']} calls); "
          f"buckets {srv['buckets']}; port kernel launches "
          f"{moe['port_kernel_launches'] or 'none (no kernel on this path)'}")
    print(f"[phase 16] (a) compiled engine == eager engine, token for token; "
          f"tokens/s (median of 3 in turns): eager "
          f"{comp['eager']['tokens_per_s']:.2f}, graphed "
          f"{comp['graphed']['tokens_per_s']:.2f}; device idle eager "
          f"{comp['eager']['device_idle_share']:.3f}, graphed "
          f"{comp['graphed']['device_idle_share']:.3f}; time to first token "
          f"(ms): {json.dumps(srv['ttft_ms'])}; peak {moe['peak_bytes']} "
          f"bytes ({card})")
    print(f"[phase 16] (a) decode tick: {srv['decode_tick_ms']:.3f} ms a "
          f"graph replay against a bound of "
          f"{moe['decode_tick_bound']['ms']:.3f} ms "
          f"({moe['decode_tick_bound']['bytes']} bytes at 3.35 TB/s: all "
          f"{cfg.moe.n_experts} experts' weights are read) ({card})")
    print(f"[phase 16] (a) drops of each bucketed prefill's MoE layer: "
          f"{json.dumps(moe['prefill_drops'])}")
    print(f"[phase 16] (a) drains and profiled top ops: {json.dumps(comp)} "
          f"({card})")
    print(f"[phase 16] (b) moe_ffn at full width on layer 1's input in a "
          f"{f['tokens']}-token prefill (cap {f['cap']}, {f['drops']} "
          f"dropped): vs the float32 "
          f"per-token reference rel L2 "
          f"{f['vs_f32_reference']['rel_l2']:.3e} (tol {MOE_REF_RL2}); "
          f"dropped tokens == the shared expert bit for bit; router top-1 "
          f"card vs CPU: {json.dumps(f['router_top1_card_vs_cpu'])}: ok")
    print(f"[phase 16] (b) moe_ffn device ms: {json.dumps(f['ms'])} ({card})")


# ---------------------------------------------------------------------------
# Phase 17: deepseek-v2-lite (MLA, the dense prelude, top-6) at full depth
# ---------------------------------------------------------------------------

def rope_f32(x, positions, theta: float):
    """RoPE in float32 from its formula (rotate the two halves of the last
    axis by position x 1 / theta^(2i/D)); x (T, ..., D), positions (T,)."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                         dtype=torch.float64) / D)
    ang = (positions.double()[:, None] * freqs).float()
    ang = ang.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (D // 2,))
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], dim=-1)


def mla_absorbed(h, p, cfg, positions, cache_rows=None):
    """A float32 reference of `mla_attention` for one row, h (T, d), in
    the absorbed form (no per-head K or V is formed): scores = (q_nope
    W_uk^T) . c + q_rope . k_rope over the latent (c, k_rope), out = (P c)
    W_uv W_o, from the bf16 weights. ``cache_rows`` (S, r + rope): latent
    rows before the T new ones (decode); the queries sit at ``positions``
    and attend causally. Not on any serving path: a check only."""
    m = cfg.mla
    nh, r, nope, rd, vd = (cfg.n_heads, m.kv_lora_rank, m.nope_head_dim,
                           m.rope_head_dim, m.v_head_dim)
    W = {k: v.float() for k, v in p.items()}
    hf = h.float()
    T = hf.shape[0]
    q = (hf @ W["wq"]).reshape(T, nh, nope + rd)
    q_nope, q_rope = q[..., :nope], rope_f32(q[..., nope:], positions,
                                             cfg.rope_theta)
    lat = hf @ W["w_dkv"]
    lat = torch.cat([lat[:, :r], rope_f32(lat[:, r:], positions,
                                          cfg.rope_theta)], dim=-1)
    if cache_rows is not None:
        lat = torch.cat([cache_rows.float(), lat])
    c, kr = lat[:, :r], lat[:, r:]
    q_abs = torch.einsum("thn,rhn->thr", q_nope, W["w_uk"].reshape(r, nh,
                                                                   nope))
    scores = (torch.einsum("thr,sr->hts", q_abs, c)
              + torch.einsum("thd,sd->hts", q_rope, kr)) / math.sqrt(nope + rd)
    kpos = torch.arange(lat.shape[0], device=h.device)
    scores = torch.where(positions[:, None] >= kpos[None], scores, -1e30)
    ctx = torch.einsum("hts,sr->thr", torch.softmax(scores, -1), c)
    o = torch.einsum("thr,rhv->thv", ctx, W["w_uv"].reshape(r, nh, vd))
    return o.reshape(T, nh * vd) @ W["wo"]


def mla_checks(params, cfg, prompt: np.ndarray, nxt: int) -> dict:
    """Phase 17(b): `mla_attention` at full width on layer 0's weights and
    its attention input for ``prompt`` (1, T): the prefill against the
    float32 absorbed reference, a decode step of ``nxt`` over the bf16
    cache the prefill leaves against the reference over those cached
    rows, and that decode against the prefill of the prompt plus ``nxt``
    (its last row); and the device ms of each."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    dev = params["embed"].device
    p0 = params["prelude"][0]
    toks = torch.as_tensor(np.append(prompt, nxt)[None], device=dev)
    h = lm._norm(params["embed"][toks], p0["norm1"], cfg)     # (1, T+1, d)
    T = len(prompt)
    pos = torch.arange(T + 1, device=dev)
    out, latent = L.mla_attention(h[:, :T], p0["attn"], cfg, pos[None, :T])
    cache = torch.zeros((1, DENSE_MAX_LEN, latent.shape[-1]),
                        dtype=torch.bfloat16, device=dev)
    cache[:, :T].copy_(latent)
    step = torch.tensor([T], device=dev)
    dec, _ = L.mla_attention(h[:, T:], p0["attn"], cfg, step[:, None],
                             latent_cache=cache, pos=step)
    full, _ = L.mla_attention(h, p0["attn"], cfg, pos[None])
    res = {"T": T,
           "prefill_vs_f32_absorbed": rel_diff(
               out[0], mla_absorbed(h[0, :T], p0["attn"], cfg, pos[:T])),
           "decode_vs_f32_absorbed": rel_diff(
               dec[0], mla_absorbed(h[0, T:], p0["attn"], cfg, pos[T:],
                                    cache_rows=cache[0, :T])),
           "decode_vs_prefill_plus_one": rel_diff(dec[0], full[0, T:]),
           "tolerance_rel_l2": MLA_REF_RL2}
    res["ms"] = {
        "prefill": device_ms(lambda: L.mla_attention(
            h[:, :T], p0["attn"], cfg, pos[None, :T]), 5)[0],
        "decode_B1_S%d" % DENSE_MAX_LEN: device_ms(lambda: L.mla_attention(
            h[:, T:], p0["attn"], cfg, step[:, None], latent_cache=cache,
            pos=step), 5)[0]}
    bad = {k: v for k, v in res.items() if isinstance(v, dict)
           and "rel_l2" in v and not v["rel_l2"] <= MLA_REF_RL2}
    if bad:
        raise AssertionError(f"mla_attention beyond {MLA_REF_RL2} relative "
                             f"L2: {bad}")
    return res


def phase_mla(dev, cfg) -> dict:
    """Phase 17: ``cfg`` (deepseek-v2-lite at every published width and
    all its layers) with bf16 weights from seed 0 drawn on ``dev``: (a)
    served by ServeEngine as phase 16 serves, each prompt prefilled at its
    exact length (MLA is not bucketed), two eager drains equal token for
    token, the latent cache's bytes against the per-head K/V it stands
    for, the peak memory, each prefill's drops in its MoE layers and a
    decode tick against its bound; (b) top-6 `moe_ffn` and
    `mla_attention` at full width against float32 references that do not
    share their code, and the model's decode against a prefill of one
    more token (bf16, reported)."""
    params, out, rng, long_prompts = served_model(dev, cfg, 4,
                                                  repeat_equal=True)
    m = cfg.mla
    per_token_layer = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim
                                     + m.v_head_dim)
    latent_bytes = out["serve"]["kv_cache_bytes"]
    kv_bytes = cfg.n_layers * 4 * DENSE_MAX_LEN * per_token_layer * 2
    out["latent_cache"] = {
        "bytes": latent_bytes, "per_head_kv_bytes": kv_bytes,
        "ratio": kv_bytes / latent_bytes,
        "per_token_layer": {"latent": m.kv_lora_rank + m.rope_head_dim,
                            "per_head_kv": per_token_layer}}
    # a decode tick must read every weight but the embedding's unread rows
    # (the dense bucket product reads all experts) and the latent cache;
    # its products re-expand the latent to per-head K and V in every layer
    tick = (out["param_bytes"] - params["embed"].nbytes + 4 * cfg.d_model * 2
            + latent_bytes)
    flops = 2 * cfg.n_layers * 4 * DENSE_MAX_LEN * m.kv_lora_rank * (
        cfg.n_heads * (m.nope_head_dim + m.v_head_dim))
    out["decode_tick_bound"] = {
        "bytes": tick, "ms_bytes": tick / PEAK_BYTES_PER_S * 1e3,
        "reexpand_flops": flops, "ms_flops": flops / PEAK_BF16_FLOPS * 1e3,
        "measured_ms": out["serve"]["decode_tick_ms"]}
    out["decode_tick_bound"]["ms"] = max(out["decode_tick_bound"]["ms_bytes"],
                                         out["decode_tick_bound"]["ms_flops"])
    t0 = time.perf_counter()
    out["prefill_drops"] = prefill_drops(params, cfg, long_prompts)
    prompt = rng.integers(0, cfg.vocab_size, MLA_PROMPT)
    out["moe_ffn"] = moe_ffn_checks(params, cfg, prompt)
    out["mla"] = mla_checks(params, cfg, prompt,
                            int(rng.integers(0, cfg.vocab_size)))
    out["bf16_prefill_vs_decode"] = prefill_vs_decode(params, cfg,
                                                      long_prompts[0])
    out["seconds"]["checks"] = time.perf_counter() - t0
    del params
    free_cuda()
    return out


def print_mla(res: dict, cfg, card: str) -> None:
    """Phase 17's lines."""
    from repro_torch.models import lm
    srv = res.pop("serve")
    comp = srv.pop("compiled")
    f = res.pop("moe_ffn")
    a = res.pop("mla")
    lat = res["latent_cache"]
    b = res["decode_tick_bound"]
    print(f"[phase 17] (a) {cfg.arch_id} at every published width and all "
          f"{cfg.n_layers} layers (MLA, {lm.n_prelude(cfg)} dense prelude "
          f"layer, {cfg.n_layers - lm.n_prelude(cfg)} MoE layers "
          f"of {cfg.moe.n_experts} experts at top-{cfg.moe.top_k} plus "
          f"{cfg.moe.n_shared_experts} shared): {res['params']} params (bf16, "
          f"{res['param_bytes']} bytes) drawn on the card in "
          f"{res['init_s']:.2f} s (init peak {res['init_peak_bytes']} bytes);"
          f" eager engine: 8 requests (6 of 4 to 16 tokens, 2 of "
          f"{DENSE_LONG}) x {LM_NEW} tokens, 4 slots, "
          f"{srv['tokens_per_s']:.2f} tokens/s, every logit finite "
          f"({srv['logits_checked']} calls), two eager drains equal token "
          f"for token; exact-length prefills {srv['buckets']}; port kernel "
          f"launches "
          f"{res['port_kernel_launches'] or 'none (no kernel on this path)'}")
    print(f"[phase 17] (a) compiled engine == eager engine, token for token; "
          f"tokens/s (median of 3 in turns): eager "
          f"{comp['eager']['tokens_per_s']:.2f}, graphed "
          f"{comp['graphed']['tokens_per_s']:.2f}; device idle eager "
          f"{comp['eager']['device_idle_share']:.3f}, graphed "
          f"{comp['graphed']['device_idle_share']:.3f}; time to first token "
          f"per prompt length (ms): {json.dumps(srv['ttft_ms'])}; peak "
          f"{res['peak_bytes']} bytes ({card})")
    print(f"[phase 17] (a) latent cache {lat['bytes']} bytes ({cfg.n_layers} "
          f"layers x 4 slots x {DENSE_MAX_LEN} x "
          f"{lat['per_token_layer']['latent']} x 2) against "
          f"{lat['per_head_kv_bytes']} bytes of the per-head K/V it stands "
          f"for ({lat['per_token_layer']['per_head_kv']} a token and layer):"
          f" {lat['ratio']:.2f}x smaller")
    print(f"[phase 17] (a) decode tick: {srv['decode_tick_ms']:.3f} ms a "
          f"graph replay against a bound of {b['ms']:.3f} ms ({b['bytes']} "
          f"bytes at 3.35 TB/s: every weight, all experts included, and the "
          f"latent cache; the re-expansion's {b['reexpand_flops']} bf16 "
          f"FLOPs take {b['ms_flops']:.3f} ms at 989 TFLOP/s) ({card})")
    print(f"[phase 17] (a) drops of each exact-length prefill's MoE layers "
          f"(cap {moe_cap(cfg, DENSE_LONG)} at {DENSE_LONG} tokens): "
          f"{json.dumps(res['prefill_drops'])}")
    print(f"[phase 17] (a) drains and profiled top ops: {json.dumps(comp)} "
          f"({card})")
    k = cfg.moe.top_k
    print(f"[phase 17] (b) moe_ffn top-{k} at full width on layer 1's input "
          f"in a {f['tokens']}-token prefill (cap {f['cap']}, {f['drops']} "
          f"(token, choice) pairs dropped): vs the float32 per-token "
          f"reference rel L2 {f['vs_f32_reference']['rel_l2']:.3e} (tol "
          f"{MOE_REF_RL2}); router top-{k} card vs CPU (gap of the k-th "
          f"and (k+1)-th logits): "
          f"{json.dumps(f[f'router_top{k}_card_vs_cpu'])}: ok; device ms "
          f"{json.dumps(f['ms'])} ({card})")
    print(f"[phase 17] (b) mla_attention at full width on layer 0 (T = "
          f"{a['T']}), bf16 vs the float32 absorbed-form reference (tol "
          f"{MLA_REF_RL2} rel L2): prefill "
          f"{json.dumps(a['prefill_vs_f32_absorbed'])}, decode over the "
          f"cache {json.dumps(a['decode_vs_f32_absorbed'])}, decode vs "
          f"prefill of one more token "
          f"{json.dumps(a['decode_vs_prefill_plus_one'])}: ok; device ms "
          f"{json.dumps(a['ms'])} ({card})")
    print(f"[phase 17] (b) prefill of prompt + 1 vs prefill + decode_step, "
          f"bf16 at all {cfg.n_layers} layers (reported: the prefill routes "
          f"the last token after {DENSE_LONG} others under the capacity, the "
          f"decode routes it alone): "
          f"{json.dumps(res['bf16_prefill_vs_decode'])}")


# ---------------------------------------------------------------------------
# Phase 18: jamba-v0.1-52b's hybrid super-block (Mamba, attention 1 in 8,
# MoE every 2) at full width
# ---------------------------------------------------------------------------

def mamba_f64(h, p, cfg) -> tuple:
    """A float64 step-by-step reference of `mamba.mamba_forward` on one
    row, h (T, d), from the bf16 weights and a zero state: the in
    projection, the causal conv tap by tap, silu, dt = log(1 + exp(.)),
    then h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t and y_t = h_t . C_t + D
    x_t one step at a time, gated by silu(z), out projection. Returns (out
    (T, d), conv state (d_conv - 1, d_in), SSM state (d_in, N)). Not on
    any serving path: a check only."""
    s = cfg.ssm
    W = {k: v.double() for k, v in p.items()}
    x = h.double()
    T = x.shape[0]
    xs, z = (x @ W["in_proj"]).chunk(2, dim=-1)
    d_in = xs.shape[1]
    xp = torch.cat([torch.zeros((s.d_conv - 1, d_in), dtype=torch.float64,
                                device=x.device), xs])
    u = W["conv_b"] + sum(xp[i:i + T] * W["conv_w"][i]
                          for i in range(s.d_conv))
    u = u * torch.sigmoid(u)
    dt_r, b_mat, c_mat = (u @ W["x_proj"]).split(
        [s.dt_rank, s.d_state, s.d_state], dim=-1)
    dt = torch.logaddexp(dt_r @ W["dt_proj"] + W["dt_bias"],
                         torch.zeros((), dtype=torch.float64, device=x.device))
    a = -torch.exp(W["a_log"])                                # (d_in, N)
    state = torch.zeros((d_in, s.d_state), dtype=torch.float64,
                        device=x.device)
    ys = []
    for t in range(T):
        state = (torch.exp(dt[t, :, None] * a) * state
                 + (dt[t] * u[t])[:, None] * b_mat[t][None])
        ys.append(state @ c_mat[t])
    y = torch.stack(ys) + u * W["d_skip"]
    out = (y * z * torch.sigmoid(z)) @ W["out_proj"]
    return out, xs[-(s.d_conv - 1):], state


def mamba_checks(params, cfg, prompt: np.ndarray, nxt: int) -> dict:
    """Phase 18(b): `mamba_forward` at full width on layer 0's weights and
    its input for ``prompt`` (1, T): the output and the final conv and SSM
    states against the float64 recurrence; a prefill of T then
    `mamba_decode` of ``nxt`` against a prefill of T + 1 (its last row and
    its states); the device ms of each beside the least time of the
    prefill's work."""
    from repro_torch.models import lm
    from repro_torch.models import mamba as M
    dev = params["embed"].device
    p0 = lm.tree_map(lambda a: a[0], params["blocks"])["pos0"]
    pm = p0["ssm"]
    toks = torch.as_tensor(np.append(prompt, nxt)[None], device=dev)
    h = lm._norm(params["embed"][toks], p0["norm1"], cfg)     # (1, T+1, d)
    T = len(prompt)
    out, st = M.mamba_forward(h[:, :T], pm, cfg)
    ref, ref_conv, ref_ssm = mamba_f64(h[0, :T], pm, cfg)
    dec, st1 = M.mamba_decode(h[:, T:], pm, cfg, st)
    full, stf = M.mamba_forward(h, pm, cfg)
    res = {"T": T, "chunks": -(-T // M.CHUNK), "pad": (-T) % M.CHUNK,
           "vs_f64_recurrence": {
               "out": rel_diff(out[0], ref),
               "conv": rel_diff(st["conv"][0], ref_conv),
               "ssm": rel_diff(st["ssm"][0], ref_ssm)},
           "decode_vs_prefill_plus_one": {
               "out": rel_diff(dec[0, 0], full[0, T]),
               "conv": rel_diff(st1["conv"], stf["conv"]),
               "ssm": rel_diff(st1["ssm"], stf["ssm"])},
           "tolerance_rel_l2": MAMBA_REF_RL2}
    d = cfg.d_model
    weights = tree_bytes(pm)
    flops = 2 * T * sum(int(pm[k].numel()) for k in
                        ("in_proj", "x_proj", "dt_proj", "out_proj"))
    h4 = h[:, T:].expand(4, 1, d).contiguous()
    st4 = M.init_mamba_state(cfg, 4, torch.bfloat16, dev)
    res["ms"] = {
        "prefill": device_ms(lambda: M.mamba_forward(h[:, :T], pm, cfg),
                             3)[0],
        "decode_B4": device_ms(lambda: M.mamba_decode(h4, pm, cfg, st4),
                               10)[0],
        "prefill_bound": max((weights + 2 * T * d * 2) / PEAK_BYTES_PER_S,
                             flops / PEAK_BF16_FLOPS) * 1e3,
        "prefill_bound_by": ("operations (the four projections' bf16 "
                             "products)" if flops / PEAK_BF16_FLOPS
                             > (weights + 2 * T * d * 2) / PEAK_BYTES_PER_S
                             else "bytes (weights, input and output)"),
        "weights_bytes": weights}
    bad = {f"{k}/{leaf}": v for k in ("vs_f64_recurrence",
                                      "decode_vs_prefill_plus_one")
           for leaf, v in res[k].items() if not v["rel_l2"] <= MAMBA_REF_RL2}
    if bad or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"mamba_forward beyond {MAMBA_REF_RL2} relative "
                             f"L2 or not finite: {bad}")
    return res


def phase_jamba(dev, cfg) -> dict:
    """Phase 18: ``cfg`` (jamba-v0.1-52b at every published width, cut to
    one period-8 super-block) with bf16 weights from seed 0 drawn on
    ``dev``: (a) served by ServeEngine as phase 17 serves, each prompt
    prefilled at its exact length (a Mamba state would integrate the
    padding), two eager drains equal token for token, the recurrent
    state's bytes against the K/V those layers would hold, the peak
    memory, each prefill's drops in its MoE layers and a decode tick
    against its bound; (b) `mamba_forward` and `mamba_decode` at full
    width against a float64 recurrence and against each other."""
    from repro_torch.models import lm
    params, out, rng, long_prompts = served_model(dev, cfg, 5,
                                                  repeat_equal=True)
    blocks = lm.init_cache(cfg, 4, DENSE_MAX_LEN, device="meta")["blocks"]
    ssm = {j: c for j, c in blocks.items() if "ssm" in c}
    kv = {j: c for j, c in blocks.items() if "k" in c}
    state_bytes, kv_bytes = tree_bytes(ssm), tree_bytes(kv)
    out["recurrent_state"] = {
        "bytes": state_bytes, "layers": len(ssm), "lanes": 4,
        "kv_bytes_of_those_layers": len(ssm) * kv_bytes // len(kv),
        "attention_kv_bytes": kv_bytes, "max_len": DENSE_MAX_LEN}
    # a decode tick must read every weight but the embedding's unread rows
    # (the dense bucket product reads all experts) and the attention
    # layer's K/V, and read and write the Mamba layers' state
    tick = (out["param_bytes"] - params["embed"].nbytes + 4 * cfg.d_model * 2
            + kv_bytes + 2 * state_bytes)
    out["decode_tick_bound"] = {
        "bytes": tick, "ms": tick / PEAK_BYTES_PER_S * 1e3,
        "measured_ms": out["serve"]["decode_tick_ms"]}
    t0 = time.perf_counter()
    out["prefill_drops"] = prefill_drops(params, cfg, long_prompts)
    out["mamba"] = mamba_checks(params, cfg,
                                rng.integers(0, cfg.vocab_size, JAMBA_PROMPT),
                                int(rng.integers(0, cfg.vocab_size)))
    out["seconds"]["checks"] = time.perf_counter() - t0
    del params
    free_cuda()
    return out


def print_jamba(res: dict, cfg, card: str) -> None:
    """Phase 18's lines."""
    srv = res.pop("serve")
    comp = srv.pop("compiled")
    mb = res.pop("mamba")
    st = res["recurrent_state"]
    b = res["decode_tick_bound"]
    s = cfg.ssm
    print(f"[phase 18] (a) {cfg.arch_id} at every published width cut to "
          f"{cfg.n_layers} of 32 layers (one super-block: 7 Mamba layers of "
          f"d_inner {s.expand * cfg.d_model}, state {s.d_state}, conv "
          f"{s.d_conv}, dt rank {s.dt_rank}; attention at place "
          f"{cfg.attn_layer_offset}; MoE of {cfg.moe.n_experts} experts at "
          f"top-{cfg.moe.top_k} every 2): {res['params']} params (bf16, "
          f"{res['param_bytes']} bytes) drawn on the card in "
          f"{res['init_s']:.2f} s (init peak {res['init_peak_bytes']} bytes);"
          f" eager engine: 8 requests (6 of 4 to 16 tokens, 2 of "
          f"{DENSE_LONG}) x {LM_NEW} tokens, 4 slots, "
          f"{srv['tokens_per_s']:.2f} tokens/s, every logit finite "
          f"({srv['logits_checked']} calls), two eager drains equal token "
          f"for token; exact-length prefills {srv['buckets']}; port kernel "
          f"launches "
          f"{res['port_kernel_launches'] or 'none (no kernel on this path)'}")
    print(f"[phase 18] (a) compiled engine == eager engine, token for token; "
          f"tokens/s (median of 3 in turns): eager "
          f"{comp['eager']['tokens_per_s']:.2f}, graphed "
          f"{comp['graphed']['tokens_per_s']:.2f}; device idle eager "
          f"{comp['eager']['device_idle_share']:.3f}, graphed "
          f"{comp['graphed']['device_idle_share']:.3f}; time to first token "
          f"per prompt length (ms): {json.dumps(srv['ttft_ms'])}; peak "
          f"{res['peak_bytes']} bytes ({card})")
    print(f"[phase 18] (a) recurrent state {st['bytes']} bytes ({st['layers']}"
          f" Mamba layers x {st['lanes']} lanes: conv window and float32 SSM "
          f"state, whatever the length) against "
          f"{st['kv_bytes_of_those_layers']} bytes of K/V those layers would "
          f"hold at max_len {st['max_len']} (the attention layer's: "
          f"{st['attention_kv_bytes']})")
    print(f"[phase 18] (a) decode tick: {srv['decode_tick_ms']:.3f} ms a "
          f"graph replay against a bound of {b['ms']:.3f} ms ({b['bytes']} "
          f"bytes at 3.35 TB/s: every weight, all experts included, the K/V "
          f"cache, the state read and written) ({card})")
    print(f"[phase 18] (a) drops of each exact-length prefill's MoE layers "
          f"(cap {moe_cap(cfg, DENSE_LONG)} at {DENSE_LONG} tokens): "
          f"{json.dumps(res['prefill_drops'])}")
    print(f"[phase 18] (a) drains and profiled top ops: {json.dumps(comp)} "
          f"({card})")
    print(f"[phase 18] (b) mamba_forward at full width on layer 0 (T = "
          f"{mb['T']}: {mb['chunks']} chunks of 128, pad {mb['pad']}), bf16 "
          f"vs the float64 step-by-step recurrence (tol {MAMBA_REF_RL2} rel "
          f"L2): {json.dumps(mb['vs_f64_recurrence'])}; prefill of T then "
          f"mamba_decode vs prefill of T + 1: "
          f"{json.dumps(mb['decode_vs_prefill_plus_one'])}: ok; device ms "
          f"{json.dumps(mb['ms'])} ({card})")


# ---------------------------------------------------------------------------
# Phases 19-20: the encoder-decoder (whisper-large-v3) and vision-stub
# (llava-next-mistral-7b) families at every published width and full depth
# ---------------------------------------------------------------------------

def greedy_run(params, cfg, batch: dict, max_len: int, new: int,
               graphed: bool, window=None) -> tuple:
    """A prefill of ``batch``, then ``new`` greedy decode ticks, each
    reading its (B,) tokens on the host as the engine does: eager
    `lm.decode_step` calls, or (``graphed``) one `serve.graphed.Graphed`
    replay a tick, captured after the prefill over a static (B, 1) token
    buffer and the cache's leaves (the K/V, the length, ``enc_out``),
    which the graph writes in place. Only the ticks are timed (inside
    ``window``). Returns (tokens (B, new + 1), the prefill's first, as
    numpy; the ticks' seconds; {"finite": every logit of the prefill and
    of each tick finite, "prefill_len": the prefill's ``cache["len"]``,
    "cache": the prefill's cache as the ticks left it, "graph": the
    `Graphed` or None})."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import tree_leaves
    from repro_torch.serve.graphed import Graphed
    with torch.no_grad():
        logits, cache = lm.prefill(params, batch, cfg, max_len)
    dev = logits.device
    finite = torch.isfinite(logits).all().reshape(1).clone()
    prefill_len = cache["len"].tolist()
    toks = logits.argmax(-1)[:, None].clone()
    out = [toks[:, 0].cpu().numpy()]
    leaves_ = tree_leaves(cache)

    def body():
        lg, new_cache = lm.decode_step(params, toks, cache, cfg)
        for dst, src in zip(leaves_, tree_leaves(new_cache)):
            if src is not dst:
                dst.copy_(src)
        finite.logical_and_(torch.isfinite(lg).all())
        return lg.argmax(-1)
    graph = (Graphed(body, dev, keep=tuple(leaves_) + (finite,))
             if graphed else None)
    torch.cuda.synchronize()
    with window or contextlib.nullcontext(), torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(new):
            nxt = graph() if graphed else body()
            toks.copy_(nxt[:, None])
            out.append(nxt.cpu().numpy())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return (np.stack(out, axis=1), dt,
            {"finite": bool(finite.item()), "prefill_len": prefill_len,
             "cache": cache, "graph": graph})


def greedy_checks(params, cfg, batch: dict, max_len: int, new: int,
                  label: str, repeats: int = 3) -> dict:
    """Phases 19(a) and 20(a): two eager greedy runs and a graphed one
    (`greedy_run`), every logit finite, the three equal token for token
    and the graph replayed; then tokens/s of the ticks eager and graphed
    (median of ``repeats`` runs in turns), a profiled graphed run (idle
    share, top ops; the eager run's hundred thousand device ops would
    take the profiler many seconds), and the device ms of one graph
    replay. Returns the figures and the graphed run's (cache, prefill
    length)."""
    eager = [greedy_run(params, cfg, batch, max_len, new, False)
             for _ in range(2)]
    toks, _, g = greedy_run(params, cfg, batch, max_len, new, True)
    if not all(run[2]["finite"] for run in eager) or not g["finite"]:
        raise AssertionError(f"{label}: a non-finite logit")
    if not np.array_equal(eager[0][0], eager[1][0]):
        raise AssertionError(f"{label}: two eager runs gave other tokens")
    if not np.array_equal(toks, eager[0][0]):
        raise AssertionError(f"{label}: the graphed ticks gave other tokens "
                             "than the eager ones")
    if g["graph"] is None or g["graph"].graph is None:
        raise AssertionError(f"{label}: no graph was replayed")
    B = toks.shape[0]
    times = {"eager": [], "graphed": []}
    for i in range(repeats):
        for mode in (("eager", "graphed") if i % 2 == 0
                     else ("graphed", "eager")):
            times[mode].append(greedy_run(params, cfg, batch, max_len, new,
                                          mode == "graphed")[1])
    out = {"B": B, "new_tokens": new, "first_tokens": toks[:, :4].tolist(),
           "len_after_ticks": g["cache"]["len"].tolist()}
    for mode in times:
        out[mode] = {"tokens_per_s": B * new / float(np.median(times[mode])),
                     "s": times[mode]}
    prof = profile_drain(greedy_run, params, cfg, batch, max_len, new, True)
    out["graphed"].update({
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "device_ops": prof["device_ops"], "profiled_wall_ms": prof["wall_ms"],
        "top": prof["top"]})
    # one replay's device ms: the replays advance the lanes past the run
    # (13 more positions), and nothing reads them after
    out["replay_ms"] = device_ms(g["graph"], 10)[0]
    return out, g["cache"], g["prefill_len"]


def first_token_ms(params, cfg, batch: dict, max_len: int,
                   repeats: int = 3) -> float:
    """Median ms from a batch to its first tokens on the host: the
    prefill and the argmax read."""
    from repro_torch.models import lm
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = lm.prefill(params, batch, cfg, max_len)
        logits.argmax(-1).cpu()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def decode_bound(params, cfg, B: int, kv_len: int, enc_len: int = 0
                 ) -> dict:
    """Least time of one decode tick at ``kv_len`` cached positions, the
    larger of its bytes at 3.35 TB/s and its operations: every weight but
    the embedding's unread rows (a tied embedding is read whole as the
    head), the K/V read and one position written, ``enc_out`` read once,
    the float32 logits written; bf16 products (the block weights, JAX's
    per-tick cross K and V projections of the ``enc_len`` encoder
    positions) at 989 TFLOP/s, float32 ones (the head, the attention
    scores and sums) at 67 TFLOP/s."""
    from repro_torch.models import lm
    d, hd = cfg.d_model, cfg.head_dim
    blocks = tree_bytes(params["blocks"])
    head = params["embed"].nbytes if cfg.tie_embeddings else tree_bytes(
        params["lm_head"])
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    kv = 2 * n_attn * B * (kv_len + 1) * cfg.n_kv_heads * hd * 2
    moved = (blocks + head + B * d * 2 + kv + B * enc_len * d * 2
             + B * cfg.vocab_size * 4)
    mats = sum(a.numel() for a in leaves(params["blocks"]) if a.dim() == 3)
    bf16 = 2 * B * mats
    cross = 0
    if cfg.is_encoder_decoder:
        cross = 2 * 2 * B * enc_len * d * d * cfg.n_layers
        bf16 += cross
    f32 = 2 * B * cfg.vocab_size * d + 4 * n_attn * B * cfg.n_heads * hd * (
        kv_len + 1 + enc_len)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = (bf16 / PEAK_BF16_FLOPS + f32 / PEAK_F32_OPS_PER_S) * 1e3
    return {"ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": moved, "bytes_ms": t_bytes, "bf16_flops": bf16,
            "cross_kv_flops": cross, "f32_flops": f32, "ops_ms": t_ops,
            "kv_len": kv_len, "B": B}


def f64_attention(x, p, cfg, kv_x) -> torch.Tensor:
    """Cross-attention from its formula in float64: q from ``x``, K and V
    from ``kv_x``, softmax(q k / sqrt(D)) v, no mask, out projection."""
    W = {k: v.double() for k, v in p.items()}
    B, T, _ = x.shape
    S, D = kv_x.shape[1], cfg.head_dim
    q = (x.double() @ W["wq"]).reshape(B, T, -1, D)
    k = (kv_x.double() @ W["wk"]).reshape(B, S, -1, D)
    v = (kv_x.double() @ W["wv"]).reshape(B, S, -1, D)
    probs = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) / D ** 0.5,
                          dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, -1) @ W[
        "wo"]


def whisper_f32_checks(dev, cfg, batch: dict) -> dict:
    """Phase 19(b): float32 weights from seed 0 at full width and depth,
    lane 0 of the batch (frames as float32): a prefill of the prompt
    less its last token then a decode step of it against a prefill of the
    whole prompt (the logits), and layer 0's `attention(kv_x=)` on the
    encoder's output against `f64_attention`."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    params = lm.init_params(SEED, cfg, dtype=torch.float32, device=dev)
    frames = batch["frames"][:1].float()
    toks = batch["tokens"][:1].long()
    T = toks.shape[1]
    with torch.no_grad():
        full, cache = lm.prefill(params, {"frames": frames, "tokens": toks},
                                 cfg, WHISPER_MAX_LEN)
        _, part = lm.prefill(params, {"frames": frames,
                                      "tokens": toks[:, :-1]},
                             cfg, WHISPER_MAX_LEN)
        dec, _ = lm.decode_step(params, toks[:, -1:], part, cfg)
        p0 = lm.tree_map(lambda a: a[0], params["blocks"])["pos0"]
        x = params["embed"][toks] + L.sinusoidal_positions(
            T, cfg.d_model).to(dev)[None]
        x = lm._norm(x, p0["norm_cross"], cfg)
        enc = cache["enc_out"]
        got = L.attention(x, p0["cross"], cfg,
                          torch.arange(T, device=dev)[None], causal=False,
                          kv_x=enc)
        want = f64_attention(x, p0["cross"], cfg, enc)
    out = {"T": T, "prefill_vs_decode": logit_diff(dec, full),
           "cross_attention_vs_f64": rel_diff(got, want),
           "tolerance": {"prefill_vs_decode_rel_l2": F32_DECODE_L2,
                         "cross_attention_rel_l2": ATTN_F64_L2}}
    d = out["prefill_vs_decode"]
    if not (d["rel_l2"] <= F32_DECODE_L2 and d["max_rel"] <= F32_DECODE_L2):
        raise AssertionError(f"whisper float32: prefill of T + 1 and prefill "
                             f"+ decode differ beyond {F32_DECODE_L2}: {d}")
    if not out["cross_attention_vs_f64"]["rel_l2"] <= ATTN_F64_L2:
        raise AssertionError(f"attention(kv_x=) beyond {ATTN_F64_L2} of the "
                             f"float64 reference: {out}")
    del params
    free_cuda()
    return out


def phase_whisper(dev, cfg) -> dict:
    """Phase 19: ``cfg`` (whisper-large-v3, every width, 32 encoder and 32
    decoder layers) with bf16 weights from seed 0 drawn on ``dev``: (a) a
    `prefill_batch_spec` batch (B = WHISPER_B, WHISPER_FRAMES frames, the
    decoder prompt of frames // 8 tokens) from `io_spec.materialize(seed
    = 0)`, WHISPER_NEW greedy tokens eager (twice) and graphed, the time
    to the first token split into the encoder and the decoder prefill, the
    cache's bytes, the peak memory and one replay against its bound; (b)
    the float32 checks."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import io_spec, lm
    params, out = lm_weights(dev, cfg)
    t0 = time.perf_counter()
    batch = io_spec.materialize(io_spec.prefill_batch_spec(
        cfg, ShapeConfig("whisper_30s", WHISPER_FRAMES, WHISPER_B,
                         "prefill")), seed=SEED, device=dev)
    kernels.reset_launch_counts()
    res, cache, _ = greedy_checks(params, cfg, batch, WHISPER_MAX_LEN,
                                  WHISPER_NEW, cfg.arch_id)
    out["port_kernel_launches"] = {k: v for k, v in
                                   kernels.LAUNCH_COUNTS.items() if v}
    out["greedy"] = res
    with torch.no_grad():
        enc = lm._run_encoder(params, batch["frames"], cfg)
    if not torch.equal(enc, cache["enc_out"]):
        raise AssertionError("whisper: cache['enc_out'] is not the "
                             "encoder's output")
    T = batch["tokens"].shape[1]
    enc_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            lm._run_encoder(params, batch["frames"], cfg)
        torch.cuda.synchronize()
        enc_times.append(time.perf_counter() - t1)
    ttft = first_token_ms(params, cfg, batch, WHISPER_MAX_LEN)
    enc_ms = 1e3 * float(np.median(enc_times))
    out["ttft_ms"] = {"total": ttft, "encoder": enc_ms,
                      "decoder_prefill": ttft - enc_ms}
    kv = {k: v for k, v in cache["blocks"]["pos0"].items()}
    out["cache_bytes"] = {
        "self_kv": tree_bytes(kv), "enc_out": cache["enc_out"].nbytes,
        "cached_cross_kv_would_hold": (2 * cfg.n_layers * WHISPER_B
                                       * WHISPER_FRAMES * cfg.d_model * 2)}
    out["replay_bound"] = decode_bound(
        params, cfg, WHISPER_B, T + WHISPER_NEW + 13, WHISPER_FRAMES)
    out["replay_bound"]["measured_ms"] = res["replay_ms"]
    out["prompt"] = {"frames": list(batch["frames"].shape),
                     "tokens": list(batch["tokens"].shape)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = {"bf16": time.perf_counter() - t0}
    del params, cache, enc
    free_cuda()
    t0 = time.perf_counter()
    out["f32"] = whisper_f32_checks(dev, cfg, batch)
    out["seconds"]["f32"] = time.perf_counter() - t0
    return out


def llava_cut_checks(dev, cfg) -> dict:
    """Phase 20(c): float32 weights from seed 0 at full width cut to
    LLAVA_CUT_LAYERS layers, one `prefill_batch_spec` row of LLAVA_CUT_SEQ
    (patches and tokens) from `io_spec.materialize`: the prefill on the
    card against the same port code on the CPU (logits and length), and
    a prefill less the last token then its decode step against the whole
    prefill."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import io_spec, lm
    cut = dataclasses.replace(cfg, n_layers=LLAVA_CUT_LAYERS)
    params = lm.init_params(SEED, cut, dtype=torch.float32, device=dev)
    batch = io_spec.materialize(io_spec.prefill_batch_spec(
        cut, ShapeConfig("llava_cut", LLAVA_CUT_SEQ, 1, "prefill")),
        seed=SEED, device=dev)
    n = batch["patches"].shape[1] + batch["tokens"].shape[1]
    max_len = n + 8
    with torch.no_grad():
        card, card_cache = lm.prefill(params, batch, cut, max_len)
        cpu_params = lm.tree_map(lambda a: a.cpu(), params)
        cpu, cpu_cache = lm.prefill(cpu_params,
                                    lm.tree_map(lambda a: a.cpu(), batch),
                                    cut, max_len)
        del cpu_params
        part = dict(batch, tokens=batch["tokens"][:, :-1])
        _, cache = lm.prefill(params, part, cut, max_len)
        dec, _ = lm.decode_step(params, batch["tokens"][:, -1:].long(),
                                cache, cut)
    out = {"layers": LLAVA_CUT_LAYERS, "patches": batch["patches"].shape[1],
           "tokens": batch["tokens"].shape[1],
           "card_vs_cpu": logit_diff(card.cpu(), cpu),
           "len": card_cache["len"].tolist(),
           "prefill_vs_decode": logit_diff(dec, card),
           "tolerance": {"card_vs_cpu_rel_l2": CARD_CPU_L2,
                         "prefill_vs_decode_rel_l2": F32_DECODE_L2}}
    d = out["card_vs_cpu"]
    if not (d["rel_l2"] <= CARD_CPU_L2 and d["argmax_equal"]
            and out["len"] == cpu_cache["len"].tolist() == [n]):
        raise AssertionError(f"llava float32 card vs CPU beyond "
                             f"{CARD_CPU_L2}: {out}")
    d = out["prefill_vs_decode"]
    if not (d["rel_l2"] <= F32_DECODE_L2 and d["max_rel"] <= F32_DECODE_L2):
        raise AssertionError(f"llava float32: prefill + decode and the whole "
                             f"prefill differ beyond {F32_DECODE_L2}: {d}")
    del params
    free_cuda()
    return out


def phase_llava(dev, cfg) -> dict:
    """Phase 20: ``cfg`` (llava-next-mistral-7b, every width, 32 layers)
    with bf16 weights from seed 0 drawn on ``dev``: (a) a
    `prefill_batch_spec` batch (B = LLAVA_B, LLAVA_SEQ positions: patches
    of `vision_patch_frac`, then the text) from `io_spec.materialize(seed
    = 0)`, LLAVA_NEW greedy tokens eager (twice) and graphed, ``len`` ==
    LLAVA_SEQ, the time to the first token, the peak memory and one
    replay against its bound; (b) `ServeEngine` text-only (4 requests of
    4 to 16 tokens x LM_NEW, 4 slots) compiled against eager, tokens/s;
    (c) the float32 checks at LLAVA_CUT_LAYERS layers."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import io_spec
    from repro_torch.serve import ServeEngine
    params, out = lm_weights(dev, cfg)
    t0 = time.perf_counter()
    batch = io_spec.materialize(io_spec.prefill_batch_spec(
        cfg, ShapeConfig("llava_4k", LLAVA_SEQ, LLAVA_B, "prefill")),
        seed=SEED, device=dev)
    kernels.reset_launch_counts()
    res, cache, prefill_len = greedy_checks(params, cfg, batch,
                                            LLAVA_MAX_LEN, LLAVA_NEW,
                                            cfg.arch_id)
    out["greedy"] = res
    if (prefill_len != [LLAVA_SEQ] * LLAVA_B
            or res["len_after_ticks"] != [LLAVA_SEQ + LLAVA_NEW] * LLAVA_B):
        raise AssertionError(f"llava: cache length {prefill_len} after the "
                             f"prefill of {LLAVA_SEQ} positions, "
                             f"{res['len_after_ticks']} after {LLAVA_NEW} "
                             "ticks")
    out["prompt"] = {"patches": list(batch["patches"].shape),
                     "tokens": list(batch["tokens"].shape),
                     "len_after_prefill": LLAVA_SEQ}
    out["ttft_ms"] = first_token_ms(params, cfg, batch, LLAVA_MAX_LEN)
    out["kv_cache_bytes"] = tree_bytes(cache["blocks"])
    del cache
    out["replay_bound"] = decode_bound(params, cfg, LLAVA_B,
                                       LLAVA_SEQ + LLAVA_NEW + 13)
    out["replay_bound"]["measured_ms"] = res["replay_ms"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = {"greedy": time.perf_counter() - t0}
    del batch
    free_cuda()
    t0 = time.perf_counter()
    drain, EagerEngine = lm_drainer(params, cfg, LLAVA_SERVE_MAX_LEN, [],
                                    n_short=4)
    served, dt, eng = drain()
    if len(served) != 4 or any(len(r.out_tokens) != LM_NEW for r in served):
        raise AssertionError("llava: the engine did not serve 4 requests x "
                             f"{LM_NEW} tokens")
    if not eng._bucket_prompts:
        raise AssertionError("llava: the engine did not bucket its prompts")
    out["serve"] = compiled_decode(drain, served, EagerEngine, ServeEngine,
                                   label=cfg.arch_id, profile=False)
    out["serve"]["buckets"] = sorted(eng._prefill_cache)
    out["serve"]["first_tokens"] = [r.out_tokens[:4] for r in served]
    out["port_kernel_launches"] = {k: v for k, v in
                                   kernels.LAUNCH_COUNTS.items() if v}
    out["seconds"]["serve"] = time.perf_counter() - t0
    del params, eng, drain
    free_cuda()
    t0 = time.perf_counter()
    out["f32_cut"] = llava_cut_checks(dev, cfg)
    out["seconds"]["f32_cut"] = time.perf_counter() - t0
    return out


def print_greedy(n: int, res: dict, card: str) -> None:
    """Phases 19(a) and 20(a)'s tokens/s, idle shares and profiled ops."""
    g = res["greedy"]
    print(f"[phase {n}] (a) greedy ticks, B = {g['B']} x {g['new_tokens']} "
          f"tokens: two eager runs and the graphed one (one Graphed replay a "
          f"tick) equal token for token, every logit finite; tokens/s "
          f"(median of 3 in turns): eager {g['eager']['tokens_per_s']:.2f}, "
          f"graphed {g['graphed']['tokens_per_s']:.2f}; device idle graphed "
          f"{g['graphed']['device_idle_share']:.3f}; peak "
          f"{res['peak_bytes']} bytes; port kernel launches "
          f"{res['port_kernel_launches'] or 'none (no kernel on this path)'}"
          f" ({card})")
    b = res["replay_bound"]
    print(f"[phase {n}] (a) decode tick: {g['replay_ms']:.3f} ms a graph "
          f"replay against a bound of {b['ms']:.3f} ms ({b['bound_by']}: "
          f"{b['bytes']} bytes at 3.35 TB/s = {b['bytes_ms']:.3f} ms; "
          f"{b['bf16_flops']:.4g} bf16 FLOP at 989 TFLOP/s + "
          f"{b['f32_flops']:.4g} float32 at 67 = {b['ops_ms']:.3f} ms) "
          f"({card})")
    print(f"[phase {n}] (a) runs and the graphed run's profiled top ops: "
          f"{json.dumps({k: g[k] for k in ('eager', 'graphed')})} ({card})")


def print_whisper(res: dict, cfg, card: str) -> None:
    """Phase 19's lines."""
    f32 = res.pop("f32")
    print(f"[phase 19] (a) {cfg.arch_id} at every published width and full "
          f"depth ({cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder "
          f"layers of {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"gelu d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied): "
          f"{res['params']} params (bf16, {res['param_bytes']} bytes) drawn "
          f"on the card in {res['init_s']:.2f} s; prompt {res['prompt']} "
          f"from io_spec.materialize(seed={SEED}), max_len "
          f"{WHISPER_MAX_LEN}; cache['enc_out'] == the encoder's output")
    print_greedy(19, res, card)
    t = res["ttft_ms"]
    c = res["cache_bytes"]
    print(f"[phase 19] (a) time to the first token {t['total']:.2f} ms: "
          f"encoder {t['encoder']:.2f}, decoder prefill "
          f"{t['decoder_prefill']:.2f} ({card}); cache: self K/V "
          f"{c['self_kv']} bytes, enc_out {c['enc_out']} bytes, against "
          f"{c['cached_cross_kv_would_hold']} bytes that cached cross K/V "
          f"would hold")
    print(f"[phase 19] (b) float32 at full width and depth, lane 0 (T = "
          f"{f32['T']}): prefill of T - 1 then decode vs prefill of T "
          f"{json.dumps(f32['prefill_vs_decode'])} (tol {F32_DECODE_L2}); "
          f"layer 0's attention(kv_x=) vs float64 "
          f"{json.dumps(f32['cross_attention_vs_f64'])} (tol {ATTN_F64_L2} "
          f"rel L2): ok")


def print_llava(res: dict, cfg, card: str) -> None:
    """Phase 20's lines."""
    cut = res.pop("f32_cut")
    srv = res.pop("serve")
    print(f"[phase 20] (a) {cfg.arch_id} at every published width and full "
          f"depth ({cfg.n_layers} layers of {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, SwiGLU {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}): {res['params']} params (bf16, "
          f"{res['param_bytes']} bytes) drawn on the card in "
          f"{res['init_s']:.2f} s; prompt {res['prompt']} from "
          f"io_spec.materialize(seed={SEED}), max_len {LLAVA_MAX_LEN}; time "
          f"to the first token {res['ttft_ms']:.2f} ms; K/V cache "
          f"{res['kv_cache_bytes']} bytes ({card})")
    print_greedy(20, res, card)
    print(f"[phase 20] (b) ServeEngine text-only (4 requests of 4 to 16 "
          f"tokens x {LM_NEW}, 4 slots, buckets {srv['buckets']}): compiled "
          f"== eager token for token; tokens/s (median of 3 in turns) eager "
          f"{srv['eager']['tokens_per_s']:.2f}, graphed "
          f"{srv['graphed']['tokens_per_s']:.2f} ({card})")
    print(f"[phase 20] (c) float32 at full width cut to {cut['layers']} "
          f"layers ({cut['patches']} patches + {cut['tokens']} tokens): card "
          f"vs CPU {json.dumps(cut['card_vs_cpu'])} (tol {CARD_CPU_L2}), "
          f"len {cut['len']}; prefill less one token + decode vs prefill "
          f"{json.dumps(cut['prefill_vs_decode'])} (tol {F32_DECODE_L2}): "
          f"ok")


def leaves(tree) -> list:
    """The tensors of a nested dict (and list)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


#: `check_cost_closure` of the two paper programs at batch 8, as the JAX
#: package's `trace_cost.check_cost_closure` gives them on the same
#: geometry (acc_w2v, acc_v2v, spike_check, reset_v)
CLOSURE_WANT = {"impulse-imdb": (421_760, 3_520, 3_520, 0),
                "impulse-mnist": (10_568_320, 89_120, 81_120, 0)}
#: the int_ref batch-surface cost (MACs, bytes) at batch 8, as JAX's
#: `build_cost_report` gives it on the same geometry
INT_REF_COST_WANT = {"impulse-imdb": (2_344_960, 66_016),
                     "impulse-mnist": (7_741_440, 198_112)}


def phase_trace(dev, phase4: dict) -> dict:
    """Phase 21: the trace pass of `validate_program` on the card (see the
    module docstring). ``phase4``: {(kernel name, B): phase 4's row}."""
    from repro_torch import kernels
    from repro_torch.analysis import (SURFACES, TRACE_BACKENDS,
                                      check_cost_closure, check_trace)
    from repro_torch.analysis import trace_check
    from repro_torch.analysis.trace_cost import dispatch_cost
    from repro_torch.configs.impulse_snn import IMDB, MNIST
    from repro_torch.core import pipeline, snn
    out = {"programs": {}, "phase4": []}
    for cfg, init in ((IMDB, snn.init_fc_snn), (MNIST, snn.init_lenet_snn)):
        params = init(SEED, cfg, device=dev)
        trace_check._TRACE_CACHE.clear()
        counts = dict(kernels.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.compile_network(cfg, params, domain="int", validate=False,
                                 device=dev)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = pipeline.compile_network(cfg, params, domain="int",
                                           validate=True, device=dev)
        validate_s = time.perf_counter() - t0
        reports = {b: check_trace(program, b) for b in TRACE_BACKENDS}
        if kernels.LAUNCH_COUNTS != counts:
            raise AssertionError(f"the trace pass moved the launch counts: "
                                 f"{counts} -> {kernels.LAUNCH_COUNTS}")
        n_calls = len(program.int_conv_stack) + 1
        # without a mesh, the three dispatch surfaces (phase 22's mesh
        # surface is traced below, on a 2 x 2 dict mesh)
        dispatch = {s for s in SURFACES if s != "mesh"}
        rows, f64, surfaces = {}, {}, {}
        for b, rep in reports.items():
            got = sorted((s.surface, s.call) for s in rep.surfaces)
            if {s for s, _ in got} != dispatch or \
                    len(got) != len(dispatch) * n_calls:
                raise AssertionError(f"{cfg.arch_id} {b}: surfaces {got}")
            want = 0 if b == "int_ref" else 1
            bad = [(s.surface, s.call, s.launches) for s in rep.surfaces
                   if len(s.launches) != want]
            if bad:
                raise AssertionError(f"{cfg.arch_id} {b}: kernel nodes "
                                     f"{bad}, want {want} a surface")
            rows[b] = [[c.prop, c.where, c.detail] for c in rep.checks]
            f64[b] = [c.detail for c in rep.checks
                      if c.prop == "float64_exact"]
            surfaces[b] = [[s.surface, s.call, s.clamps, s.spike_reads,
                            s.bounds_checked, s.eqns, list(s.launches)]
                           for s in rep.surfaces]
        mesh_ticks = {}
        for b in TRACE_BACKENDS:
            rep = check_trace(program, b, surfaces=("mesh",),
                              mesh={"data": 2, "model": 2})
            ticks = [(s.call, s.reductions, s.clamps, list(s.launches))
                     for s in rep.surfaces]
            if len(ticks) != 2 * n_calls or any(t[3] for t in ticks):
                raise AssertionError(f"{cfg.arch_id} {b}: mesh ticks {ticks}")
            mesh_ticks[b] = ticks
        if kernels.LAUNCH_COUNTS != counts:
            raise AssertionError("the mesh surface moved the launch counts")
        closure = tuple(check_cost_closure(program))
        if closure != CLOSURE_WANT[cfg.arch_id]:
            raise AssertionError(f"{cfg.arch_id} closure {closure} != "
                                 f"{CLOSURE_WANT[cfg.arch_id]}")
        cost = reports["int_ref"].cost
        if (cost.macs, cost.hbm_bytes) != INT_REF_COST_WANT[cfg.arch_id]:
            raise AssertionError(f"{cfg.arch_id} int_ref cost "
                                 f"{(cost.macs, cost.hbm_bytes)}")
        out["programs"][cfg.arch_id] = {
            "compile_validate_false_s": plain_s,
            "compile_validate_true_s": validate_s,
            "closure": list(closure),
            "cost": {b: [rep.cost.macs, rep.cost.hbm_bytes]
                     for b, rep in reports.items()},
            "float64_exact": f64, "surfaces": surfaces, "rows": rows,
            "mesh_ticks": mesh_ticks}
    for (name, B), row in phase4.items():
        cost = dispatch_cost(IMDB_WIDTHS, 10, B, v_init=True,
                             backend=BACKEND_OF[name], block_b=8,
                             gate_granularity=MODE_KW[name].get(
                                 "gate_granularity", 1), device=dev)
        hand = hand_net_bytes(10, B, IMDB_WIDTHS, readout=True, v_init=True,
                              emit_rasters=True,
                              counter_bytes=counter_bytes(name, B,
                                                          IMDB_WIDTHS, 8))
        dense = 10 * B * sum(a * b for a, b in zip(IMDB_WIDTHS[:-1],
                                                  IMDB_WIDTHS[1:]))
        if (cost.hbm_bytes, cost.macs) != (row["bytes"], row["dense_macs"]) \
                or cost.hbm_bytes != hand or cost.macs != dense:
            raise AssertionError(
                f"{name} B={B}: cost model {cost.hbm_bytes} bytes, "
                f"{cost.macs} MACs; phase 4 {row['bytes']}, "
                f"{row['dense_macs']}; formula {hand}, {dense}")
        out["phase4"].append({
            "name": name, "B": B, "bytes": cost.hbm_bytes,
            "dense_macs": cost.macs, "hand_bytes": hand,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "launches": list(cost.launches)})
    return out


def print_trace(res: dict, card: str) -> None:
    for arch, row in res["programs"].items():
        print(f"[phase 21] {arch}: compile_network(validate=True) "
              f"{row['compile_validate_true_s']:.2f} s (range, contract and "
              f"trace passes, memo empty) vs validate=False "
              f"{row['compile_validate_false_s']:.3f} s on the host of "
              f"{card}; LAUNCH_COUNTS unmoved; cost closure "
              f"{row['closure']}; cost (macs, bytes) per backend "
              f"{json.dumps(row['cost'])}")
        for b, details in row["float64_exact"].items():
            print(f"[phase 21] {arch} {b} float64_exact: "
                  f"{json.dumps(details)}")
        for b, surf in row["surfaces"].items():
            print(f"[phase 21] {arch} {b} surfaces (surface, call, clamps, "
                  f"SpikeCheck reads, bounds, nodes, kernel nodes): "
                  f"{json.dumps(surf)}")
        for b, rows in row["rows"].items():
            print(f"[phase 21] {arch} {b} rows: {json.dumps(rows)}")
        for b, ticks in row["mesh_ticks"].items():
            print(f"[phase 21] {arch} {b} mesh surface on a 2 x 2 mesh "
                  f"(call/rank, reductions, clamps, kernel nodes), traced "
                  f"for {card}: {json.dumps(ticks)}")
    for r in res["phase4"]:
        print(f"[phase 21] phase 4's {r['name']} at K=10, B={r['B']}: cost "
              f"model {r['bytes']} bytes, {r['dense_macs']} dense MACs == "
              f"phase 4's == the formula ({r['hand_bytes']} bytes); bound "
              f"{r['bound_ms']:.4e} ms ({r['bound_by']}); nodes "
              f"{r['launches']}")



# ---------------------------------------------------------------------------
# phase 22: the SNN mesh path (torch.distributed)
# ---------------------------------------------------------------------------

MESH_WORLD = 4                    # gloo ranks spawned on the one card
MESH_SHAPES = ((4, 1), (1, 4), (2, 2))
MESH_IMDB_B = 32
MESH_MNIST_B = 8
MESH_SLOTS = 8                    # a page of the (2, 2) serving drain
MESH_REQUESTS = 16
MESH_TIMEOUT_S = 300              # the four ranks together
MESH_KW = {"cuda_sparse": {"gate_granularity": GATE_G},
           "cuda_events": {"event_crossover": CROSSOVER}}


def mesh_cases(dev) -> dict:
    """The programs and inputs of phase 22, the same on every rank: the
    IMDB stack at full width (B = 32, 6 words x 10 frames) and
    impulse-mnist (weights and images from seeds)."""
    from repro_torch.configs.impulse_snn import IMDB, MNIST
    from repro_torch.core import pipeline, snn
    from repro_torch.data.synthetic import mnist_like_batch
    imdb = pipeline.compile_network(IMDB, snn.init_fc_snn(SEED, IMDB),
                                    domain="int", device=dev, validate=False)
    words = np.random.default_rng(SEED).random(
        (MESH_IMDB_B, 6, IMDB_WIDTHS[0])).astype(np.float32) * 1.6
    mnist = pipeline.compile_network(
        MNIST, snn.init_lenet_snn(SEED, MNIST, device=dev), domain="int",
        device=dev, validate=False)
    x = torch.from_numpy(mnist_like_batch(MESH_MNIST_B, SEED)[0]).to(dev)
    return {"impulse-imdb": (imdb, pipeline.present_words(
                torch.from_numpy(words).to(dev), IMDB.timesteps)),
            "impulse-mnist": (mnist, pipeline.present_static(
                x, MNIST.timesteps))}


def same_net(got, ref, n_model: int, tag: str) -> None:
    """A mesh `NetResult` against the single-device one, bit for bit: the
    rasters, every V, v_out, logits and every counter; above model extent
    1 the gate counters and dense fallbacks are absent by design."""
    for what, a, b in ([("raster", x, y) for x, y in zip(got.rasters,
                                                        ref.rasters)]
                       + [("V", x, y) for x, y in zip(got.v_final,
                                                      ref.v_final)]
                       + [("v_out", got.v_out, ref.v_out),
                          ("logits", got.logits, ref.logits)]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {what} differs from one device")
    if len(got.rasters) != len(ref.rasters):
        raise AssertionError(f"{tag}: {len(got.rasters)} rasters, not "
                             f"{len(ref.rasters)}")
    want = dict(ref.aux)
    if n_model > 1:
        for key in ("skip_counts", "skipped_tile_fraction",
                    "skipped_block_fraction", "conv_skip_counts",
                    "event_dense_fallbacks"):
            want.pop(key, None)
    if set(got.aux) != set(want):
        raise AssertionError(f"{tag}: aux keys {sorted(got.aux)} != "
                             f"{sorted(want)}")
    for key, b in want.items():
        a = got.aux[key]
        pairs = (list(zip(a, b)) if isinstance(b, (list, tuple))
                 else [(a, b)])
        for x, y in pairs:
            pairs2 = (list(zip(x, y)) if isinstance(y, list) else [(x, y)])
            if not all(np.array_equal(np.asarray(u), np.asarray(v))
                       for u, v in pairs2):
                raise AssertionError(f"{tag}: aux[{key!r}] differs from one "
                                     "device")


def mesh_net_runs(pipeline, kernels, cases, meshes, backends, tag) -> dict:
    """Each (program, mesh, backend): the single-device run, then the mesh
    run with the launch counts set to 0 just before it and read just
    after, held to it bit for bit. Returns the rows."""
    rows = {}
    for name, (program, xs) in cases.items():
        for backend, wanted in backends.items():
            shapes = [s for s in meshes if (name, s, backend) in wanted]
            if not shapes:
                continue
            kw = MESH_KW.get(backend, {})
            kernels.reset_launch_counts()
            ref = pipeline.run_network(program, xs, backend, **kw)
            ref_launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items()
                            if v}
            for shape in shapes:
                mesh = meshes[shape]
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                got = pipeline.run_network(program, xs, backend, mesh=mesh,
                                           **kw)
                if xs.device.type == "cuda":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items()
                            if v}
                same_net(got, ref, shape[1],
                         f"{tag} {name} {shape} {backend}")
                rows[f"{name} {shape[0]}x{shape[1]} {backend}"] = {
                    "s": dt, "launches": launches,
                    "single_device_launches": ref_launches}
    return rows


def mesh_rank(argv) -> int:
    """One of phase 22's gloo ranks: ``--mesh-rank RANK DIR [DEVICE]``.
    Joins the world through a FileStore in DIR, runs every mesh case on
    the card (or on ``cpu``, a rehearsal) against the single-device run,
    and writes DIR/rank<RANK>.json; a mismatch raises."""
    rank, out = int(argv[0]), Path(argv[1])
    device_type = argv[2] if len(argv) > 2 else "cuda"
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_snn import make_requests
    from repro_torch.serve import SNNServeEngine
    t0 = time.perf_counter()
    torch.set_num_threads(2)
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), MESH_WORLD),
        rank=rank, world_size=MESH_WORLD)
    meshes = {s: make_mesh(s, device_type=device_type) for s in MESH_SHAPES}
    cases = mesh_cases(dev)
    ping = torch.ones(1, dtype=torch.int32, device=dev)
    dist.all_reduce(ping)         # the first collective waits for every rank
    if int(ping) != MESH_WORLD:
        raise AssertionError(f"rank {rank}: a gloo all-reduce of ones on "
                             f"{dev} gave {int(ping)}")
    t_ready = time.perf_counter() - t0
    every = {("impulse-imdb", s, b) for s in MESH_SHAPES
             for b in INT_BACKENDS}
    conv = {("impulse-mnist", s, "cuda") for s in ((4, 1), (2, 2))}
    backends = {b: every | (conv if b == "cuda" else set())
                for b in INT_BACKENDS}
    rows = mesh_net_runs(pipeline, kernels, cases, meshes, backends,
                         f"rank {rank}")
    # a cuda_events serving drain on (2, 2): every request and the device
    # ledger equal the single-device engine's
    program = cases["impulse-imdb"][0]

    def drain(mesh):
        eng = SNNServeEngine(program, batch_slots=MESH_SLOTS, pages=2,
                             megastep=10, backend="cuda_events",
                             step_kw=MESH_KW["cuda_events"], device=dev,
                             mesh=mesh, validate=False)
        for r in make_requests(program, MESH_REQUESTS, 6, 10, 0.85, SEED):
            eng.submit(r)
        ts = time.perf_counter()
        done = sorted(eng.run_until_drained(), key=lambda r: r.rid)
        return done, eng, time.perf_counter() - ts
    want, want_eng, _ = drain(None)
    kernels.reset_launch_counts()
    got, eng, dt = drain(meshes[2, 2])
    launches = {k: v for k, v in kernels.LAUNCH_COUNTS.items() if v}
    bad = [a.rid for a, b in zip(got, want)
           if not same_request(a, b) or a.finish_clock != b.finish_clock]
    a, b = eng.device_event_stats(), want_eng.device_event_stats()
    if (len(got) != MESH_REQUESTS or bad or a.frames != b.frames
            or not all(np.array_equal(x, y)
                       for x, y in zip(a.row_events, b.row_events))):
        raise AssertionError(f"rank {rank}: the (2, 2) cuda_events drain != "
                             f"one device (requests {bad})")
    rows["impulse-imdb 2x2 cuda_events serving drain"] = {
        "s": dt, "launches": launches, "requests": len(got),
        "compiled": eng._dispatch is not None,
        "ledger_skipped_row_fraction": eng.device_skipped_row_fraction()}
    (out / f"rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "coords": meshes[2, 2].coords, "ready_s": t_ready,
         "s": time.perf_counter() - t0, "rows": rows}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_mesh_one(dev, backend: str = "nccl") -> dict:
    """Phase 22(a): a world of one (``backend``, NCCL on the card) and its
    (1, 1) mesh: IMDB and impulse-mnist through int_ref, cuda, cuda_sparse
    and cuda_events, each equal to the meshless call bit for bit with its
    launch counts; and the compiled cuda engine on the mesh (its page
    graphs captured, as a world of one runs no collective) equal to the
    meshless engine."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_snn import make_requests
    from repro_torch.serve import SNNServeEngine
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), device_type=dev.type)
            cases = mesh_cases(dev)
            shapes = {b: {(n, (1, 1), b) for n in cases}
                      for b in ("int_ref", "cuda", "cuda_sparse",
                                "cuda_events")}
            rows = mesh_net_runs(pipeline, kernels, cases, {(1, 1): mesh},
                                 shapes, "world of one")
            for key, row in rows.items():
                if row["launches"] != row["single_device_launches"]:
                    raise AssertionError(
                        f"{key}: launches {row['launches']} on the mesh, "
                        f"{row['single_device_launches']} without it")
            program = cases["impulse-imdb"][0]

            def drain(mesh_):
                eng = SNNServeEngine(program, batch_slots=MESH_SLOTS,
                                     pages=2, megastep=10, backend="cuda",
                                     device=dev, mesh=mesh_, validate=False)
                for r in make_requests(program, MESH_REQUESTS, 6, 10, 0.85,
                                       SEED):
                    eng.submit(r)
                return (sorted(eng.run_until_drained(),
                               key=lambda r: r.rid), eng)
            want, _ = drain(None)
            got, eng = drain(mesh)
            bad = [a.rid for a, b in zip(got, want) if not same_request(a, b)]
            if bad or len(got) != MESH_REQUESTS:
                raise AssertionError(f"the (1, 1) cuda engine != one device "
                                     f"(requests {bad})")
            rows["impulse-imdb 1x1 cuda serving drain"] = {
                "requests": len(got), "compiled": eng._dispatch is not None,
                "capturable": mesh.capturable}
        finally:
            dist.destroy_process_group()
    return {"rows": rows, "s": time.perf_counter() - t0,
            "backend": backend}


def start_mesh_ranks(device_type: str = "cuda") -> dict:
    """Phase 22(b), first half: spawn the four gloo ranks (`mesh_rank`) on
    the one card, so that their start-up overlaps phase 22(a). Returns the
    handle `finish_mesh_ranks` takes."""
    import tempfile
    d = tempfile.mkdtemp(prefix="mesh_ranks")
    procs = []
    for rank in range(MESH_WORLD):
        log = open(os.path.join(d, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(rank), d, device_type],
            stdout=log, stderr=subprocess.STDOUT), log))
    return {"dir": d, "procs": procs, "t0": time.perf_counter()}


def finish_mesh_ranks(handle: dict) -> dict:
    """Phase 22(b), second half: wait for every rank (at most
    MESH_TIMEOUT_S from the spawn), kill what is left on failure, and read
    each rank's rows; each rank held every mesh result to the
    single-device run itself."""
    import shutil
    d, procs = handle["dir"], handle["procs"]
    deadline = handle["t0"] + handle.get("timeout", MESH_TIMEOUT_S)
    failed = []
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
                if rc == "timeout":
                    break
        if failed:
            tails = "\n".join(
                f"rank {r}:\n" + Path(d, f"rank{r}.log").read_text()[-2000:]
                for r, _ in failed)
            raise AssertionError(f"mesh ranks failed {failed}\n{tails}")
        ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                 for r in range(handle.get("world", MESH_WORLD))]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(d, ignore_errors=True)
    return {"ranks": ranks, "s": time.perf_counter() - handle["t0"]}


def print_mesh(one: dict, four: dict, card: str) -> dict:
    """Phase 22's lines; returns each kernel's launches on the mesh path
    (the world of one, each rank on (4, 1) and on (1, 4))."""
    for key, row in one["rows"].items():
        print(f"[phase 22] (a) world of one ({one['backend']}), mesh 1x1, "
              f"{key}: == one device bit for bit; {json.dumps(row)}")
    for r in four["ranks"]:
        launches = {k: row["launches"] for k, row in r["rows"].items()
                    if " 4x1 " in k or " 1x4 " in k}
        print(f"[phase 22] (b) rank {r['rank']} {r['coords']}: every mesh "
              f"result == one device bit for bit, in {r['s']:.1f} s "
              f"({r['ready_s']:.1f} s to join and build); launches on 4x1 "
              f"and 1x4: {json.dumps(launches)}")
    rows0 = four["ranks"][0]["rows"]
    print(f"[phase 22] (b) rank 0 rows: {json.dumps(rows0)}")
    print(f"[phase 22] world of one {one['s']:.1f} s; four gloo ranks on "
          f"one card {four['s']:.1f} s from their spawn, which overlaps the "
          f"world of one ({card})")
    mesh_launches = {}
    for name, backend in BACKEND_OF.items():
        one_row = one["rows"].get(f"impulse-imdb 1x1 {backend}", {})
        mesh_launches[name] = {
            "world_of_one_imdb": one_row.get("launches", {}).get(name, 0),
            "per_rank_4x1_imdb": [
                r["rows"][f"impulse-imdb 4x1 {backend}"]["launches"].get(
                    name, 0) for r in four["ranks"]],
            "per_rank_1x4_imdb": [
                r["rows"][f"impulse-imdb 1x4 {backend}"]["launches"].get(
                    name, 0) for r in four["ranks"]]}
        if any(mesh_launches[name]["per_rank_1x4_imdb"]):
            raise AssertionError(f"{name} launched on the 1x4 mesh, whose "
                                 "row-partial ticks run no kernel")
        if (min(mesh_launches[name]["per_rank_4x1_imdb"]) < 1
                or mesh_launches[name]["world_of_one_imdb"] < 1):
            raise AssertionError(f"the mesh path never launched {name}")
    return mesh_launches


# ---------------------------------------------------------------------------
# phase 23: LM sharding (DTensor on torch.distributed)
# ---------------------------------------------------------------------------

LM_MESH_WORLD = 4                 # gloo ranks spawned on the one card
LM_MESH_ARCH = "llama3.2-1b"
LM_MESH_LAYERS = 2                # of 16, at every published width
LM_MESH_B = 8
LM_MESH_SEQ = 256
LM_MESH_LR = 1e-3
LM_MESH_STEPS = 2
LM_MESH_COMPRESS_STEPS = 6
PIPE_D = 2048                     # GPipe stage: tanh(x @ w), w (d, d)
PIPE_MICRO = 8
PIPE_B = 4
LM_MESH_TIMEOUT_S = 420           # the four ranks together
LM_MESH_LOSS_RTOL = 1e-5          # the CPU tests' rule (ROADMAP, AdamW)
LM_MESH_ATOL = 1e-5
LM_MESH_G_MIN = 1e-7
LM_MESH_STABLE_SHARE = 0.85
LM_MESH_GRAD_RL2 = 1e-4           # each gradient leaf, as phase 15's
#: 23(d): one rwkv6-7b prefill at every published width on (1, 4), each
#: model rank on 16 of the 64 heads
LM_MESH_RWKV_ARCH = "rwkv6-7b"
LM_MESH_RWKV_LAYERS = 2           # of 32
LM_MESH_RWKV_B = 2
LM_MESH_RWKV_SEQ = 256
#: 23(f): deepseek-v2-lite-16b's MoE FFN at every published width on (2,
#: 2) with constraints, each data rank routing its own 2 of the 4 groups
LM_MESH_MOE_ARCH = "deepseek-v2-lite-16b"
LM_MESH_MOE_B = 4
LM_MESH_MOE_SEQ = 128
LM_MESH_MOE_RL2 = 1e-5            # output, aux and every gradient


def lm_mesh_setup(dev):
    """Phase 23's model, run and batch, the same on every rank:
    llama3.2-1b at every published width cut to LM_MESH_LAYERS layers,
    float32 weights drawn on the card from the seed, AdamW at a constant
    LM_MESH_LR, fsdp, sequence parallel, vocab chunking 2, remat per
    block; B = 8, T = 256 tokens from `io_spec.materialize`."""
    from repro_torch.configs.base import (ParallelConfig, RunConfig,
                                          ShapeConfig, get_config)
    from repro_torch.models import io_spec, lm
    cfg = dataclasses.replace(get_config(LM_MESH_ARCH),
                              n_layers=LM_MESH_LAYERS)
    shape = ShapeConfig("phase23", LM_MESH_SEQ, LM_MESH_B, "train")
    parallel = ParallelConfig(remat="block", fsdp=True, seq_parallel=True,
                              vocab_chunking=2)
    run = RunConfig(model=cfg, shape=shape, parallel=parallel,
                    optimizer="adamw", learning_rate=LM_MESH_LR,
                    warmup_steps=1)
    params = lm.init_params(SEED, cfg, dtype=torch.float32, device=dev)
    batch = io_spec.materialize(io_spec.train_batch_spec(cfg, shape), SEED,
                                device=dev)
    return run, params, batch


def lm_mesh_steps(run, params, batch, mesh=None) -> dict:
    """LM_MESH_STEPS AdamW steps of `make_train_step` from ``params`` on
    ``batch``: on one device, or with ``mesh`` placed by `param_specs` and
    `batch_specs` under `activation_rules`. Returns the state, the metrics,
    each step's seconds and AdamW's first moment after step 1 (0.1 x the
    clipped step-1 gradient; global tensors, gathered on a mesh)."""
    from repro_torch.dist import sharding
    from repro_torch.optim import make_optimizer
    from repro_torch.train.train_state import TrainState, make_train_step
    from repro_torch.tree import tree_leaves
    opt = make_optimizer("adamw", LM_MESH_LR, 0.1)
    rules = contextlib.nullcontext()
    if mesh is not None:
        params = sharding.place_tree(params, mesh, sharding.param_specs(
            params, mesh, run.parallel))
        batch = sharding.place_tree(batch, mesh, sharding.batch_specs(
            batch, mesh, run.parallel))
        rules = sharding.activation_rules(mesh, run.parallel)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32,
                                   device=batch["tokens"].device))
    step = make_train_step(run, opt)
    metrics, seconds, m1 = [], [], None
    with rules:
        for i in range(LM_MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                m1 = tree_leaves(sharding.gather_tree(state.opt_state["m"]))
    return {"state": state, "metrics": metrics, "seconds": seconds,
            "m1": m1}


def clipped_from_moments(m1: list, m2: list) -> list:
    """Each step's clipped gradient leaves, read back from AdamW's first
    moments (m1 = 0.1 g1, m2 = 0.9 m1 + 0.1 g2)."""
    g1 = [m / 0.1 for m in m1]
    g2 = [(b - 0.9 * a) / 0.1 for a, b in zip(m1, m2)]
    return [g1, g2]


def grad_rule(got: list, want: list, tag: str) -> dict:
    """Each leaf of the clipped step-1 gradient (AdamW's first moment
    after step 1) within LM_MESH_GRAD_RL2 relative L2 (float64 on the
    card)."""
    worst = 0.0
    for a, b in zip(got, want):
        den = float(b.double().norm())
        r = float((a.double() - b.double()).norm()) / den if den else 0.0
        worst = max(worst, r)
    if not worst <= LM_MESH_GRAD_RL2:
        raise AssertionError(f"{tag}: a gradient leaf differs by relative "
                             f"L2 {worst:.3e}")
    return {"grad_max_rel_l2": worst}


def adamw_rule(got, want, clipped) -> dict:
    """The CPU tests' rule on two parameter trees after the steps: every
    element within 2 lr a step (Adam's bound, gated), and the report of
    its scale-bound part: the elements whose clipped |g| is at least
    ``g_min`` at every step (1e-7, the CPU tests' threshold, and 1e-6),
    their share and how many of them differ by more than 1e-5, with the
    worst such element and its clipped gradients."""
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    worst = 0.0
    total = 0
    rows = {g: {"stable": 0, "over_1e-5": 0, "max_abs_diff": 0.0,
                "worst": None} for g in (LM_MESH_G_MIN, 10 * LM_MESH_G_MIN)}
    for i, ((path, a), b) in enumerate(zip(tree_flatten_with_paths(got),
                                           tree_leaves(want))):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        total += d.numel()
        for g_min, row in rows.items():
            ok = torch.ones_like(d, dtype=torch.bool)
            for c in clipped:
                ok &= c[i].abs() >= g_min
            row["stable"] += int(ok.sum())
            n = int((d[ok] > LM_MESH_ATOL).sum())
            row["over_1e-5"] += n
            if bool(ok.any()):
                s = float(d[ok].max())
                if s > row["max_abs_diff"]:
                    at = int(torch.where(ok, d, torch.zeros_like(d)).argmax())
                    row["max_abs_diff"] = s
                    row["worst"] = {
                        "leaf": "/".join(map(str, path)),
                        "got": float(a.flatten()[at]),
                        "want": float(b.flatten()[at]),
                        "clipped_g": [float(c[i].flatten()[at])
                                      for c in clipped]}
    for row in rows.values():
        row["share"] = row["stable"] / total
    out = {"max_abs_diff": worst, "params": total,
           "by_g_min": {f"{g:g}": row for g, row in rows.items()}}
    if worst > 2 * LM_MESH_STEPS * LM_MESH_LR:
        raise AssertionError(f"phase 23: a parameter moved past Adam's "
                             f"bound: {out}")
    return out


def same_metrics(got: list, want: list, tag: str) -> dict:
    """Losses and grad norms within LM_MESH_LOSS_RTOL relative."""
    rel = 0.0
    for a, b in zip(got, want):
        for key in ("loss", "grad_norm"):
            r = abs(a[key] - b[key]) / abs(b[key])
            if not r <= LM_MESH_LOSS_RTOL:
                raise AssertionError(f"{tag}: {key} {a[key]} vs {b[key]} "
                                     f"(rel {r:.2e})")
            rel = max(rel, r)
    return {"max_rel_diff_loss_grad_norm": rel}


@contextlib.contextmanager
def score_bytes():
    """The bytes of the float32 score tensor each `layers._sdpa` call
    makes on the tensors it is given (a rank's own heads under
    `sharding.head_local`): B x H x T x S x 4 a call, in call order (a
    remat's recompute calls again)."""
    from repro_torch.models import layers
    calls, sdpa = [], layers._sdpa

    def recorded(q, k, v, **kw):
        calls.append(q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1] * 4)
        return sdpa(q, k, v, **kw)
    layers._sdpa = recorded
    try:
        yield calls
    finally:
        layers._sdpa = sdpa


def phase_lm_mesh_one(dev, backend: str = "nccl") -> dict:
    """Phase 23(a): a world of one (NCCL on the card) and its (1, 1) mesh:
    the sharded step of (b)'s model equals the plain step on the card
    (whether bit for bit is printed; else to the CPU tests' rule)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    free_cuda()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), device_type=dev.type)
            run, params, batch = lm_mesh_setup(dev)
            plain = lm_mesh_steps(run, params, batch)
            with score_bytes() as scores:
                sharded = lm_mesh_steps(run, params, batch, mesh)
            gathered = sharding.gather_tree(sharded["state"].params)
            got = tree_leaves(gathered)
            want = tree_leaves(plain["state"].params)
            bit_equal = (sharded["metrics"] == plain["metrics"] and all(
                torch.equal(a, b) for a, b in zip(got, want)))
            out = {"bit_equal": bit_equal,
                   "losses": [m["loss"] for m in sharded["metrics"]],
                   "plain_losses": [m["loss"] for m in plain["metrics"]],
                   "seconds": sharded["seconds"],
                   "plain_seconds": plain["seconds"],
                   "max_abs_diff": max(float((a - b).abs().max())
                                       for a, b in zip(got, want)),
                   "score_bytes_a_call": max(scores),
                   "score_calls": len(scores)}
            if not bit_equal:
                out.update(same_metrics(sharded["metrics"],
                                        plain["metrics"], "world of one"))
                out.update(grad_rule(sharded["m1"], plain["m1"],
                                     "world of one"))
                out.update(adamw_rule(gathered, want, clipped_from_moments(
                    plain["m1"], tree_leaves(plain["state"].opt_state["m"]))))
            del plain, sharded, gathered, got, want, params
        finally:
            dist.destroy_process_group()
    free_cuda()
    out["s"] = time.perf_counter() - t0
    out["backend"] = backend
    return out


def _allocated(device_type: str):
    return torch.cuda.memory_allocated() if device_type == "cuda" else None


def lm_mesh_rank_step(rank: int, dev, m22, row: dict) -> None:
    """Phase 23(b) on one rank: the sharded step on (2, 2) (rank 0 also
    the single-device step, and holds one to the other)."""
    from repro_torch.dist import collectives, sharding
    from repro_torch.tree import tree_leaves
    run, params, batch = lm_mesh_setup(dev)
    if rank == 0:
        single = lm_mesh_steps(run, params, batch)
        row["single_seconds"] = single["seconds"]
        want = tree_leaves(single["state"].params)
        clipped = clipped_from_moments(
            single["m1"], tree_leaves(single["state"].opt_state["m"]))
        want_metrics, want_m1 = single["metrics"], single["m1"]
        del single
    counts0 = dict(collectives.COUNTS)
    t0 = time.perf_counter()
    with score_bytes() as scores:
        sharded = lm_mesh_steps(run, params, batch, m22)
    row["sharded_s"] = time.perf_counter() - t0
    row["score_bytes_a_call"] = max(scores)
    row["score_calls"] = len(scores)
    row["collectives_per_2_steps"] = {
        k: v - counts0.get(k, 0) for k, v in collectives.COUNTS.items()}
    row["seconds"] = sharded["seconds"]
    row["metrics"] = sharded["metrics"]
    specs = sharding.param_specs(params, m22, run.parallel)
    bad = [i for i, (x, s) in enumerate(zip(
        tree_leaves(sharded["state"].params), _spec_list(specs)))
        if tuple(x.placements) != tuple(s)]
    if bad:
        raise AssertionError(f"rank {rank}: leaves {bad} left their "
                             "param_specs placements")
    t0 = time.perf_counter()
    gathered = sharding.gather_tree(sharded["state"].params)
    row["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        row.update(same_metrics(sharded["metrics"], want_metrics,
                                "phase 23(b)"))
        row.update(grad_rule(sharded["m1"], want_m1, "phase 23(b)"))
        row.update(adamw_rule(gathered, want, clipped))
        row["single_metrics"] = want_metrics
        del want, clipped, want_m1
    del gathered, sharded


def lm_mesh_rank_rwkv(rank: int, dev, m14, row: dict) -> None:
    """Phase 23(d) on one rank: one `lm.prefill` of LM_MESH_RWKV_ARCH at
    every published width on LM_MESH_RWKV_LAYERS layers (float32 weights
    drawn on the card from the seed, B = LM_MESH_RWKV_B, T =
    LM_MESH_RWKV_SEQ) on DTensors of (1, 4) under `activation_rules`:
    `time_mix` runs the wkv6 kernel on this rank's 16 of the 64 heads
    (`sharding.head_local`), one launch a layer of B x 16 rows. Rank 0
    also runs the prefill in one process and holds the gathered logits
    and cache to it, within WKV_TOL (float32 leaves) or one bf16 rounding
    (bf16 leaves)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import kernels
    from repro_torch.configs.base import (ParallelConfig, ShapeConfig,
                                          get_config)
    from repro_torch.dist import sharding
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import io_spec, lm
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(LM_MESH_RWKV_ARCH),
                              n_layers=LM_MESH_RWKV_LAYERS)
    parallel = ParallelConfig()
    B, T = LM_MESH_RWKV_B, LM_MESH_RWKV_SEQ
    params = lm.init_params(SEED, cfg, dtype=torch.float32, device=dev)
    batch = io_spec.materialize(io_spec.prefill_batch_spec(
        cfg, ShapeConfig("phase23d", T, B, "prefill")), SEED, device=dev)
    rows, launch = [], wkv_ops.wkv6_cuda

    def recorded(r, *args):
        rows.append(r.shape[0])
        return launch(r, *args)
    t0 = time.perf_counter()
    wkv_ops.wkv6_cuda = recorded
    try:
        if rank == 0:
            with torch.no_grad():
                want = lm.prefill(params, batch, cfg, T, parallel)
            row["rwkv_single_rows"], rows[:] = rows[:], []
        placed = sharding.place_tree(params, m14, sharding.param_specs(
            params, m14, parallel))
        tokens = sharding.place_tree(batch, m14, sharding.batch_specs(
            batch, m14, parallel))
        before = kernels.LAUNCH_COUNTS["wkv6"]
        with torch.no_grad(), sharding.activation_rules(m14, parallel), \
                implicit_replication():
            logits, cache = lm.prefill(placed, tokens, cfg, T, parallel)
        torch.cuda.synchronize()
        launches = kernels.LAUNCH_COUNTS["wkv6"] - before
    finally:
        wkv_ops.wkv6_cuda = launch
    got = [logits.full_tensor()] + tree_leaves(sharding.gather_tree(cache))
    heads = cfg.n_heads // m14.shape[1]
    out = {"launches": launches, "rows": rows[:], "heads_a_rank": heads,
           "of_heads": cfg.n_heads, "s": time.perf_counter() - t0}
    if launches != LM_MESH_RWKV_LAYERS or rows != [B * heads] * launches:
        raise AssertionError(f"rank {rank}: phase 23(d) launched wkv6 "
                             f"{launches} times on rows {rows}, expected "
                             f"{LM_MESH_RWKV_LAYERS} of {B * heads}")
    if rank == 0:
        worst = 0.0
        for a, b in zip(got, [want[0]] + tree_leaves(want[1])):
            tol = WKV_TOL if b.dtype == torch.float32 else 2.0 ** -7
            den = float(b.float().abs().max())
            rel = float((a.float() - b.float()).abs().max()) / den \
                if den else 0.0
            if not rel <= tol:
                raise AssertionError(f"phase 23(d): a leaf of shape "
                                     f"{tuple(b.shape)} differs by {rel:.3e}"
                                     f" (tol {tol:g})")
            if b.dtype == torch.float32:
                worst = max(worst, rel)
        out["max_rel_diff_float32"] = worst
        out["single_rows"] = row.pop("rwkv_single_rows")
    row["rwkv"] = out


@contextlib.contextmanager
def recorded_routes():
    """What `layers.moe_ffn`'s routing computes while the context is open:
    each call's top-k expert indices (`layers._topk_first`, moved to the
    host) and the bytes of its buckets (`layers._route`)."""
    from repro_torch.models import layers
    seen = {"experts": [], "bucket_bytes": []}
    topk, route = layers._topk_first, layers._route

    def topk_recorded(*args):
        vals, idx = topk(*args)
        seen["experts"].append(idx.detach().cpu())
        return vals, idx

    def route_recorded(*args):
        out = route(*args)
        seen["bucket_bytes"].append(out[0].numel() * out[0].element_size())
        return out
    layers._topk_first, layers._route = topk_recorded, route_recorded
    try:
        yield seen
    finally:
        layers._topk_first, layers._route = topk, route


def lm_mesh_rank_moe(rank: int, dev, m22, row: dict) -> None:
    """Phase 23(f) on one rank: `moe_ffn(constraints=True)` of
    LM_MESH_MOE_ARCH at every published width (float32 weights and input
    drawn on the card from the seed, B = LM_MESH_MOE_B, T =
    LM_MESH_MOE_SEQ, the input's sequence over model) on DTensors of (2,
    2) under `activation_rules`, with the gradients of a scalar loss and
    the aux: each data rank routes its own groups (`sharding.group_local`)
    and every model rank of a data row the same. Rank 0 also makes the
    plain call and holds the sharded one to it: every rank's expert
    choices equal its groups' (gathered to rank 0 over the world), the
    output, the aux and every gradient within LM_MESH_MOE_RL2 relative
    L2."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.dist import sharding
    from repro_torch.models import layers
    from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,
                                  tree_unflatten_like)
    cfg = get_config(LM_MESH_MOE_ARCH)
    parallel = ParallelConfig(moe_constraints=True)
    B, T = LM_MESH_MOE_B, LM_MESH_MOE_SEQ
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = layers.init_moe(gen, cfg, torch.float32)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)

    def loss_grads(x, p, mesh=None):
        leaves = [x] + tree_leaves(p)
        if mesh is not None:
            leaves = [sharding.place_tree(x, mesh, sharding.logical_spec(
                mesh, ("batch", "seq", None), tuple(x.shape)))] + \
                tree_leaves(sharding.place_tree(p, mesh, sharding.param_specs(
                    p, mesh, parallel)))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with recorded_routes() as seen:
            out, lb = layers.moe_ffn(
                leaves[0], tree_unflatten_like(p, leaves[1:]), cfg,
                constraints=True)
            # a sum, not a mean: torch 2.11's DTensor cannot add a mean's
            # partial average to the aux's partial sum
            loss = (out.float() ** 2).sum() / out.numel() + lb
            grads = torch.autograd.grad(loss, leaves)
        return out, lb, grads, seen
    out = {}
    if rank == 0:
        t0 = time.perf_counter()
        want = loss_grads(x, p)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["plain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with sharding.activation_rules(m22, parallel), implicit_replication():
        got = loss_grads(x, p, m22)
        tensors = [got[0].full_tensor(), got[1].full_tensor()] + [
            g.full_tensor() for g in got[2]]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    m = cfg.moe
    out["width"] = {"d": cfg.d_model, "experts": m.n_experts,
                    "d_ff": m.d_ff, "top_k": m.top_k,
                    "shared": m.n_shared_experts}
    out["aux_placements"] = str(got[1].placements)
    out["bucket_bytes"] = got[3]["bucket_bytes"]
    mine = torch.cat(got[3]["experts"])
    every = [torch.empty_like(mine) for _ in range(LM_MESH_WORLD)]
    dist.all_gather(every, mine)              # gloo, on the host
    coords = [None] * LM_MESH_WORLD
    dist.all_gather_object(coords, m22.coords)
    if rank == 0:
        choices = torch.cat(want[3]["experts"])
        rows = B // m22.shape[0]
        same = [bool(torch.equal(e, choices[c["data"] * rows:
                                            (c["data"] + 1) * rows]))
                for e, c in zip(every, coords)]
        if not all(same):
            raise AssertionError(f"phase 23(f): the ranks' expert choices "
                                 f"differ from the plain call's {same}")
        names = ["out", "aux", "grad x"] + [
            "grad " + ".".join(map(str, path))
            for path, _ in tree_flatten_with_paths(p)]
        rel = {n: rel_l2(a, b) for n, a, b in zip(
            names, tensors, [want[0], want[1]] + list(want[2]))}
        bad = {n: r for n, r in rel.items() if not r <= LM_MESH_MOE_RL2}
        if bad:
            raise AssertionError(f"phase 23(f): sharded != plain {bad} "
                                 f"(tol {LM_MESH_MOE_RL2})")
        out.update(rel_l2=rel, same_experts=same,
                   plain_bucket_bytes=want[3]["bucket_bytes"])
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if dev.type == "cuda" else None)
    row["moe"] = out


def lm_mesh_rank_compress(rank: int, dev, m41, row: dict) -> None:
    """Phase 23(c) on one rank: `compressed_psum_mean` over the 4 data
    ranks of (4, 1) on this rank's gradient tree (the loss of its quarter
    of (b)'s batch at (b)'s initial weights), LM_MESH_COMPRESS_STEPS steps
    of error feedback against the float32 mean. The reduction is per leaf
    (one int8 tensor and one scale each), so the steps run leaf by leaf,
    each leaf as a tree of its own: the same values as the whole tree at
    once, with one leaf's buffers live at a time (four ranks share the
    card)."""
    import torch.distributed as dist

    from repro_torch.dist.compress import compressed_psum_mean
    from repro_torch.tree import tree_leaves
    run, params, batch = lm_mesh_setup(dev)
    quarter = LM_MESH_B // 4
    part = {k: v[rank * quarter:(rank + 1) * quarter]
            for k, v in batch.items()}
    _, _, grads = loss_and_grads(params, part, run.model, run.parallel)
    del params, batch, part
    wire = []
    all_gather = dist.all_gather

    def recording(tensor_list, tensor, group=None, async_op=False):
        wire.append((str(tensor.dtype), tensor.numel()
                     * tensor.element_size()))
        return all_gather(tensor_list, tensor, group=group,
                          async_op=async_op)
    steps = LM_MESH_COMPRESS_STEPS
    errs, avg_err, cs = [0.0] * steps, 0.0, time.perf_counter()
    dist.all_gather = recording
    try:
        for g in tree_leaves(grads):
            true = g.clone()
            dist.all_reduce(true)
            true.div_(4)
            residual = {"g": torch.zeros_like(g)}
            acc = torch.zeros_like(g)
            for i in range(steps):
                mean, residual = compressed_psum_mean({"g": g}, residual,
                                                      "data", m41)
                errs[i] = max(errs[i],
                              float((mean["g"] - true).abs().max()))
                acc.add_(mean["g"])
                del mean
            avg_err = max(avg_err,
                          float((acc.div_(steps) - true).abs().max()))
            del true, residual, acc
    finally:
        dist.all_gather = all_gather
    torch.cuda.synchronize()
    if not (errs[0] < 0.05 and avg_err < errs[0]):
        raise AssertionError(f"rank {rank}: compressed mean errors "
                             f"{errs[0]} first, {avg_err} averaged")
    dtypes = sorted({d for d, _ in wire})
    row["compress"] = {
        "first_err": errs[0], "avg_err": avg_err, "errs": errs,
        "s": time.perf_counter() - cs, "wire_dtypes": dtypes,
        "wire_bytes_per_step": sum(b for _, b in wire) // steps,
        "int8_bytes_per_step": sum(b for d, b in wire
                                   if d == "torch.int8") // steps,
        "float32_bytes_of_the_same": sum(
            g.numel() * 4 for g in tree_leaves(grads))}
    if "torch.int8" not in dtypes:
        raise AssertionError(f"rank {rank}: no int8 crossed the wire")


def lm_mesh_rank(argv) -> int:
    """One of phase 23's gloo ranks: ``--lm-mesh-rank RANK DIR [DEVICE]``.
    Joins the world through a FileStore in DIR, runs (c)
    `compressed_psum_mean` over (4, 1) (`lm_mesh_rank_compress`), waits
    for DIR/go (written when 23(a) has freed the card's memory), runs (b)
    the sharded step on (2, 2) (`lm_mesh_rank_step`), (d) an rwkv6-7b
    prefill on (1, 4) (`lm_mesh_rank_rwkv`), (e) GPipe on ("pipe",) x
    4 (rank 0 also the sequential composition) and (f) deepseek's MoE FFN
    on (2, 2) (`lm_mesh_rank_moe`); writes DIR/rank<RANK>.json; a mismatch
    raises."""
    rank, out = int(argv[0]), Path(argv[1])
    device_type = argv[2] if len(argv) > 2 else "cuda"
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.distributed as dist

    from repro_torch.dist.pipeline import make_pipeline_fn, ring_of
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    torch.set_num_threads(2)
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), LM_MESH_WORLD),
        rank=rank, world_size=LM_MESH_WORLD)
    m22 = make_mesh((2, 2), device_type=device_type)
    m41 = make_mesh((4, 1), device_type=device_type)
    m14 = make_mesh((1, 4), device_type=device_type)
    pipe_mesh = make_mesh((4,), ("pipe",), device_type=device_type)
    row: dict = {"rank": rank, "coords": m22.coords,
                 "ready_s": time.perf_counter() - t0}
    if device_type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # (c) (a few GB a rank, leaf by leaf) while 23(a) runs in the main
    # process, then (b) once 23(a) has freed the card, then (d) and (e);
    # (b)-(d) each in a function of their own, whose tensors go at the
    # return
    lm_mesh_rank_compress(rank, dev, m41, row)
    free_cuda()
    row["allocated_after_c"] = _allocated(device_type)
    deadline = time.perf_counter() + LM_MESH_TIMEOUT_S
    while not (out / "go").exists():
        if time.perf_counter() > deadline:
            raise AssertionError(f"rank {rank}: no go from phase 23(a)")
        time.sleep(0.05)
    row["go_s"] = time.perf_counter() - t0
    lm_mesh_rank_step(rank, dev, m22, row)
    free_cuda()
    row["allocated_after_b"] = _allocated(device_type)
    lm_mesh_rank_rwkv(rank, dev, m14, row)
    free_cuda()

    # (e) GPipe on ("pipe",) x 4 against the sequential composition
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Ws = torch.randn((4, PIPE_D, PIPE_D), generator=gen, device=dev) \
        / math.sqrt(PIPE_D)
    xs = torch.randn((PIPE_MICRO, PIPE_B, PIPE_D), generator=gen,
                     device=dev)

    def stage(w, x):
        return torch.tanh(x @ w)
    pipe = make_pipeline_fn(stage, pipe_mesh, "pipe", PIPE_MICRO)
    ps = time.perf_counter()
    got = pipe(Ws, xs)
    torch.cuda.synchronize()
    row["gpipe"] = {"s": time.perf_counter() - ps,
                    "ring": ring_of(pipe_mesh)}
    if rank == 0:
        seq = []
        for m in range(PIPE_MICRO):
            x = xs[m]
            for s in range(4):
                x = stage(Ws[s], x)
            seq.append(x)
        seq = torch.stack(seq)
        row["gpipe"]["bit_equal"] = bool(torch.equal(got, seq))
        row["gpipe"]["max_abs_diff"] = float((got - seq).abs().max())
        if not row["gpipe"]["bit_equal"]:
            raise AssertionError("phase 23(e): GPipe != the sequential "
                                 f"composition ({row['gpipe']})")
    row["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device_type == "cuda" else None)
    del Ws, xs, got
    free_cuda()
    lm_mesh_rank_moe(rank, dev, m22, row)
    row["s"] = time.perf_counter() - t0
    (out / f"rank{rank}.json").write_text(json.dumps(row))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spec_list(specs) -> list:
    """The placement tuples of a spec tree, in leaf order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_list(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_list(v)]
    return [specs]


def start_lm_mesh_ranks(device_type: str = "cuda") -> dict:
    """Phase 23(b)-(e), first half: spawn the four gloo ranks
    (`lm_mesh_rank`), which start up and run (c) while 23(a) runs, then
    wait for its go."""
    import tempfile
    d = tempfile.mkdtemp(prefix="lm_mesh_ranks")
    # four ranks share one card: let each return freed blocks whole
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = []
    for rank in range(LM_MESH_WORLD):
        log = open(os.path.join(d, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--lm-mesh-rank", str(rank), d, device_type],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return {"dir": d, "procs": procs, "t0": time.perf_counter(),
            "world": LM_MESH_WORLD, "timeout": LM_MESH_TIMEOUT_S}


def phase_lm_mesh(dev) -> dict:
    """Phase 23: (a) in this process while the four ranks start, then
    (b)-(e) on the ranks; each holds its own results."""
    t0 = time.perf_counter()
    free_cuda()
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    handle = start_lm_mesh_ranks(dev.type)
    try:
        one = phase_lm_mesh_one(dev)
    finally:
        Path(handle["dir"], "go").write_text("go")
        four = finish_mesh_ranks(handle)
    return {"one": one, "four": four, "s": time.perf_counter() - t0,
            "main_process_bytes": held}


def print_lm_mesh(res: dict, card: str) -> None:
    one, four = res["one"], res["four"]
    print(f"[phase 23] (a) world of one ({one['backend']}), mesh 1x1, "
          f"{LM_MESH_ARCH} at full width on {LM_MESH_LAYERS} layers, "
          f"float32, B = {LM_MESH_B}, T = {LM_MESH_SEQ}: sharded step == "
          f"plain step on the card, bit for bit: {one['bit_equal']}; "
          f"{json.dumps(one)} ({card})")
    r0 = four["ranks"][0]
    print(f"[phase 23] (a) float32 score bytes a call of `_sdpa` (B x H x "
          f"T x S x 4 of the heads a rank computes) in the "
          f"{LM_MESH_ARCH} step: world of one {one['score_bytes_a_call']} "
          f"({one['score_calls']} calls); the (2, 2) ranks of (b) "
          f"{[r['score_bytes_a_call'] for r in four['ranks']]} "
          f"({r0['score_calls']} calls each)")
    rule = r0["by_g_min"]
    print(f"[phase 23] (b) 4 gloo ranks on one card, mesh 2x2 (fsdp, seq "
          f"parallel, vocab chunking 2, remat per block), {LM_MESH_STEPS} "
          f"AdamW steps: losses {[m['loss'] for m in r0['metrics']]} vs "
          f"single device {[m['loss'] for m in r0['single_metrics']]} "
          f"(loss and grad norm rel "
          f"{r0['max_rel_diff_loss_grad_norm']:.2e}, tol "
          f"{LM_MESH_LOSS_RTOL}); clipped step-1 gradient (AdamW's m1) max "
          f"rel L2 "
          f"{r0['grad_max_rel_l2']:.2e} (tol {LM_MESH_GRAD_RL2}); largest "
          f"parameter |diff| {r0['max_abs_diff']:.3e} (bound "
          f"{2 * LM_MESH_STEPS * LM_MESH_LR:g}); of {r0['params']} "
          f"parameters, clipped |g| >= 1e-7 at both steps: "
          f"{rule['1e-07']['stable']} ({rule['1e-07']['share']:.4f}), "
          f"{rule['1e-07']['over_1e-5']} over 1e-5 (max "
          f"{rule['1e-07']['max_abs_diff']:.3e}); >= 1e-6: "
          f"{rule['1e-06']['stable']}, {rule['1e-06']['over_1e-5']} over "
          f"1e-5 (max {rule['1e-06']['max_abs_diff']:.3e}); seconds a step "
          f"{[round(s, 3) for s in r0['seconds']]} (single device "
          f"{[round(s, 3) for s in r0['single_seconds']]}; placing, the "
          f"steps and the first moment's gather {r0['sharded_s']:.2f} s, "
          f"the parameters' gather {r0['gather_s']:.2f} s); peak bytes per "
          f"rank {[r['peak_bytes'] for r in four['ranks']]}; functional "
          f"collectives in 2 steps "
          f"{json.dumps(r0['collectives_per_2_steps'])} ({card})")
    print(f"[phase 23] (b) the CPU tests' parameter rule at full width: "
          f"{json.dumps(rule)}")
    for r in four["ranks"]:
        c = r["compress"]
        print(f"[phase 23] (c) rank {r['rank']}: compressed_psum_mean over "
              f"4 data ranks, {LM_MESH_COMPRESS_STEPS} steps: first_err "
              f"{c['first_err']:.3e}, avg_err {c['avg_err']:.3e}; wire "
              f"{c['wire_dtypes']}, {c['wire_bytes_per_step']} bytes a "
              f"step ({c['int8_bytes_per_step']} int8) against "
              f"{c['float32_bytes_of_the_same']} in float32; {c['s']:.2f} "
              f"s; bytes held after (c) / (b) {r['allocated_after_c']} / "
              f"{r['allocated_after_b']}")
    rw = r0["rwkv"]
    print(f"[phase 23] (d) {LM_MESH_RWKV_ARCH} at full width on "
          f"{LM_MESH_RWKV_LAYERS} layers, float32, one prefill of B = "
          f"{LM_MESH_RWKV_B}, T = {LM_MESH_RWKV_SEQ} on 4 gloo ranks, mesh "
          f"1x4: == one process within {WKV_TOL} (float32 logits and wkv "
          f"state max rel {rw['max_rel_diff_float32']:.3e}); wkv6 launches "
          f"a rank {[r['rwkv']['launches'] for r in four['ranks']]} on rows "
          f"{[r['rwkv']['rows'] for r in four['ranks']]} "
          f"({rw['heads_a_rank']} of {rw['of_heads']} heads a rank; one "
          f"process {rw['single_rows']}); seconds a rank "
          f"{[round(r['rwkv']['s'], 2) for r in four['ranks']]} ({card})")
    print(f"[phase 23] (e) GPipe on pipe x 4, tanh(x @ w), w "
          f"({PIPE_D}, {PIPE_D}) float32, {PIPE_MICRO} microbatches of "
          f"{PIPE_B}: == the sequential composition bit for bit "
          f"{json.dumps(r0['gpipe'])}")
    moe = r0["moe"]
    print(f"[phase 23] (f) {LM_MESH_MOE_ARCH}'s MoE FFN at full width "
          f"{json.dumps(moe['width'])}, float32, B = {LM_MESH_MOE_B}, "
          f"T = {LM_MESH_MOE_SEQ} on 4 gloo ranks, mesh 2x2, constraints on, with the gradients of a "
          f"scalar loss: each data rank routes its own "
          f"{LM_MESH_MOE_B // 2} groups (`group_local`, aux "
          f"{moe['aux_placements']}); expert choices == the plain call's "
          f"on every rank {moe['same_experts']}; rel L2 to the plain call "
          f"(tol {LM_MESH_MOE_RL2}) {json.dumps(moe['rel_l2'])}; seconds "
          f"(forward, backward, gathers) a rank "
          f"{[round(r['moe']['s'], 2) for r in four['ranks']]} (plain "
          f"{moe['plain_s']:.2f} s on rank 0); bucket bytes a rank routes "
          f"{[r['moe']['bucket_bytes'] for r in four['ranks']]} (plain "
          f"{moe['plain_bucket_bytes']}); peak bytes a rank in (f) "
          f"{[r['moe']['peak_bytes'] for r in four['ranks']]} ({card})")
    print(f"[phase 23] world of one {one['s']:.1f} s; four ranks "
          f"{four['s']:.1f} s from their spawn (their start-up and (c) "
          f"overlap (a); the go after {r0['go_s']:.1f} s); "
          f"phase {res['s']:.1f} s; the main process held "
          f"{res.get('main_process_bytes')} bytes on the card meanwhile "
          f"({card})")


# ---------------------------------------------------------------------------
# phase 24: the multi-GPU dry-run (fake process group, fake CUDA tensors)
# ---------------------------------------------------------------------------

DRYRUN_CELL = ("llama3.2-1b", "decode_32k", "single")
DRYRUN_JAX = "artifacts/dryrun/single/llama3.2-1b__decode_32k.json"
DRYRUN_TIMEOUT_S = 300
DRYRUN_PEAK_RTOL = 0.10           # counted peak against the card's
#: phase 24(c): a train cell cut to DRYRUN_DEPTH layers, traced on fake
#: CUDA tensors (with the dry-run's attribution: rank 0's flops and
#: collectives by site) and on the CPU path a torch without CUDA takes
DRYRUN_TRAIN_CELL = ("llama3.2-1b", "train_4k", "single")
DRYRUN_DEPTH = 2
#: phase 24(d): the MoE train cell cut to the dense prelude and one MoE
#: layer and DRYRUN_MOE_SEQ tokens, traced in 24(c)'s subprocess on fake
#: CUDA tensors with the attribution (fault 3.5's sites)
DRYRUN_MOE_CELL = ("deepseek-v2-lite-16b", "train_4k", "single")
DRYRUN_MOE_DEPTH = 2
DRYRUN_MOE_SEQ = 256
DRYRUN_DEVICES = r"""
import dataclasses, json, sys
from repro_torch.launch import dryrun as d
arch, shape, mesh_kind, depth, moe_arch, moe_depth, moe_seq = sys.argv[1:8]
run = d.make_run(arch, shape)
run = dataclasses.replace(run, model=dataclasses.replace(
    run.model, n_layers=int(depth)))
out = {}
for dev in ("cuda", "cpu"):
    r = d.trace_cell(run, d.mesh_for(mesh_kind, dev), dev,
                     attribute=dev == "cuda")
    out[dev] = {k: r[k] for k in ("flops", "bytes", "coll", "memory",
                                  "peak", "ops")}
    out["sites"] = r.get("sites", out.get("sites"))
moe = d.make_run(moe_arch, shape)
moe = dataclasses.replace(
    moe, model=dataclasses.replace(moe.model, n_layers=int(moe_depth)),
    shape=dataclasses.replace(moe.shape, seq_len=int(moe_seq)))
r = d.trace_cell(moe, d.mesh_for(mesh_kind, "cuda"), "cuda", attribute=True)
out["moe_sites"] = r.pop("sites")
out["moe"] = {k: r[k] for k in ("flops", "bytes", "coll", "memory", "peak",
                                "ops")}
print(json.dumps(out))
"""


def dryrun_cell(out_dir: Path) -> dict:
    """Phase 24(a): `python -m repro_torch.launch.dryrun` on DRYRUN_CELL in
    a subprocess (its fake process group of 256 ranks shares no process
    with phases 22-23's groups): the cell's JSON, its argument and output
    bytes equal to the JAX package's committed artifact (the same
    placements give the same bytes) and its ``hbm_bytes`` the card's."""
    arch, shape, mesh = DRYRUN_CELL
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out_dir)],
        env=env, cwd=root, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"phase 24(a): the dry-run exited "
                             f"{out.returncode}: {out.stdout[-2000:]} "
                             f"{out.stderr[-3000:]}")
    cell = json.loads((out_dir / mesh / f"{arch}__{shape}.json").read_text())
    want = json.loads((root / DRYRUN_JAX).read_text())["memory"]
    for key in ("argument_bytes", "output_bytes"):
        if cell["memory"][key] != want[key]:
            raise AssertionError(f"phase 24(a): {key} {cell['memory'][key]}"
                                 f" != the JAX artifact's {want[key]}")
    total = torch.cuda.get_device_properties(0).total_memory
    if cell["hbm_bytes"] != total:
        raise AssertionError(f"phase 24(a): hbm_bytes {cell['hbm_bytes']} "
                             f"is not the card's {total}")
    return {"cell": cell, "s": seconds, "jax_memory": want}


def dryrun_devices() -> dict:
    """Phase 24(c): DRYRUN_TRAIN_CELL at DRYRUN_DEPTH layers traced twice in
    one subprocess (a fake process group of 256 ranks): on fake CUDA
    tensors over a "cuda" mesh, as on this card, and on fake CPU tensors
    over a "cpu" mesh, the path a torch built without CUDA takes for a
    train cell (`dryrun.trace_device`). Flops, bytes, collectives by kind,
    operators and memory must be equal: the CPU-traced train cells then
    count what the card's path would. Then `dryrun_rows` holds rank 0's
    rows (fault 3.3) on the CUDA trace's attribution."""
    arch, shape, mesh = DRYRUN_TRAIN_CELL
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN_DEVICES, arch, shape, mesh,
         str(DRYRUN_DEPTH), DRYRUN_MOE_CELL[0], str(DRYRUN_MOE_DEPTH),
         str(DRYRUN_MOE_SEQ)], env=env, cwd=root, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"phase 24(c): the traces exited "
                             f"{out.returncode}: {out.stdout[-2000:]} "
                             f"{out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if got["cuda"] != got["cpu"]:
        raise AssertionError(f"phase 24(c): the train cell counts "
                             f"otherwise on fake CUDA tensors {got['cuda']}"
                             f" than on the CPU path {got['cpu']}")
    return {"counts": got["cuda"], "s": seconds,
            **dryrun_rows(got["sites"]),
            "moe": dryrun_moe_rows(got["moe_sites"], got["moe"])}


def dryrun_moe_rows(sites: dict, totals: dict) -> dict:
    """Phase 24(d): fault 3.5's checks on rank 0's attribution of
    DRYRUN_MOE_CELL (the sandbox test's, at DRYRUN_MOE_SEQ tokens): at the
    MoE's sites (`moe_ffn`, its routing, combine and expert products),
    forward and backward, no operand holds the global batch (no leading
    axis of its groups, no axis of all their tokens), and the one
    activation reduce-scattered is the experts' hidden gradient of rank
    0's own groups (its elements counted: DTensor folds the scatter axis
    onto the leading one); the router product is one device's divided by
    the data extent, exactly, and spans rank 0's own tokens; the sites
    add up to the trace's totals."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    arch, shape, _ = DRYRUN_MOE_CELL
    cfg, m = get_config(arch), get_config(arch).moe
    G, n, d, E = (SHAPES[shape].global_batch, DRYRUN_MOE_SEQ, cfg.d_model,
                  m.n_experts)
    cap = max(int(np.ceil(n * m.top_k / E * 1.25)), 4)
    data = 16
    if sum(r["flops"] for r in sites.values()) != totals["flops"] or any(
            sum(r["collectives"].get(k, 0) for r in sites.values()) != v
            for k, v in totals["coll"].items()):
        raise AssertionError("phase 24(d): the sites do not add up to the "
                             "trace's totals")
    moe = dryrun.sites_in(sites, (layers.moe_ffn, layers._route,
                                  layers._gather_combine, layers._combine,
                                  layers._experts))
    # rank 0's groups' bucket (d wide) or hidden (d_ff wide) gradient
    own = {G // data * E * cap * w for w in (d, m.d_ff)}
    for site, row in moe.items():
        for kind, rows in row["shapes"].items():
            for operands in rows:
                for _, shape_ in operands[1:] if kind == "flops" \
                        else operands:
                    if G * n in shape_ or (
                            kind == "reduce-scatter" and len(shape_) > 2
                            and math.prod(shape_) not in own) or (
                            kind != "reduce-scatter" and shape_[0] == G):
                        raise AssertionError(f"phase 24(d): {kind} of "
                                             f"{shape_} at {site}")
    key = dryrun.line_of(layers._route, 'torch.einsum("gnd,de->gne"')
    one = 2 * G * n * d * E
    router = {"forward": sites[key], "backward": sites[f"{key} (backward)"]}
    for part, row in router.items():
        if row["flops"] * data != 2 * one:
            raise AssertionError(f"phase 24(d): the router's {part} counts "
                                 f"{row['flops']:.6e} flops on rank 0, not "
                                 f"2 x {one:.6e} / {data}")
        for product in row["shapes"]["flops"]:
            if {k for _, sh in product[1:] for k in sh} != {
                    1, G // data * n, d, E}:
                raise AssertionError(f"phase 24(d): the router's {part} "
                                     f"product {product} is not rank 0's "
                                     f"{G // data * n} tokens")
    return {"counts": totals, "router_flops": {
        k: r["flops"] for k, r in router.items()}, "router_one_device": one,
        "sites": {k: {"flops": r["flops"], "collectives": r["collectives"],
                      "shapes": r["shapes"]} for k, r in moe.items()}}


def dryrun_rows(sites: dict) -> dict:
    """Phase 24(c)'s check of fault 3.3 on rank 0's attribution of
    DRYRUN_TRAIN_CELL: the logits head's backward is one device's divided
    by the 256 ranks (its products span this rank's 8,016 vocabulary
    columns), and no collective at the head, the cross entropy, the FFN or
    attention moves an activation of the global batch: no operand has its
    rows on the leading axis, and the one activation reduce-scattered
    there is attention's K and V gradient (grouped heads), of this rank's
    rows alone (DTensor folds a reduce-scatter's scatter axis onto the
    leading one, so its elements are counted)."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, lm
    arch, shape, _ = DRYRUN_TRAIN_CELL
    chunks = dryrun.make_run(arch, shape).parallel.vocab_chunking
    cfg, sh = get_config(arch), SHAPES[shape]
    B, T, V, d = sh.global_batch, sh.seq_len, cfg.vocab_size, cfg.d_model
    data = model = 16
    head = sites[f"{dryrun.line_of(lm._logits, 'x.float() @ head')} "
                 f"(backward)"]
    one = 2 * 2 * B * T * V * d                # dx and dW, one device
    if head["flops"] * data * model != one:
        raise AssertionError(f"phase 24(c): the head's backward counts "
                             f"{head['flops']:.6e} flops on rank 0, not "
                             f"{one:.6e} / 256")
    chunk_rows = B // data * T // chunks
    for product in head["shapes"]["flops"]:
        dims = {n for _, s in product[1:] for n in s}
        if dims != {chunk_rows, V // model, d}:
            raise AssertionError(f"phase 24(c): the head's backward "
                                 f"product {product} is not this rank's "
                                 f"{chunk_rows} rows by {V // model} "
                                 f"vocabulary columns by the whole {d}")
    kv = [dryrun.line_of(layers.attention, f'src @ p["{w}"]')
          for w in ("wk", "wv")]
    rows, kv_rs, kv_width = B // data, 0, cfg.n_kv_heads * cfg.head_dim
    for site, row in dryrun.sites_in(sites, (
            lm._logits, lm.loss_fn, lm._token_nll, layers.ffn,
            layers.attention)).items():
        for kind, ops_ in row["shapes"].items():
            for operands in ops_ if kind != "flops" else ():
                for _, s in operands:
                    if kind != "reduce-scatter":
                        bad = s[0] == B
                    elif len(s) > 2:
                        bad = (not any(k in site for k in kv)
                               or math.prod(s) != rows * T * kv_width)
                        kv_rs += not bad
                    else:
                        bad = False
                    if bad:
                        raise AssertionError(f"phase 24(c): {kind} of "
                                             f"{s} at {site}")
    return {"head_backward_flops": head["flops"],
            "head_backward_one_device": one,
            "head_products": head["shapes"]["flops"],
            "reduce_scatter_bytes": sum(
                r["collectives"].get("reduce-scatter", 0)
                for r in sites.values()),
            "kv_gradient_reduce_scatters": kv_rs}


def dryrun_vs_card(dev, cfg, lm_train: dict) -> dict:
    """Phase 24(b): the dry-run's counter on a world of one (no mesh, fake
    tensors on the card) over phase 15(a)'s eager train step (the same
    run: ``cfg`` at full width, B = LM_TRAIN_B, seq LM_TRAIN_SEQ), against
    what phase 15(a) measured on the card: the largest roofline term at
    most the median eager step (a roofline is a lower bound), and the
    counted peak within DRYRUN_PEAK_RTOL of the step's peak allocated."""
    from repro_torch.launch import dryrun
    run = lm_run(cfg, LM_TRAIN_B, LM_TRAIN_SEQ, LM_TRAIN_STEPS)
    t0 = time.perf_counter()
    counted = dryrun.trace_cell(run, None, dev)
    seconds = time.perf_counter() - t0
    terms = dryrun.roofline(counted["flops"], counted["bytes"],
                            sum(counted["coll"].values()))
    step_ms = lm_train["median_ms_per_step"]
    peak = lm_train["peak_bytes"]
    out = {"flops": counted["flops"], "bytes": counted["bytes"],
           "ops": counted["ops"], "memory": counted["memory"],
           "counted_peak_bytes": counted["peak"], "roofline_terms_s": terms,
           "eager_median_ms": step_ms, "card_peak_bytes": peak,
           "peak_rel_diff": counted["peak"] / peak - 1.0, "s": seconds}
    if max(terms.values()) * 1e3 > step_ms:
        raise AssertionError(f"phase 24(b): the roofline term "
                             f"{max(terms.values()) * 1e3:.3f} ms exceeds "
                             f"the measured eager step {step_ms:.3f} ms")
    if abs(out["peak_rel_diff"]) > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"phase 24(b): counted peak {counted['peak']} "
                             f"bytes vs the card's {peak}: "
                             f"{out['peak_rel_diff']:+.4f}")
    if any(counted["coll"].values()):
        raise AssertionError(f"phase 24(b): collectives on a world of one: "
                             f"{counted['coll']}")
    return out


def print_dryrun(a: dict, b: dict, c: dict, card: str) -> None:
    cell = a["cell"]
    print(f"[phase 24] (a) {cell['arch']} {cell['shape']} on "
          f"{cell['mesh']} ({cell['chips']} fake ranks, rank 0 = one GPU): "
          f"flops {cell['flops_per_device']:.6e}, bytes "
          f"{cell['bytes_per_device']:.6e}, collective bytes "
          f"{cell['collective_bytes_per_device']:.6e} "
          f"{json.dumps(cell['collectives'])}, peak "
          f"{cell['peak_bytes_per_device']} of hbm_bytes "
          f"{cell['hbm_bytes']} (fits {cell['fits_hbm']}), terms "
          f"{json.dumps(cell['roofline_terms_s'])}, dominant "
          f"{cell['dominant']}; a model at datasheet peaks, not a "
          f"measurement")
    print(f"[phase 24] (a) memory {json.dumps(cell['memory'])}: argument "
          f"and output bytes == the JAX artifact's "
          f"({a['jax_memory']['argument_bytes']}, "
          f"{a['jax_memory']['output_bytes']}); subprocess {a['s']:.1f} s "
          f"(trace {cell['compile_s']} s)")
    print(f"[phase 24] (b) phase 15(a)'s eager step counted on one GPU: "
          f"flops {b['flops']:.6e}, bytes {b['bytes']:.6e}, {b['ops']} ops, "
          f"terms {json.dumps(b['roofline_terms_s'])} <= measured median "
          f"{b['eager_median_ms']:.3f} ms; counted peak "
          f"{b['counted_peak_bytes']} vs the card's {b['card_peak_bytes']} "
          f"({b['peak_rel_diff']:+.4f}, tol {DRYRUN_PEAK_RTOL}); trace "
          f"{b['s']:.1f} s ({card})")
    arch, shape, mesh = DRYRUN_TRAIN_CELL
    k = c["counts"]
    print(f"[phase 24] (c) {arch} {shape} on {mesh} at {DRYRUN_DEPTH} "
          f"layers: fake CUDA == CPU path: flops {k['flops']:.6e}, bytes "
          f"{k['bytes']:.6e}, {k['ops']} ops, collectives "
          f"{json.dumps(k['coll'])}, memory {json.dumps(k['memory'])}; "
          f"subprocess {c['s']:.1f} s")
    print(f"[phase 24] (c) rank 0: the head's backward "
          f"{c['head_backward_flops']:.6e} flops (x 256 = one device's "
          f"{c['head_backward_one_device']:.6e}), products "
          f"{json.dumps(c['head_products'])}; reduce-scatter "
          f"{c['reduce_scatter_bytes']:.6e} bytes; no operand of the global "
          f"batch at the head, the cross entropy, the FFN or attention "
          f"({c['kv_gradient_reduce_scatters']} K/V gradient "
          f"reduce-scatters of rank 0's rows)")
    moe = c["moe"]
    k = moe["counts"]
    arch, shape, mesh = DRYRUN_MOE_CELL
    print(f"[phase 24] (d) {arch} {shape} on {mesh} at {DRYRUN_MOE_DEPTH} "
          f"layers (the dense prelude and one MoE layer) and "
          f"{DRYRUN_MOE_SEQ} tokens, fake CUDA: flops {k['flops']:.6e}, "
          f"collectives {json.dumps(k['coll'])}, peak {k['peak']}; rank 0's "
          f"router product {json.dumps(moe['router_flops'])} flops (x 16 = "
          f"2 x one device's {moe['router_one_device']:.6e}: forward and "
          f"its recompute, the two gradients); no MoE operand of the global "
          f"batch")
    for site, row in moe["sites"].items():
        print(f"[phase 24] (d) {site}: {json.dumps(row)}")
    print(f"[phase 24] {json.dumps({'a': a['cell'], 'b': b, 'c': c})}")


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        return fail(f"the port's package is not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    from repro_torch.configs.base import SpikingConfig, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_snn_net import kernel, ops
    from repro_torch.kernels.fused_snn_step import kernel as step_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    clock = [time.perf_counter()]

    def lap(label: str) -> None:
        """Print the seconds since the last lap and since the start."""
        now = time.perf_counter()
        print(f"[time] {label}: {now - clock[0]:.1f} s (total "
              f"{now - start:.1f} s of the 1,200 s limit)")
        clock[0] = now
    print(f"[phase 1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    sources = ("fused_snn_net", "wkv6", "fused_snn_step")
    with ThreadPoolExecutor(len(sources)) as pool:    # one nvcc per source
        libs = dict(zip(sources, pool.map(_build.build, sources)))
    kernel._lib()
    wkv_kernel._lib()
    step_kernel._lib()
    print(f"[phase 1] built {', '.join(REPLACES)} from "
          f"{_build.source_path('fused_snn_net')}, wkv6 from "
          f"{_build.source_path('wkv6')} and fused_snn_step from "
          f"{_build.source_path('fused_snn_step')} in "
          f"{time.perf_counter() - t0:.2f} s")
    usage = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"[phase 1] ptxas ({name}): {line.strip()}")
        usage.update(kernel_usage(_build.ptxas_usage(log)))
    print(f"[phase 1] registers and spills: {json.dumps(usage)}")
    lap("phase 1")

    checked = phase_kernel_vs_plain(ops, dev)
    for name, (n_cases, worst) in checked.items():
        print(f"[phase 2] {name} == plain version on the card in {n_cases} "
              f"cases (max |diff| {worst})")
    lap("phase 2")

    serving = phase_serving(dev)
    print(f"[phase 3] int_ref engine on the card: "
          f"{serving['int_ref_frames_per_s']:.1f} frames/s; its first 6 "
          "requests equal int_ref on the CPU")
    for backend, row in serving["engines"].items():
        profile = row.pop("profile")
        print(f"[phase 3] {backend}: served 64 IMDB requests x 60 frames at "
              f"{row['frames_per_s']:.1f} frames/s ({row['s']:.4f} s), every "
              f"request equal to the int_ref engine; {json.dumps(row)}")
        print(f"[phase 3] {backend} profiled drain: {json.dumps(profile)}")
    lap("phase 3")

    entries, serve_ms, phase4 = [], {}, {}
    for name in REPLACES:
        serve_t = phase_timing(ops, dev, name, 32)
        big_t = phase_timing(ops, dev, name, 4096)
        phase4[name, 32], phase4[name, 4096] = serve_t, big_t
        serve_ms[name] = serve_t["ms"]
        print(f"[phase 4] {name} at K=10, B=32: {serve_t}")
        print(f"[phase 4] {name} at K=10, B=4096: {big_t}")
        engine = serving["engines"][BACKEND_OF[name]]
        n_cases, worst = checked[name]
        entries.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": engine["launches"][name],
            "max_abs_err": worst, "bit_identical": worst == 0,
            "ms": serve_t["ms"], "plain_ms": serve_t["plain_ms"],
            "bound_ms": serve_t["bound_ms"], "bound_by": serve_t["bound_by"],
            "library_ms": None, "wrapper_ms": serve_t["wrapper_ms"],
            "shape": {"T": 10, "B": 32, "widths": list(IMDB_WIDTHS),
                      **MODE_KW[name]},
            "at_b4096": big_t, "backend": BACKEND_OF[name],
            "serving_frames_per_s": engine["frames_per_s"]})
    structured = {"fused_snn_net": [], "fused_snn_net_gated": []}
    for name in ("fused_snn_net", "fused_snn_net_gated",
                 "fused_snn_net_gated", "fused_snn_net"):   # in turns
        row = phase_timing(ops, dev, name, 32, structured=True)
        print(f"[phase 4] {name} at K=10, B=32, structured raster: {row}")
        structured[name].append(row)
    big_ms = {e["name"]: e["at_b4096"]["ms"] for e in entries}
    vs_dense = {name: {
        "B32": serve_ms[name] / serve_ms["fused_snn_net"],
        "B4096": big_ms[name] / big_ms["fused_snn_net"]}
        for name in ("fused_snn_net_gated", "fused_snn_net_events")}
    vs_dense["fused_snn_net_gated"]["structured"] = (
        sum(r["ms"] for r in structured["fused_snn_net_gated"])
        / sum(r["ms"] for r in structured["fused_snn_net"]))
    print(f"[phase 4] K=10 ms at B=32 / B=4096: "
          + "; ".join(f"{n} {serve_ms[n]:.4f} / {big_ms[n]:.4f}"
                      for n in REPLACES)
          + f"; time / dense: {json.dumps(vs_dense)} ({card})")
    for entry in entries:
        name = entry["name"]
        if name in structured:
            entry["at_structured"] = structured[name]
        entry.update(redesigned_in=REDESIGNED[name], **usage[name])
        if name in vs_dense:
            entry["vs_dense"] = vs_dense[name]

    lap("phase 4")
    wkv = phase_wkv6_vs_plain(dev)
    for row in wkv["rows"]:
        print(f"[phase 5] {row} (tol {WKV_TOL} rel + {WKV_TOL} abs): ok")
    print(f"[phase 5] wkv6 == plain version on the card in "
          f"{len(wkv['rows'])} cases: max|dy| {wkv['max_abs_err_y']:.3e}, "
          f"max|ds| {wkv['max_abs_err_s']:.3e}")

    lap("phase 5")
    cfg = get_config("rwkv6-7b")
    lmrun = phase_rwkv(dev, cfg)
    profile = lmrun.pop("profile")
    lmrun_graphed = lmrun.pop("compiled")
    print(f"[phase 6] compiled decode (one graph replay a tick after the "
          f"first): served the eager drain's tokens; "
          f"{json.dumps(lmrun_graphed)} ({card})")
    print(f"[phase 6] {cfg.arch_id}: {lmrun['params']} params (bf16) drawn "
          f"on the card in {lmrun['init_s']:.2f} s; served 8 requests "
          f"({lmrun['prefills']} prefills, 2 of {LONG_PROMPT} tokens) x 16 "
          f"tokens at {lmrun['tokens_per_s']:.2f} tokens/s "
          f"({lmrun['drain_s']:.3f} s) on {card}; wkv6 launches "
          f"{lmrun['launches']['wkv6']} = {cfg.n_layers} x "
          f"{lmrun['prefills']} prefills; every logit finite")
    print(f"[phase 6] profiled drain: {json.dumps(profile)}")
    layers = lmrun.pop("layers")
    for row in layers["rows"]:
        print(f"[phase 6] wkv6 kernel vs plain on layer {row['layer']}'s "
              f"activations (tol {layers['tolerance_rel_l2']} relative L2): "
              f"{json.dumps(row)}")
    print(f"[phase 6] checks: {json.dumps(lmrun)}")
    timing = {T: phase_wkv6_timing(dev, T) for T in (16, LONG_PROMPT)}
    for T, row in timing.items():
        print(f"[phase 6] wkv6 at B=1, H=64, K=V=64, T={T}: {row} ({card})")
    main_t = timing[LONG_PROMPT]
    entries.append({
        "name": "wkv6", "route": "cuda", "source": WKV_SOURCE,
        "replaces": WKV_REPLACES, "launches": lmrun["launches"]["wkv6"],
        "max_abs_err": max(wkv["max_abs_err_y"], wkv["max_abs_err_s"]),
        "tolerance": f"{WKV_TOL} relative + {WKV_TOL} absolute",
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "wrapper_ms": main_t["wrapper_ms"],
        "shape": {"B": 1, "T": LONG_PROMPT, "H": 64, "K": 64, "V": 64},
        "at_t16": timing[16], "model": cfg.arch_id,
        "redesigned_in": REDESIGNED["wkv6"], **usage["wkv6<64, 32>"],
        "ptxas": {k: v for k, v in usage.items() if k.startswith("wkv6")},
        "serving_tokens_per_s": lmrun["tokens_per_s"],
        "device_idle_share": profile["device_idle_share"]})

    lap("phase 6")
    step = phase_step_vs_plain(dev)
    print(f"[phase 7] fused_snn_step == plain version on the card in "
          f"{step['cases']} cases (max |diff| {step['max_abs_err']})")
    fusion, layer_inputs = phase_per_layer(dev)
    print(f"[phase 8] per-layer / fused time: "
          f"{fusion['per_layer_over_fused']:.3f} ({fusion['per_layer_ms']:.4f}"
          f" / {fusion['fused_accounting_ms']:.4f} ms), without rasters "
          f"{fusion['per_layer_over_fused_serving']:.3f} "
          f"({fusion['fused_serving_ms']:.4f} ms) ({card})")
    print(f"[phase 8] per-layer dispatch (2 fused_snn_step launches + int32 "
          f"readout) == one fused_snn_net launch on the IMDB stack at "
          f"T={FUSION_T}, B={FUSION_B}: {json.dumps(fusion)} ({card})")
    shapes = {"fig9": step_case(dev, 10, 8, 128, 128, 0.15, SEED)[:2],
              "imdb_layer1": layer_inputs[0], "imdb_layer2": layer_inputs[1]}
    step_t = {}
    for label, (spikes, wq) in shapes.items():
        kw = ({"threshold": 60} if label == "fig9" else
              {"threshold": FUSION_TH, "leak": FUSION_LEAK})
        step_t[label] = phase_step_timing(dev, label, spikes, wq,
                                          neuron="rmp", **kw)
        row = step_t[label]
        print(f"[phase 7] fused_snn_step {label} (T={row['T']}, "
              f"B={row['B']}, {row['n_in']}->{row['n_out']}): "
              f"{row['ms']:.5f} ms, bound {row['bound_ms']:.3e} ms "
              f"({row['bound_by']}); {json.dumps(row)} ({card})")
    main_t = step_t["imdb_layer1"]
    entries.append({
        "name": "fused_snn_step", "route": "cuda", "source": STEP_SOURCE,
        "replaces": STEP_REPLACES,
        "launches": fusion["launches"]["fused_snn_step"],
        "max_abs_err": step["max_abs_err"],
        "bit_identical": step["max_abs_err"] == 0,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "wrapper_ms": main_t["wrapper_ms"],
        "shape": {"T": FUSION_T, "B": FUSION_B, "n_in": 100, "n_out": 128},
        "at_imdb_layer2": step_t["imdb_layer2"], "at_fig9": step_t["fig9"],
        "path": "per-layer dispatch of the IMDB stack",
        "redesigned_in": REDESIGNED["fused_snn_step"],
        **usage["fused_snn_step"],
        "ptxas": {k: v for k, v in usage.items()
                  if k.startswith("fused_snn_step<")}})

    lap("phases 7-8")
    conv = phase_conv(dev)
    launch_ms = conv["cuda_dense_launch_ms"]
    if len(launch_ms) != 3:
        raise AssertionError(f"the profiled cuda run_network shows "
                             f"{len(launch_ms)} dense launches, not 3")
    cuda_s = conv["backends"]["cuda"]["run_network_s"]
    print(f"[phase 9] cuda run_network: {cuda_s * 1e3:.3f} ms; device ms "
          f"of its dense launches "
          f"(conv 1 at B*P = {MNIST_BATCH * 196}, conv 2 at "
          f"{MNIST_BATCH * 49}, FC {'-'.join(map(str, MNIST_FC))} at "
          f"{MNIST_BATCH}): {launch_ms} ({card})")
    print(f"[phase 9] impulse-mnist, {MNIST_BATCH} images x 10 steps, every "
          f"backend equal to int_ref on the card (V, rasters, counters, "
          f"instruction counts); encoder on the card == CPU: "
          f"{json.dumps(conv)} ({card})")

    lap("phase 9")
    serve = phase_conv_serving(dev, ops)
    for backend, row in serve["streaming"].items():
        print(f"[phase 10] {backend}: 8 impulse-mnist images streamed 10 "
              f"ticks one at a time and in megasteps of 3 + 3 + 4 == "
              f"run_network (V, rasters, conv maps) in {row['s']:.3f} s")
    print(f"[phase 10] int_ref engine: 64 impulse-mnist requests x 10 frames "
          f"(arrivals 3 frames apart, 32 slots x 2 pages, K=5, validate=True)"
          f" at {serve['int_ref']['frames_per_s']:.1f} frames/s; every "
          f"request == its isolated run_network and sparsity_report; "
          f"max_safe_ticks {serve['int_ref']['max_safe_ticks']}")
    for backend, row in serve["engines"].items():
        profile = row.pop("profile", None)
        print(f"[phase 10] {backend}: served 64 impulse-mnist requests x 10 "
              f"frames at {row['frames_per_s']:.1f} frames/s ({row['s']:.4f} "
              f"s), {row['launches_per_megastep']:.0f} launches per megastep, "
              f"every request == the int_ref engine; {json.dumps(row)} "
              f"({card})")
        if profile is not None:
            print(f"[phase 10] {backend} profiled drain: "
                  f"{json.dumps(profile)} ({card})")
    print(f"[phase 10] cuda at K=4 (finishes inside a block) == int_ref at "
          f"K=4: {json.dumps(serve['cuda_k4'])}")
    for backend, row in serve["contracts"].items():
        print(f"[phase 10] contracts vs launch, {backend}: the contract pass "
              f"accepted exactly the {row['launched']} stacks that launched "
              f"and refused {row['refused']}, each as the wrapper did")
    lap("phase 10")
    oracle = phase_macro_oracle(dev)
    for name, row in oracle.items():
        print(f"[phase 11] {name} (wrap): bitmacro on the host == cuda on the "
              f"card (V, rasters, readout), macro counts == raster count less "
              f"the readout's, in {row['bitmacro_s']:.2f} s of host time: "
              f"{json.dumps(row)}")
    lap("phase 11")
    step_vs_cpu = phase_train_step_vs_cpu(dev)
    print(f"[phase 12] (a) one IMDB train step (make_train_step, SGD lr 1) "
          f"at full width, B = {TRAIN_BATCH}, {TRAIN_WORDS} words: card vs "
          f"CPU (same port code) loss {step_vs_cpu['loss_card']:.7f} / "
          f"{step_vs_cpu['loss_cpu']:.7f} (rel "
          f"{step_vs_cpu['loss_rel_diff']:.2e}, tol {TRAIN_LOSS_RTOL}), grad "
          f"norm rel {step_vs_cpu['grad_norm_rel_diff']:.2e}, gradient rel "
          f"L2 {step_vs_cpu['grad_rel_l2']} (tol "
          f"{TRAIN_GRAD_RL2}); raster sites that differ "
          f"{step_vs_cpu['raster_sites_differing']} of "
          f"{step_vs_cpu['raster_sites']}; the float backend on the int "
          f"program == int_ref == cuda on the card")
    print_compiled("[phase 12] (b) IMDB SNN", phase_snn_compiled(dev), card)
    # the training phase must leave about 4 minutes of the script's first
    # 10 for the LSTM baseline, the deployment and the last phases
    train = phase_train(dev, deadline=start + TRAIN_DEADLINE_S)
    params, (x_eval, y_eval, float_logits) = (train.pop("params"),
                                              train.pop("eval"))
    for i, loss in train["loss_every_50"].items():
        print(f"[phase 12] (b) step {i}: loss {loss:.4f}")
    fig9 = train["fig9b"]
    print(f"[phase 12] (b) {train['steps']} compiled steps, loss first 25 "
          f"{train['loss_first25']:.4f} -> last 25 {train['loss_last25']:.4f};"
          f" median {train['median_ms_per_step']:.1f} ms a step; profiled "
          f"step {json.dumps(train['profiled_step'])} ({card})")
    print(f"[phase 12] (b) Fig. 9b row: SNN {fig9['snn_params']} params, "
          f"acc {fig9['snn_acc']:.4f} (float/QAT); LSTM {fig9['lstm_params']}"
          f" params ({fig9['ratio']:.1f}x), acc {fig9['lstm_acc']:.4f}; gap "
          f"{fig9['gap_pp']:+.2f} pp (paper: about 1 pp, 8.5x)")
    print(f"[phase 12] (b) {json.dumps(train)}")
    deploy = phase_deploy(dev, params, x_eval, y_eval, float_logits)
    print(f"[phase 12] (c) trained program on int_ref, cuda, cuda_sparse "
          f"(G={GATE_G}), ref_events, cuda_events and float: all equal "
          f"bit for bit (logits, rasters, final V) on {EVAL_BATCH} reviews; "
          f"int acc {deploy['int_acc']:.4f}, agreement with float/QAT "
          f"{deploy['agreement_with_float']:.4f}; input sparsity per layer "
          f"{[round(v, 4) for v in deploy['input_sparsity']]}; "
          f"{deploy['nj_per_inference']:.3f} nJ per inference")
    print(f"[phase 12] (c) {json.dumps(deploy)} ({card})")
    ckpt = phase_checkpoint(dev)
    print(f"[phase 12] (d) checkpoint restart on the card: {json.dumps(ckpt)}")
    lenet = phase_lenet_train(dev)
    print(f"[phase 12] (e) impulse-mnist {LENET_STEPS} lenet_loss steps at "
          f"batch {LENET_BATCH}: {json.dumps(lenet)}")
    lap("phase 12")
    compiled = phase_compiled(dev)
    for name, res in compiled.items():
        for backend, row in res["backends"].items():
            print(f"[phase 13] {name} {backend}: graphed and graphed + double "
                  f"buffer == eager (every request, ledger, launches): "
                  f"{json.dumps(row)}")
        t = res["cuda"]
        print(f"[phase 13] {name} cuda frames/s (median of "
              f"{COMPILED_REPEATS}): eager {t['eager']['frames_per_s']:.1f}, "
              f"graphed {t['graphed']['frames_per_s']:.1f}, graphed + double "
              f"buffer {t['graphed_db']['frames_per_s']:.1f}; device idle "
              + ", ".join(f"{m} {t[m]['device_idle_share']:.3f}"
                          for m in DISPATCH_MODES)
              + "; device ops a megastep "
              + ", ".join(f"{m} {t[m]['device_ops_per_megastep']:.1f}"
                          for m in DISPATCH_MODES) + f" ({card})")
        print(f"[phase 13] {name} cuda timing: {json.dumps(t)} ({card})")
    lm_cmp = lmrun_graphed
    print(f"[phase 13] {cfg.arch_id} tokens/s (median of "
          f"{len(lm_cmp['eager']['s'])}): eager "
          f"{lm_cmp['eager']['tokens_per_s']:.2f}, graphed "
          f"{lm_cmp['graphed']['tokens_per_s']:.2f}; device idle eager "
          f"{lm_cmp['eager']['device_idle_share']:.3f}, graphed "
          f"{lm_cmp['graphed']['device_idle_share']:.3f}; the graphed drain "
          f"served the eager drain's tokens ({card})")
    lap("phase 13")
    dense_cfg = get_config(DENSE_ARCH)
    dense = phase_dense(dev, dense_cfg)
    print_dense(dense, dense_cfg, card)
    spk_cfg = dataclasses.replace(get_config(SPIKING_ARCH),
                                  spiking=SpikingConfig(**SPIKING))
    spk = phase_spiking(dev, spk_cfg)
    srv = spk.pop("serve")
    comp = srv.pop("compiled")
    print(f"[phase 14] (c) {SPIKING_ARCH} + spiking FFN {SPIKING}: "
          f"{spk['params']} params (bf16); served 8 requests x {LM_NEW} "
          f"tokens, every logit finite, the compiled engine == the eager "
          f"engine; tokens/s (median of 3): eager "
          f"{comp['eager']['tokens_per_s']:.2f}, graphed "
          f"{comp['graphed']['tokens_per_s']:.2f}; mean spike rate of a "
          f"{DENSE_LONG}-token prefill "
          f"{spk['prefill_spike_rate']['mean']:.4f} ({card})")
    print(f"[phase 14] (c) layer 0's spike sums, card == CPU (same port "
          f"code, recorded current): {json.dumps(spk['spike_sums_card_vs_cpu'])}")
    print(f"[phase 14] (c) {json.dumps(spk)}; serve {json.dumps(srv)}")
    print(f"[phase 14] (c) compiled vs eager drains: {json.dumps(comp)} "
          f"({card})")
    lap("phase 14")
    lm_train = phase_lm_train(dev, get_config(SPIKING_ARCH))
    checks = lm_train.pop("f32_checks")
    print_compiled(f"[phase 15] (a) {SPIKING_ARCH}",
                   lm_train.pop("compiled_runs"), card)
    prof = lm_train.pop("profiled_step")
    print(f"[phase 15] (a) {SPIKING_ARCH} at full width: {lm_train['params']}"
          f" params (bf16), AdamW (b2 0.95, wd 0.1, lr {LM_TRAIN_LR}, cosine "
          f"warm-up), remat per block, B = {LM_TRAIN_B}, seq {LM_TRAIN_SEQ}, "
          f"{LM_TRAIN_STEPS} steps: loss first 5 "
          f"{lm_train['loss_first5']:.4f} -> last 5 "
          f"{lm_train['loss_last5']:.4f}, every loss and grad norm finite; "
          f"median {lm_train['median_ms_per_step']:.1f} ms a step (last "
          f"{LM_TRAIN_STEPS // 2}); peak {lm_train['peak_bytes']} bytes, "
          f"state {lm_train['state_bytes']} bytes ({card})")
    print(f"[phase 15] (a) profiled step: {json.dumps(prof)} ({card})")
    print(f"[phase 15] (a) {json.dumps(lm_train)}")
    print(f"[phase 15] (a) float32 at full width cut to {LM_CHECK_LAYERS} "
          f"layers (B = {LM_CHECK_B}, seq {LM_CHECK_SEQ}): card vs CPU (tol "
          f"{LM_LOSS_RTOL} / {LM_GRAD_RL2}), vocab_chunking 4 vs 0 (tol "
          f"{LM_CHUNK_RTOL} / {LM_GRAD_RL2}), remat block vs none (loss "
          f"bit for bit, grads {LM_NONDET_RL2}), microbatches 2 vs 1 (tol "
          f"{LM_MB_LOSS_RTOL} / "
          f"{LM_MB_ATOL}): {json.dumps(checks)}")
    spk_train = phase_spiking_train(dev, spk_cfg)
    print_compiled(f"[phase 15] (b) {SPIKING_ARCH} + spiking FFN",
                   spk_train.pop("compiled_runs"), card)
    prof = spk_train.pop("profiled_step")
    print(f"[phase 15] (b) {SPIKING_ARCH} + spiking FFN {SPIKING} at full "
          f"width: {spk_train['params']} params (bf16), B = {SPK_TRAIN_B}, "
          f"seq {SPK_TRAIN_SEQ}, {SPK_TRAIN_STEPS} steps, remat per block: "
          f"losses {[round(x, 4) for x in spk_train['losses']]}; trained: "
          f"{json.dumps(spk_train['trained'])}; median "
          f"{spk_train['median_ms_per_step']:.1f} ms a step; peak "
          f"{spk_train['peak_bytes']} bytes ({card})")
    print(f"[phase 15] (b) profiled step: {json.dumps(prof)} ({card})")
    e = spk_train["energy"]
    print(f"[phase 15] (b) model of the silicon, not the card: FFN spike "
          f"sparsity {e['ffn_spike_sparsity']:.3f}; macro-mapped FFN energy "
          f"{e['macro_ffn_energy_nj']:.1f} nJ for {e['tokens']} tokens "
          f"({e['macro_pj_per_token']:.1f} pJ/token) at point D; EDP "
          f"reduction vs dense firing "
          f"{e['edp_reduction_vs_dense_firing'] * 100:.1f}%")
    print(f"[phase 15] (b) {json.dumps(spk_train)}")
    rwkv_train = phase_rwkv_train(dev, cfg)
    print_compiled(f"[phase 15] (c) {cfg.arch_id}",
                   rwkv_train.pop("compiled_runs"), card)
    prof = rwkv_train.pop("profiled_step")
    print(f"[phase 15] (c) {cfg.arch_id} at full width cut to "
          f"{RWKV_TRAIN_LAYERS} of {cfg.n_layers} layers (AdamW's float32 "
          f"moments of all {cfg.n_layers} would exceed the card): "
          f"{rwkv_train['params']} params (bf16), B = {RWKV_TRAIN_B}, seq "
          f"{RWKV_TRAIN_SEQ}, {RWKV_TRAIN_STEPS} steps through the chunked "
          f"wkv6 (chunk {RWKV_TRAIN_CHUNK}): losses "
          f"{[round(x, 4) for x in rwkv_train['losses']]}; wkv6 launches in "
          f"training {rwkv_train['wkv6_launches_in_training']}; gradients "
          f"upstream of the recurrence non-zero in every layer; median "
          f"{rwkv_train['median_ms_per_step']:.1f} ms a step; peak "
          f"{rwkv_train['peak_bytes']} bytes ({card})")
    print(f"[phase 15] (c) loss on batch 0 after training, chunk "
          f"{RWKV_TRAIN_CHUNK} and JAX's default of 64 (the reference's "
          f"arithmetic): {json.dumps(rwkv_train['loss_batch0_trained'])}")
    print(f"[phase 15] (c) prefill on the trained weights: "
          f"{json.dumps(rwkv_train['prefill_on_trained'])} (tol {WKV_TOL} "
          f"relative L2)")
    print(f"[phase 15] (c) profiled step: {json.dumps(prof)} ({card})")
    print(f"[phase 15] (c) {json.dumps(rwkv_train)}")
    launcher = phase_train_launcher()
    print(f"[phase 15] (d) python {launcher['cmd']}: exit "
          f"{launcher['rc']} in {launcher['s']:.1f} s; "
          + " | ".join(launcher["lines"]))
    lap("phase 15")
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    moe = phase_moe(dev, moe_cfg)
    print_moe(moe, moe_cfg, card)
    print(f"[phase 16] {json.dumps(moe)}")
    lap("phase 16")
    mla_cfg = get_config(MLA_ARCH)
    mla = phase_mla(dev, mla_cfg)
    print_mla(mla, mla_cfg, card)
    print(f"[phase 17] {json.dumps(mla)}")
    lap("phase 17")
    jamba_cfg = dataclasses.replace(get_config(JAMBA_ARCH),
                                    n_layers=JAMBA_LAYERS)
    jamba = phase_jamba(dev, jamba_cfg)
    print_jamba(jamba, jamba_cfg, card)
    print(f"[phase 18] {json.dumps(jamba)}")
    lap("phase 18")
    whisper_cfg = get_config(WHISPER_ARCH)
    whisper = phase_whisper(dev, whisper_cfg)
    print_whisper(whisper, whisper_cfg, card)
    print(f"[phase 19] {json.dumps(whisper)}")
    lap("phase 19")
    llava_cfg = get_config(LLAVA_ARCH)
    llava = phase_llava(dev, llava_cfg)
    print_llava(llava, llava_cfg, card)
    print(f"[phase 20] {json.dumps(llava)}")
    lap("phase 20")
    print_trace(phase_trace(dev, phase4), card)
    lap("phase 21")
    ranks = start_mesh_ranks()    # their start-up overlaps phase 22(a)
    try:
        mesh_one = phase_mesh_one(dev)
    finally:
        mesh_four = finish_mesh_ranks(ranks)
    mesh_launches = print_mesh(mesh_one, mesh_four, card)
    lap("phase 22")
    lm_mesh = phase_lm_mesh(dev)
    print_lm_mesh(lm_mesh, card)
    lap("phase 23")
    dry_a = dryrun_cell(Path(__file__).resolve().parent / "build"
                        / "dryrun_torch")
    free_cuda()
    dry_c = dryrun_devices()
    dry_b = dryrun_vs_card(dev, get_config(SPIKING_ARCH), lm_train)
    print_dryrun(dry_a, dry_b, dry_c, card)
    lap("phase 24")
    for entry in entries:
        if entry["name"] in BACKEND_OF:
            entry["paths"] = [
                "impulse-imdb serving (phase 3, launches)",
                "impulse-mnist run_network (phase 9)",
                "impulse-mnist conv streaming and serving (phase 10, "
                "conv_serving_launches)",
                "impulse-imdb trained and deployed (phase 12, "
                "train_deploy_launches)",
                "impulse-imdb and impulse-mnist drains as CUDA graph replays "
                "(phase 13, graphed_launches)",
                "the mesh path: a world of one and each data rank of a 4x1 "
                "mesh (phase 22, mesh_launches)"]
            entry["mesh_launches"] = mesh_launches[entry["name"]]
            entry["graphed_launches"] = {
                name: res["backends"][BACKEND_OF[entry["name"]]]["launches"][
                    entry["name"]] for name, res in compiled.items()}
            entry["conv_serving_launches"] = serve["engines"][
                BACKEND_OF[entry["name"]]]["launches"][entry["name"]]
            entry["train_deploy_launches"] = deploy["launches"][entry["name"]]
        if entry["name"] == "wkv6":
            entry["trained_prefill_launches"] = rwkv_train[
                "prefill_on_trained"]["wkv6_launches"]
            entry["train_step_launches"] = rwkv_train[
                "wkv6_launches_in_training"]
            entry["lm_mesh_launches"] = [
                r["rwkv"]["launches"] for r in lm_mesh["four"]["ranks"]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--lm-mesh-rank"]:
        sys.exit(lm_mesh_rank(sys.argv[2:]))
    sys.exit(main())
