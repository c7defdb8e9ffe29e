#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # needs one NVIDIA Hopper card and nvcc

Drives `repro_torch` only. Phases, each printing one JSON line (with the
script's wall seconds so far, ``elapsed_seconds``):

1. ``env``       versions, nvcc, the card's name and power limit.
2. ``build``     builds the CUDA sources with nvcc (seconds = set-up time),
                 with each scan kernel instance's registers, spills and
                 blocks an SM (``scan_instances``; the join lane's
                 one-predicate pass, in the scan and in the island kernel,
                 must hold 2 blocks of 512 an SM, and ptxas must read at
                 most 64 registers and no spills for it and for the island
                 kernel without the correction slice); and each instance
                 of the selective scan's backward by d_state
                 (``ssm_bwd_instances``: no spill at d_state 16, and 16
                 warps an SM or more); and each blocked-attention instance
                 (``flash_instances``: pass, head_dim, type; registers,
                 spill bytes, and the HGMMA and HMMA instructions of its
                 SASS, read with ``cuobjdump -sass``: every bf16 instance
                 must issue tensor-core instructions, the forward at the
                 paths' head_dims 64, 128 and 256 HGMMA, and no bf16
                 instance at 64, 128 or 256 may spill).
3. ``main_path`` one HTAP session of the full system (`Polynesia` preset,
                 ``backend="hopper"``) at 10,000,000 rows x 8 columns,
                 400,000 transactions, 32 queries, 4 rounds, plus one late
                 single write and query. Answers must equal the same run on
                 ``backend="torch"`` and an independent numpy evaluation
                 over the host row store; every kernel must have been
                 launched during the run, the merge unit exactly once for
                 each call of its wrappers that merges two or more runs
                 (ship batches' logs, dictionary merges: `MergeCalls`).
                 The wrappers record the shapes they launched at.
4. ``islands``   the same session on analytical islands stacked on the
                 card, once per count of ``--islands`` (4, then 3: four
                 split the 10M rows evenly, three leave padded slots, so
                 the stacked views are copies), one line per run: answers
                 and final columns must equal the one-island session's bit
                 for bit (and the host evaluation every round); the sharded
                 scan and sharded join scan must carry every query group,
                 one launch per group as on one island. No path may launch
                 the sort unit (every one-column dictionary stage rides the
                 fused apply) or the correction lane alone.
5. ``delta``     the same session on the delta-store update plane
                 (``delta_store=True``, compaction every
                 ``--delta-capacity`` appended entries), once per count of
                 ``--delta-islands`` (1, then 4), one line per run: answers
                 must equal the eager one-island session's (and the host
                 evaluation every round), and the final columns, each
                 decoded with its live overlay folded in, its values and
                 validity; the query groups must have gone through the
                 fused delta kernels with a non-empty correction stack (the
                 group scan and the join group scan on one island, their
                 sharded forms on islands, each as often as its flat form
                 on one island), and the merge unit launched once a merge
                 asked for (ship batches, dictionary merges and overlay
                 merges).
6. ``mesh``      the same session on the mesh placement: analytical island
                 s resident on its own device, each island applying its
                 own rows there, a query group one scan launch per device
                 over a table of its islands (up to 16 a launch), the
                 devices' int64 partials added on island 0's device. With
                 one card the islands share it (``devices=[cuda:0] * 4``,
                 then ``hopper@1/mesh``; ``--mesh-islands 4,1``), one line
                 per run: answers and final columns must equal the
                 one-island session's (and the host evaluation every
                 round), every view must be adopted from the Phase-2
                 install (``views_resident`` > 0, ``sharded_views`` 0), no
                 stacked or flat scan may launch, and the mesh scans must
                 launch (the sum over devices of ceil(islands there / 16))
                 times as often as one island launches the flat scans (once
                 a query group on one card). Then the same
                 four islands on the delta store (answers equal the eager
                 session's; the mesh scans alone launch, as often, the
                 correction a slice of them: their shapes must record
                 non-empty stacks, and the values delta must not launch).
                 With
                 two or more cards, ``hopper@min(4, cards)/mesh`` over
                 distinct cards with the same checks (``mesh_cards``);
                 with one, a line saying it was skipped.
7. ``elastic``   the main path through the elastic island lifecycle, one
                 line per part. ``resize``: the `hopper` session resized
                 after round 0 to 4 stacked islands, after round 1 to 4
                 mesh islands on the one card (``devices=[cuda:0] * 4``),
                 after round 2 back to one island; every round's answers
                 must equal the main path's and the host evaluation, its
                 scans be the partition's (flat, sharded, mesh; once a
                 query group; the mesh round adopting the shards the
                 resize placed), the final columns the main path's and
                 the resize trail the three transitions; each resize's
                 wall seconds and its ``reshard`` node's modeled seconds
                 (the paper's HMC parameters). ``checkpoint``: `hopper@4`
                 on the delta store checkpointed after round 2 with live
                 overlays (bytes on disk, write seconds); restored onto
                 its own spec it must finish with the uninterrupted run's
                 answers and modeled numbers, onto `hopper@2/mesh` (delta
                 store, islands on the one card) with the main path's
                 answers, and onto an eager `hopper` it must be refused
                 (restore seconds each). ``crash``: `run_with_recovery` on
                 `hopper` with the crash in round 2, after the step-2
                 checkpoint (the ship count from ``resize``), recovered
                 onto `hopper@4/mesh`: the main path's answers.
8. ``ana_only``  the `Ana-Only` preset at the same size on ``"hopper"`` and
                 ``"hopper@4"`` (the first island count): lone join queries
                 go through the bucket probe, one launch a query, against a
                 table built once per joined dictionary (``tables_built``,
                 at most the distinct join columns); answers must equal the
                 host evaluation.
9. ``float_scan`` the reference's original float32 scan
                 (``scan_filter_agg(exact=False)``, as
                 ``examples/htap_analytics.py`` calls it) for every query's
                 filter and aggregate column over the main path's final
                 columns: one launch per query; counts must equal the exact
                 scan's and the plain version's, sums lie within
                 `float_scan_error_bound` of the exact int64 sums (the worst
                 case of the kernel's summation order, about 2e-6 of
                 sum(|v|) at 10M rows) and within 1e-5 * sum(|v|) of the
                 plain version's.
10. ``mixed_traffic`` open traffic on the timeline timing model: the
                 workload's 32 queries dealt round-robin to 4 clients,
                 each issuing at 3 queries/s (exponential gaps, seed
                 ``--seed`` + 1) while the 400,000 commits arrive at
                 100,000/s: the arrivals inside the 4 s horizon, each
                 batch answered over exactly the commits before its
                 position (`htap.run_mixed_traffic`). Three runs: `hopper`
                 synchronous, `hopper` with async propagation,
                 `hopper@4/mesh` on the delta store with async propagation
                 (islands on the one card); each driven batch by batch
                 (timed) and through `run_mixed_traffic` (answers and
                 modeled numbers equal), the first held to a numpy
                 evaluation over the row store at every arrival's
                 position; the scans launch once a query group, the values
                 delta and the sort unit never. Prints the modeled
                 freshness, latency p50/p99, makespan, lane utilization
                 and throughputs (the paper's HMC parameters; for this
                 made-up schedule only, 5 - 40x fewer queries a commit
                 than ``benchmarks/fig_serve.py``'s) beside the card's
                 wall seconds a batch. Each served run is a path of its
                 own for the launch counts (``mixed_traffic``,
                 ``mixed_traffic_async``, ``mixed_traffic_mesh``).
11. ``si_baselines`` SI-SS and SI-MVCC through the same rounds as the main
                 path, at its rows: one host row store each, answered in numpy; no kernel launch and
                 no device bytes; SI-SS's answers equal the host
                 evaluation every round and Polynesia's (the round-end
                 consistency point), SI-MVCC's the host evaluation over
                 the table at each round's start. Prints snapshots /
                 versions, wall seconds a round, modeled throughputs and
                 Polynesia's modeled throughputs over each baseline's.
12. ``lm_serve``  the LM serving path at full width, one line per model of
                 ``--lm-models``: gemma2-9b (42 layers, bf16 weights from
                 `init_lm` on the card, seed ``--seed``) serves ``--lm-batch``
                 4 requests of ``--lm-prompt`` 256 prompt tokens fed one at a
                 time through `make_serve_step`, then ``--lm-gen`` 32
                 generated tokens, with a cache of 4096 slots:
                 every attention layer of every step is one flash-decode
                 launch (42 x (P + G - 1)); afterwards, untimed, the same
                 tokens go through `lm_decode_step` on a new cache: every
                 logit must be finite and each argmax the served token;
                 before serving, gemma2 (`LM_ATTN_PREFILL`) runs
                 `make_prefill_step` over 4 x `LM_ATTN_PREFILL_LEN` 4096
                 tokens twice (the first warms up; prefill tokens/s from
                 the second): every attention layer takes the blocked
                 kernel, one launch a layer and call (42 x 2), never the
                 plain blocked loop or `_sdpa`, and the logits (4,
                 256,000) must be finite;
                 falcon-mamba-7b (64 layers) runs `make_prefill_step` over 4 x
                 ``--lm-prefill`` 2048 tokens twice (64 selective-scan
                 launches and 64 causal-conv launches a call), then serves
                 as gemma2 through the plain Mamba step; the MoE models
                 llama4-scout-17b-a16e (12 of 48
                 layers) and kimi-k2-1t-a32b (1 of 61 layers: `LM_DEPTH`,
                 the layers one card holds in bf16 at full width; a depth
                 whose weights would leave under 8 GiB free is refused)
                 serve as gemma2, their MoE layers plain torch (no kernel),
                 and each line names its cut (``full_layers``,
                 ``reduced``). Before each, a cross-check at full width,
                 float32 weights and reduced depth (one period of gemma2;
                 two layers of the others): prefill logits against
                 token-by-token decode logits at every one of 64 positions,
                 2e-3 relative plus absolute (the reference's
                 ``test_decode_matches_parallel_apply``); the prefill takes
                 the plain attention or the scan kernel, the decode the
                 decode kernel or the plain step; a MoE model's capacity
                 factor is raised to E there (C = Sg: nothing drops, so
                 prefill and decode route alike), and where the float32
                 weights would leave under 8 GiB free (kimi-k2: 77.7 GB a
                 layer) the check is skipped, saying why. After each
                 model's run, 4 more serve steps under `torch.profiler`
                 give the device time per step and the device's busy
                 share; the line gives the weights' read bound of a step
                 (every weight but the embedding table over 3.35 TB/s: the
                 reference's dispatch reads every expert). For a MoE model,
                 one MoE layer of the served model at the served types
                 on the decode batch (B = 4, S = 1, so C = Sg):
                 `moe_apply`'s experts must equal a float32 oracle's
                 routing of the same bf16 input through the same float32
                 router, and its output the oracle's sum over each token's
                 k experts (their weight slices in float32) plus the shared
                 expert within 2**-6 of the oracle's largest |value|
                 (`moe_layer_check`). whisper-base (6 encoder + 6 decoder
                 layers, d 512, heads (8, 8, 64), vocab 51,865, bf16):
                 each request's 1,500 frames (the stub frontend's
                 precomputed embeddings, drawn from the seed) go through
                 `encode` and `precompute_cross_kv` once (``encode_ms``),
                 `make_prefill_step` runs the prompts against them twice,
                 then the requests are served as gemma2's against the fixed
                 cross K/V: K16 once a decoder layer and step (6 x (P + G -
                 1)), and the blocked attention (which a card takes at any
                 lengths) once an encoder layer an encode and once an
                 attention a prefill: 2 x 6 + 2 x (6 + 2 x 6);
                 its cross-check is the reference's
                 ``test_encdec_decode_matches_parallel_apply`` at full width
                 and depth in float32 (`encdec_apply` against
                 `encdec_decode_step` at 64 positions over 1,500 frames,
                 2e-3); its read bound counts the decoder's weights (not the
                 encoder's nor the cross K/V projections) and, beside it,
                 the cross K/V.
13. ``lm_train``  the benchmark's ``fm7b-train`` cell (`TRAIN_CELL`) as its
                 files define it, its training object built by
                 `bench/drivers/lm_train.py`: the
                 configuration's widths and depth (falcon-mamba-7b at 16
                 of 64 layers, ``reduced``), its seeded bf16 weights,
                 remat, its AdamW, and the traffic's batch, sequence,
                 micro-batches, initial token column and tokens ingested a
                 step through an `HTAPTokenPipeline` on the card (ship,
                 K5; the one-column apply, K7; the snapshot at the pinned
                 read, K10); `LM_TRAIN_STEPS` 4 of its `Program.step`s.
                 Before them, a gradient cross-check of the cell's block
                 at 2 layers, full width, float32, 1 x 512 tokens: the
                 loss and every parameter's gradient on the card (the
                 gated scan kernel and its backward kernel) against the
                 same model's on the CPU (the plain chain under autograd),
                 within 1e-3 of each leaf's largest |g|. The steps run
                 under `tracing.recording()`. Fails on a loss that is not
                 finite, on selective-scan or causal-conv launches other
                 than layers x 2 (remat) x micro-batches x steps or
                 backward calls of either other than layers x
                 micro-batches x steps, unless every scan launch was a
                 Mamba call through the gated scan (the count
                 ``mamba.gated_scan``, printed as ``gated_scans``), on
                 AdamW launches other than
                 `adamw_launches` a step, where the pipeline launched no
                 K5, K7 or K10, where a step left an ingested token
                 unapplied (a freshness lag), and on a batch that is not
                 the reference's window of the seed's token column.
                 Prints the cell's sizes, the peak device bytes and the
                 losses; the cell's throughput is the benchmark's
                 (``train_tokens_per_s``), not this phase's.
14. ``lm_train``  (whisper-base) the encoder-decoder's training at full
                 width and depth: bf16, remat, loss chunks of 512, AdamW
                 (`default_optimizer_for`), lr 1e-4, 4 steps of 2 x 4,096
                 tokens (a `SyntheticPipeline`) against 4,096 frames a
                 sequence (the reference's train_4k: enc_len = dec_len),
                 one micro-batch. Every attention (the encoder's, the
                 decoder's self and cross) takes the blocked attention
                 (`nn.flash`) through its kernel and, in the backward, its
                 two backward kernels: fails unless it ran (6 + 2 x 6) x 2
                 (remat) = 36 times a step, one forward launch each, its
                 backward 18 times a step, two launches each (the dQ pass
                 and the dK/dV pass), AdamW's kernel `adamw_launches` a
                 step, on any other kernel's launch, on a
                 call of `_sdpa` or of the plain blocked loop, and on a
                 loss that is not finite. Before it, a gradient
                 cross-check at 1 encoder + 1 decoder layer, full width,
                 float32, B 1, S = T = 2,048 (the blocked branch): the
                 loss and every parameter's gradient on the card against
                 the same model's on the CPU (the plain blocked loop under
                 autograd), within 1e-3 of each leaf's largest |g|
                 (`encdec_grad_check`). Prints ms a step, tokens/s,
                 peak bytes and one step under `torch.profiler` with the
                 blocked attention's own device time and share
                 (``profile.ranges``: its forward and recompute calls and
                 the autograd nodes of its forward ops, `own_ops`).
15. ``kernels``   first the blocked attention, forward and backward, at
                 whisper-large-v3's three shapes (16 clips; bidirectional
                 1,500, causal 448, cross 448 x 1,500; bf16) and at every
                 pair of Sq and Skv in 1, 63, 65, 449, 1,500, causal and
                 not, float32 and bf16 (`edge_flash_whisper`), and one
                 training step of whisper-large-v3 at full width and
                 lengths, 2 + 2 layers, under `tracing.recording()`: the
                 count ``attn.plain_calls`` must read 0 and the blocked
                 attention run 12 forward launches (3 attentions x 2
                 layers x 2 with remat) and 6 backward calls of two
                 launches a micro-batch (`whisper_step_check`,
                 ``whisper_step`` in the line); then
                 every hand-written kernel launched on the card and held
                 against its plain PyTorch version - the HTAP kernels with
                 exact equality (integers: tolerance 0), flash-decode
                 attention at 2e-5 and the selective scan at 3e-5 in float32
                 (a bf16 cache is compared after up-casting; flash-decode
                 with bf16 queries and output, as serving runs it, within
                 one bf16 rounding more: 2**-8 relative), the float32
                 scan as in ``float_scan`` - at edge shapes and at the
                 shapes the path just gave it (the one it launched most, and
                 the largest where that is another; for the sharded scans
                 also the one each other island count launched most, under
                 ``at_islands``; for flash-decode also the ``decode_32k``
                 cache length, S = 32768 at B = 4, with gemma2's heads under
                 ``at_decode_32k`` and kimi-k2's (H 64, Hkv 8, d 112) under
                 ``at_decode_32k_d112``, and at the shape each other head
                 layout (H, Hkv, d) of ``lm_serve`` launched most under
                 ``at_heads`` ("H/Hkv/d"), each with its splits, waves,
                 achieved GB/s and ptxas' registers; for the merge unit
                 the k-way merge at a ship batch's shape, four runs of 256,
                 under ``at_ship`` where the path launched another most,
                 and bit for bit at k in {1, 2, 3, 4, 7, 8, 70} with empty
                 and one-entry runs, ties across runs, int64.max and
                 inputs too large for shared memory; for the selective
                 scan ptxas' registers and spills of each instance; for
                 the blocked attention (``flash_attention``, replacing no
                 Pallas kernel: the reference's is a jitted nested scan) the
                 output within 2e-4 in float32 (the reference's own
                 flash-vs-SDPA tolerance) and a bf16 output as
                 flash-decode's, the log-sum-exp within 2e-4, at edge
                 shapes (ragged lengths, Sq != Skv, a window shorter than
                 S with whole leading tiles masked, Sq > Skv, head_dim 112
                 at G 8 and 128 at G 5, float32 and bf16) and at every
                 shape the paths ran (``at_shapes``), with
                 ``bound_fp32_ms`` (its products at the float32 rate)
                 beside the bound, and ``F.scaled_dot_product_attention``
                 as the library call where no softcap or window is asked;
                 for its backward (``flash_attention_bwd``, two launches a
                 call) dq, dk, dv within 1e-4 (bf16: one bf16 step more) of
                 each one's largest |value| at the same shapes, two identical
                 calls equal bit for bit, and the autograd backward of one
                 SDPA call as the library row; for the scan's backward
                 (``selective_scan_bwd``, the port's own kernel: the
                 reference differentiates its plain scan) the six
                 gradients within 1e-4 of each one's largest |value| at
                 the scan's edge shapes and the path's, two identical
                 calls equal bit for bit; at the scan's shapes also the
                 gated forms the paths run (``gated``: dt's bias and
                 softplus before the scan and the silu(z) gate after it,
                 bf16, z the in-projection's strided half), forward and
                 backward, against the same chain in float32 on the same
                 operands (y within the scan's 3e-5 and one bf16 ulp;
                 each gradient within 1e-4 of its largest |value| and one
                 bf16 ulp), timed beside the benchmark's bound and the
                 chain they replaced (``chain_ms``: bf16 softplus, float32
                 copies, the plain kernel, the gate; its backward by
                 autograd), and at the scan's edge shapes in bf16 and
                 float32, z also contiguous and off a 4-byte boundary,
                 the backward bit for bit repeatable; for the bucket
                 probe
                 the host's cost of one launch, item by item, under
                 ``host_us``; for the join scans and the float32 scan the
                 instances they ran, under ``instances``; the join lane
                 bit for bit at Q = 1, 2, 8, 9 and 17 over views 0 - 3
                 rows into their columns, columns at different offsets,
                 shards off 16-byte boundaries and correction stacks of 0
                 and 1 rows; the float32 scan at views 0 - 3 rows in and
                 twice a case, the two sums bit for bit one);
                 times the kernel (``ms``: back-to-back bare launches;
                 ``device_ms``: the device's own time of 20 bare launches
                 under `torch.profiler`, a launch, for small kernels well
                 below ``ms``, which is then the host's launch rate;
                 ``wrapper_ms``: through the public wrapper with its checks
                 and allocations), the plain version and, where one PyTorch
                 call computes the same function, that call; for the delta
                 groups also the same launch without the correction lane
                 (``base_ms``, ``base_device_ms``), and for the mesh scans
                 the delta plane's launches with the correction slice
                 (``with_correction``, beside the same launches without
                 it). The tile merge (K6, ``bitonic_merge_rows``)
                 runs only where a sort row is wider than 32,768 keys: it is
                 reported with its launches on every path
                 (``launches_by_path``, 0 where none) and measured at the
                 shape a path gave it, else at (2, 32768, 32768), with
                 ``torch.sort`` of the concatenated runs beside it.
                 AdamW's update (``adamw``, replacing no Pallas kernel:
                 the reference's is plain jnp) bit for bit against its
                 plain loop, parameters, m, v and masters compared with
                 ``torch.equal``, at edge leaves (ragged, empty, 16-byte
                 unaligned views, float32 with and without masters, more
                 leaves than one launch takes) and at the group of leaves
                 each training path launched most (the counted elements
                 split evenly over the counted leaves), with ptxas'
                 registers of each instance and
                 ``torch.optim.AdamW(fused=True)`` over float32 weights as
                 the library row (a yardstick only: other arithmetic).
                 The causal conv with its bias and SiLU (``causal_conv``,
                 replacing no Pallas kernel: the reference's is plain jnp)
                 and its backward (``causal_conv_bwd``: two launches a
                 call, counted once) against their plain versions computed
                 in float32 on the same operands, within one rounding to
                 the kernel's type (2**-7 of the value in bf16, 1e-5 in
                 float32) plus 1e-5 of the largest |value|, dw and db bit
                 for bit from two identical calls, at edge shapes (ragged
                 T and D, one step, one channel, x the in-projection's
                 strided half, a contiguous copy, a view off a 16-byte
                 boundary; bf16 and float32) and at the shapes the paths
                 ran (x strided as the paths hand it over), with ptxas'
                 registers of each instance; the plain row is the bf16
                 chain the kernel replaced (forward; the backward by
                 autograd through it).

Each kernel is checked against the path that runs it (counts set to 0 just
before the path, read just after): the one-island kernels against
``main_path``, the sharded scans against ``islands``, the delta kernels
against ``delta``, the mesh scans against ``mesh`` (counted under
``scan_exact_mesh`` and ``scan_exact_join_mesh`` a launch, at (islands in
the launch, widest island, ...), measured with the islands on one card),
the bucket
probe against ``ana_only``, the float32 scan
against ``float_scan``, flash-decode attention against ``lm_serve``
(each model's serve run; whisper's heads (8, 8, 64) under
``at_heads``), the selective scan against ``lm_serve`` and ``lm_train``
(launched on each, counted over both) and its backward against
``lm_train``, the blocked attention against ``lm_serve`` (gemma2's
prefill) and ``encdec_train`` (whisper's training, counted over both) and
its backward against ``encdec_train``, AdamW's update against
``lm_train`` and ``encdec_train`` (counted over both), the causal conv
against ``lm_serve`` and ``lm_train`` (counted over both) and its backward
against ``lm_train``. ``elastic`` is a path of
its own that runs kernels already held to these (no kernel is measured
against it); like every path it may not launch the kernels folded into
others (`NEVER_ON_PATH`). The correction lane alone
(the values delta, and the raw-value scan, its kernel over a 3-row stack,
held and timed beside it under ``raw_value_scan``) and the sort unit have
no caller on these paths: the lane rides the scan launches and the sort
unit the fused apply. They are held to their plain versions at edge shapes
and measured at NO_CALLER_SHAPE, with their launches on every path
(``launches_by_path``). Each kernel's ``bound_ms`` is its least time at
the shape, and ``bound_by`` the bound that binds: the benchmark's
(`bench/yardstick.py`, `bench/whisper_yardstick.py`) for the exact scans
and the forms built on their cost, the selective scan and its backward
(bytes or exponentials on the SFUs) and the blocked attention and its
backward (products or exponentials; a backward call is two launches);
for the others the larger of their bytes at 3.35 TB/s and their
operations at 67 Tops/s. Then the ``{"kernels": [...]}``
summary, the card's name and power limit, and as the last line ``{"ok":
true, "device": {...}}``. Any failed phase raises: the script exits
non-zero and prints no result. Without CUDA it exits with code 2 before
doing anything.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

STARTED = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the card's peaks and the kernels' least times are the benchmark's
from bench.trace import _on_device  # noqa: E402
from bench.whisper_yardstick import band_pairs, flash_bound_s  # noqa: E402
from bench.yardstick import (ALU_OPS_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                             max_sm_clock_hz, scan_cost, ssm_bound_s,
                             ssm_bwd_cost, ssm_cost)

REPLACES = {
    "scan_exact": "src/repro/kernels/dict_ops/dict_ops.py:63",
    "scan_exact_join": "src/repro/kernels/hash_probe/ops.py:218",
    "scan_exact_sharded": "src/repro/kernels/dict_ops/dict_ops.py:121",
    "scan_exact_join_sharded": "src/repro/kernels/hash_probe/ops.py:244",
    "hash_probe": "src/repro/kernels/hash_probe/hash_probe.py:90 "
                  "(sharded form: hash_probe.py:68)",
    "merge_runs": "src/repro/kernels/merge_runs/merge_runs.py:94",
    "bitonic_sort": "src/repro/kernels/bitonic_sort/bitonic_sort.py:103",
    "bitonic_merge_rows": "src/repro/kernels/bitonic_sort/bitonic_sort.py:123",
    "bitonic_apply": "src/repro/kernels/dict_ops/ops.py:310 "
                     "(bitonic_sort.py:103 + bitonic_sort.py:123)",
    "snapshot_copy": "src/repro/kernels/snapshot_copy/snapshot_copy.py:54",
    "scan_exact_group": "src/repro/kernels/dict_ops/ops.py:372 "
                        "(dict_ops.py:63 + 2 x dict_ops.py:176)",
    "scan_exact_group_sharded": "src/repro/kernels/dict_ops/ops.py:414 "
                                "(dict_ops.py:121 + 2 x dict_ops.py:176)",
    "scan_exact_join_group": "src/repro/kernels/hash_probe/ops.py:383 "
                             "(2 x dict_ops.py:63 + 4 x dict_ops.py:176)",
    "scan_exact_join_group_sharded": "src/repro/kernels/hash_probe/ops.py:244"
                                     " + 2 x src/repro/kernels/dict_ops/"
                                     "ops.py:453 (composed at src/repro/core/"
                                     "backend.py:253)",
    "scan_values_delta": "src/repro/kernels/dict_ops/ops.py:453 "
                         "(2 x dict_ops.py:176; the raw-value scan "
                         "dict_ops.py:176 alone is raw_value_scan)",
    "scan_exact_mesh": "src/repro/kernels/dict_ops/ops.py:539 "
                       "(_mesh_scan_call; dict_ops.py:121 per island; on "
                       "the delta plane + dict_ops/ops.py:453)",
    "scan_exact_join_mesh": "src/repro/kernels/hash_probe/ops.py:431 "
                            "(_mesh_join_call; 2 x dict_ops.py:121 per "
                            "island; on the delta plane + 2 x dict_ops/"
                            "ops.py:453)",
    "scan_float": "src/repro/kernels/dict_ops/dict_ops.py:218",
    "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:74",
    "selective_scan": "src/repro/kernels/selective_scan/selective_scan.py:59",
    "selective_scan_bwd": "none: the reference takes this gradient by "
                          "autodiff of src/repro/kernels/selective_scan/"
                          "ref.py:7 (no Pallas backward)",
    "flash_attention": "none: src/repro/nn/flash.py:30 is a jitted nested "
                       "lax.scan (plain jnp)",
    "flash_attention_bwd": "none: jax.grad of the same",
    "adamw": "none: src/repro/optim/adamw.py is plain jnp (XLA fuses it)",
    "causal_conv": "none: src/repro/nn/mamba.py:37 `_causal_conv` and its "
                   "silu are plain jnp (XLA fuses them)",
    "causal_conv_bwd": "none: jax.grad of the same",
}
SOURCES = {
    "scan_exact": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "hash_probe": "src/repro_torch/kernels/csrc/hash_probe.cu",
    "merge_runs": "src/repro_torch/kernels/csrc/merge_runs.cu",
    "bitonic_sort": "src/repro_torch/kernels/csrc/bitonic.cu",
    "bitonic_merge_rows": "src/repro_torch/kernels/csrc/bitonic.cu",
    "bitonic_apply": "src/repro_torch/kernels/csrc/bitonic.cu",
    "snapshot_copy": "src/repro_torch/kernels/csrc/snapshot_copy.cu",
    "scan_exact_group": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_group_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_group": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_group_sharded":
        "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_values_delta": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_mesh": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_mesh": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_float": "src/repro_torch/kernels/csrc/scan_float.cu",
    "decode_attn": "src/repro_torch/kernels/csrc/decode_attn.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
    "selective_scan_bwd": "src/repro_torch/kernels/csrc/selective_scan.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attn.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attn.cu",
    "adamw": "src/repro_torch/kernels/csrc/adamw.cu",
    "causal_conv": "src/repro_torch/kernels/csrc/causal_conv.cu",
    "causal_conv_bwd": "src/repro_torch/kernels/csrc/causal_conv.cu",
}
# the path that runs each kernel (or the paths: the kernel must launch on
# each): its launches are counted on that path (summed over the paths)
PATH_OF = {"scan_exact_sharded": "islands",
           "scan_exact_join_sharded": "islands", "hash_probe": "ana_only",
           "scan_exact_group": "delta", "scan_exact_group_sharded": "delta",
           "scan_exact_join_group": "delta",
           "scan_exact_join_group_sharded": "delta",
           "scan_values_delta": "delta",
           "scan_exact_mesh": "mesh", "scan_exact_join_mesh": "mesh",
           "scan_float": "float_scan", "decode_attn": "lm_serve",
           "merge_runs": ("main_path", "lm_train"),
           "bitonic_apply": ("main_path", "lm_train"),
           "snapshot_copy": ("main_path", "lm_train"),
           "selective_scan": ("lm_serve", "lm_train"),
           "selective_scan_bwd": "lm_train",
           "flash_attention": ("lm_serve", "encdec_train"),
           "flash_attention_bwd": "encdec_train",
           "adamw": ("lm_train", "encdec_train"),
           "causal_conv": ("lm_serve", "lm_train"),
           "causal_conv_bwd": "lm_train"}
# kernels a path launches only for some data, or none: the tile merge (K6)
# sorts a row wider than one tile's 32,768 keys, which the paths may not
# have; the sort unit (K4) sorts only a dictionary stage the fused apply
# cannot take (values at the int32.max pad or beyond int32); the correction
# lane alone (K13) has no caller (it rides the scans' launches). Each is
# reported with its launches on every path, measured at the shape a path
# launched most or, where none did, at NO_CALLER_SHAPE, and is not required
# to have launched.
NO_CALLER_SHAPE = {"bitonic_merge_rows": (2, 32768, 32768),
                   "bitonic_sort": (1, 1024),
                   "scan_values_delta": (4031, 1)}
# ... and of those, the kernels no path of this workload may launch: its
# values never reach int32.max, and every correction rides a scan
NEVER_ON_PATH = ("bitonic_sort", "scan_values_delta")


def adamw_launches(model, opt_state) -> int:
    """AdamW's kernel launches a step (`repro_torch.kernels.adamw`): the
    wrapper's own groups of the model's leaves (`launch_groups`: up to
    MAX_LEAVES leaves of one parameter type, with or without a master),
    those that hold an element."""
    from repro_torch.kernels.adamw import launch_groups
    masters = opt_state.get("master", {})
    leaves = [(p, None, None, None, masters.get(k))
              for k, p in model.named_parameters()]
    return sum(1 for g in launch_groups(leaves)
               if any(leaves[i][0].numel() for i in g))


def paths_of(kernel: str) -> tuple[str, ...]:
    path = PATH_OF.get(kernel, "main_path")
    return path if isinstance(path, tuple) else (path,)
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_seconds": time.perf_counter() - STARTED}),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card over `reps` launches (CUDA
    events around the whole run, after min(reps, 10) warm-up calls: after
    one, a long kernel's first timed launches still ran slower)."""
    for _ in range(min(reps, 10)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


DEVICE_REPS = 20


def device_time(fn, reps: int = DEVICE_REPS) -> dict:
    """`fn`'s device time under `torch.profiler`, a call (``device_ms``):
    for each CUDA kernel (or copy) its `reps` calls ran, its mean own time
    times the launches of it a call (its count over `reps`, rounded: the
    profiler has been seen to drop an event of 20), summed; and the
    kernels a call (``device_kernels``). The profiler has been seen to
    record no device time at all in one window of many (K17, K18), so an
    empty window is profiled once more; where the second records nothing
    either, the CUDA-event time of the same calls stands in, and
    ``device_ms_source`` says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0]
        if kernels:
            break
    if not kernels:
        return dict(device_ms=time_ms(fn, reps), device_kernels=None,
                    device_ms_source="cuda events (the profiler recorded "
                                     "no device time)")
    a_call = [max(1, round(e.count / reps)) for e in kernels]
    return dict(device_ms=sum(e.self_device_time_total / e.count * n
                              for e, n in zip(kernels, a_call)) / 1e3,
                device_kernels=sum(a_call),
                device_events=sum(e.count for e in kernels),
                device_ms_source="torch.profiler")


def max_abs_err(got, want) -> int:
    """Largest absolute difference over (tuples of) integer tensors."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def must_be_close(name: str, got, want, tol: float) -> float:
    """Largest absolute difference of two float tensors (after up-casting
    to float32); raises above `tol` relative plus absolute."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"kernel check {name!r}: differs from its plain "
                             f"version (max abs err {err}, tolerance {tol} "
                             "relative plus absolute)")
    return err


# A bf16 output against the plain version's float32 answer on the same
# (bf16-valued) inputs: 2e-5 relative plus absolute for the float32 work,
# then one round-to-nearest to bf16, at most 2**-8 of the value.
BF16_OUT_ATOL = 2e-5 * (1 + 2**-8)
BF16_OUT_RTOL = 2**-8 + BF16_OUT_ATOL


def must_be_close_bf16(name: str, got, want) -> float:
    """`got` bf16, `want` float32; raises outside BF16_OUT_RTOL relative
    plus BF16_OUT_ATOL absolute; returns the largest absolute difference."""
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: output {got.dtype}, not bfloat16")
    got = got.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(
            got, want, rtol=BF16_OUT_RTOL, atol=BF16_OUT_ATOL):
        raise AssertionError(f"kernel check {name!r}: bf16 output differs "
                             f"from its plain version (max abs err {err}, "
                             f"tolerance {BF16_OUT_RTOL} relative plus "
                             f"{BF16_OUT_ATOL})")
    return err


def must_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"kernel check {name!r}: differs from its plain "
                             f"version (max abs err {err}, tolerance 0)")
    return err


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def phase_env() -> str:
    from repro_torch.kernels import build
    nvcc = subprocess.run([build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.splitlines()[-1], card=card,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    return card


def phase_build() -> None:
    """Builds (with ptxas' report of each kernel's registers, when the
    library is not built yet) and loads the kernels."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_library(verbose_ptxas=True)
    nvcc_seconds = build.build_seconds()     # 0.0 when found built
    build.load_library()
    registers, entry = {}, None
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            SPILLS[entry] = sum(int(w) for w in re.findall(
                r"(\d+) bytes spill", line))
        elif "registers" in line and entry:
            registers[entry] = int(line.split("Used ")[1].split()[0])
    REGISTERS.update(registers)
    instances = scan_instances()
    narrow = dict(join_instances(1), **{
        island_key(1, c, 1): instances[island_key(1, c, 1)] for c in (0, 1)})
    if any(v["blocks_per_sm"] < 2 for v in narrow.values()):
        raise AssertionError(f"the join lane's one-predicate pass holds "
                             f"fewer than 2 blocks of 512 an SM: {narrow}")
    # ptxas (where this process built the library): the one-predicate join
    # instances and the island kernel without the correction slice at most
    # 64 registers, no spills
    tight = dict(narrow, **{island_key(j, 0, q): instances[island_key(j, 0, q)]
                            for j, q in ((0, 8), (1, 1))})
    bad = {k: v for k, v in tight.items() if "registers" in v and (
        v["registers"] > 64 or v["spill_bytes"]) and (
        "islands" not in k or ",base," in k)}
    if bad:
        raise AssertionError(f"ptxas: more than 64 registers or spills: "
                             f"{bad}")
    # the selective scan's backward: no spill at d_state 16, and every
    # instance holds 16 warps an SM or more
    bwd = ssm_bwd_instances()
    bad = {k: v for k, v in bwd.items()
           if (k == "N16" and v.get("spill_bytes"))
           or v["warps_per_sm"] < 16}
    if bad:
        raise AssertionError(f"selective_scan_bwd: a spill at N = 16, or "
                             f"under 16 warps an SM: {bad}")
    # the blocked attention: tensor-core instructions in every bf16
    # instance's SASS, no spill on the paths' head_dims
    flash = flash_registers()
    for key, ops in flash_sass(sass_text(build.build_library())).items():
        flash.setdefault(key, {}).update(ops)
    flash_build_check(flash)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=nvcc_seconds,
         sources=sorted(p.name for p in build.CSRC.glob("*.cu")),
         library=str(build.build_library().name), registers=registers,
         scan_instances=instances, ssm_bwd_instances=bwd,
         flash_instances=flash)


REGISTERS: dict[str, int] = {}     # ptxas' count per kernel entry (build)
SPILLS: dict[str, int] = {}        # ptxas' spill stores + loads, bytes


def scan_key(join, vec, corr, qn) -> str:
    return (f"scan_exact<{'join' if join else 'scan'},"
            f"{'vec' if vec else 'rows'},{'corr' if corr else 'base'},"
            f"qn={qn}>")


def island_key(join, corr, qn) -> str:
    return (f"scan_islands<{'join' if join else 'scan'},"
            f"{'corr' if corr else 'base'},qn={qn}>")


def values_key(qn) -> str:
    return f"values<qn={qn}>"


def float_key(vec) -> str:
    return f"scan_float<{'vec' if vec else 'rows'}>"


def instance_key(entry: str) -> str | None:
    """The scan kernel instance a ptxas entry name is, if it is one."""
    for pat, key in (
            (r"scan_exact_kernelILb([01])ELb([01])ELb([01])ELi(\d+)EE",
             scan_key),
            (r"scan_islands_kernelILb([01])ELb([01])ELi(\d+)EE",
             island_key),
            (r"values_kernelILi(\d+)EE", values_key),
            (r"scan_float_kernelILb([01])EE", float_key)):
        m = re.search(pat, entry)
        if m:
            return key(*(int(x) for x in m.groups()))
    return None


def scan_instances() -> dict[str, dict]:
    """Per instance of the exact scan's kernel (join lane or not, 16-byte
    loads or rows, correction slice or base, predicates a pass), of the
    island kernel (join lane or not, correction slice or base, predicates a
    pass), of the correction lane alone (predicates a pass) and of the
    float scan: the occupancy API's blocks an SM (512 threads a block for
    the scans, 256 for the float scan; not asked for the lane alone) and,
    when this process built the library, ptxas' registers and spill
    bytes."""
    import ctypes
    from repro_torch.kernels import build
    ptxas = {instance_key(e): dict(registers=n, spill_bytes=SPILLS.get(e, 0))
             for e, n in REGISTERS.items()}

    def occupancy(name, *args):
        blocks = ctypes.c_int(0)
        build.check(build.entry(name)(*args, ctypes.byref(blocks)), name)
        return blocks.value
    out = {}
    for j, q in ((0, 8), (1, 1), (1, 8)):
        for v in (0, 1):
            for c in (0, 1):
                key = scan_key(j, v, c, q)
                out[key] = dict(ptxas.get(key, {}), blocks_per_sm=occupancy(
                    "scan_exact_occupancy", j, v, c, q))
    # the island kernel: the scan with the correction slice also takes one
    # predicate a pass
    for j, c, q in ((0, 0, 8), (0, 1, 1), (0, 1, 8), (1, 0, 1), (1, 1, 1),
                    (1, 0, 8), (1, 1, 8)):
        key = island_key(j, c, q)
        out[key] = dict(ptxas.get(key, {}), blocks_per_sm=occupancy(
            "scan_islands_occupancy", j, c, q))
    for q in (1, 8):
        out[values_key(q)] = dict(ptxas.get(values_key(q), {}),
                                  blocks_per_sm=None)
    for v in (0, 1):
        out[float_key(v)] = dict(ptxas.get(float_key(v), {}),
                                 blocks_per_sm=occupancy(
                                     "scan_float_occupancy", v))
    return out


def join_qn(nq: int) -> int:
    """Predicates a pass of the join lane (and of the island kernel with
    the correction slice) for a Q-predicate group (the host's choice in
    scan_exact.cu)."""
    return 1 if nq == 1 else 8


def join_instances(nq: int) -> dict[str, dict]:
    """The join lane's instances a Q-predicate group runs (by 16-byte
    loads and correction slice)."""
    every = scan_instances()
    keys = [scan_key(1, v, c, join_qn(nq)) for v in (0, 1) for c in (0, 1)]
    return {k: every[k] for k in keys}


def ssm_bwd_instances() -> dict[str, dict]:
    """Per instance of the selective scan's backward ("N<d_state>", the
    plain form; "N<d_state> gated bf16", the gated form the training path
    runs): its lanes a channel, the occupancy API's resident blocks and
    warps an SM, and, when this process built the library, ptxas'
    registers and spill bytes."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import BWD_CHANNELS, BWD_LANES
    ptxas = ssm_registers(backward=True)
    out = {}
    for n, lb in BWD_LANES.items():
        for gated in ("0", "1"):
            blocks = ctypes.c_int(0)
            build.check(build.entry("selective_scan_bwd_occupancy")(
                n, int(gated), 1, ctypes.byref(blocks)),
                "selective_scan_bwd_occupancy")
            key = ssm_instance(n, gated, "bfloat16")
            out[key] = dict(ptxas.get(key, {}), lanes=lb,
                            blocks_per_sm=blocks.value,
                            warps_per_sm=blocks.value * BWD_CHANNELS * lb
                            // 32)
    return out


def decode_registers() -> dict[str, int]:
    """ptxas' registers of each instance of the flash-decode split pass:
    the float32-cache pass by G bucket, the bf16-cache (mma) pass by query
    type."""
    out = {}
    for entry, n in REGISTERS.items():
        m = re.search(r"decode_attn_(simt|mma)ILi(\d+)E", entry)
        if m and m.group(1) == "simt":
            out[f"float32 cache, G<={m.group(2)}"] = n
        elif m:
            q = "bf16" if m.group(2) == "1" else "float32"
            out[f"bf16 cache, {q} q"] = n
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def host_answers(data: np.ndarray, queries) -> list[int]:
    """Independent numpy evaluation of each query over a row-store table: a
    join weighs each selected row by its join value's count in the table."""
    cols, counts, out = {}, {}, []

    def col(c):
        if c not in cols:
            cols[c] = np.ascontiguousarray(data[:, c])
        return cols[c]

    for q in queries:
        fvals = col(q.filter_col)
        mask = (fvals >= q.lo) & (fvals <= q.hi)
        res = int(col(q.agg_col)[mask].sum(dtype=np.int64))
        if q.join_col is not None:
            jvals = col(q.join_col)
            if q.join_col not in counts:
                # the schema's values lie in [0, 2**24); bincount raises
                # on a negative one
                counts[q.join_col] = np.bincount(jvals)
            res += int(counts[q.join_col][jvals[mask]].sum(dtype=np.int64))
        out.append(res)
    return out


def sync(dev) -> None:
    """Wait for the card (a CPU device has nothing to wait for)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def drive(spec, table, stream, late, queries, late_query, n_rounds,
          check_host: bool, devices=None, device=None):
    """One session through the public entry points: n_rounds of
    execute + query_batch, then one late single write and one query.
    Returns (answers, seconds per round, session, RunResult)."""
    from repro_torch.core.session import HTAPSession
    from repro_torch.core.workload import split_queries, split_stream
    session = HTAPSession(spec, table, device=device, devices=devices)
    answers, seconds = [], []
    rounds = list(zip(split_stream(stream, n_rounds),
                      split_queries(queries, n_rounds)))
    rounds.append((late, [late_query]))
    for r, (chunk, qs) in enumerate(rounds):
        if r:
            session.advance_round()
        t0 = time.perf_counter()
        session.execute(chunk)
        got = session.query_batch(qs)
        sync(session.device)
        seconds.append(time.perf_counter() - t0)
        if check_host:
            want = host_answers(session.store.data, qs)
            if got != want:
                raise AssertionError(
                    f"round {r}: answers differ from the host evaluation: "
                    f"{got} != {want}")
        answers.extend(got)
    return answers, seconds, session, session.finish()


def make_workload(args) -> dict:
    """The sessions' workload from --seed: table, update stream, queries,
    one late single write and one late query."""
    from repro_torch.core import engine, schema
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    sch = schema.make_schema("t", args.cols, 32)
    table = schema.gen_table(rng, sch, args.rows)
    stream = schema.gen_update_stream(rng, sch, args.rows, args.txns,
                                      write_ratio=0.5)
    queries = engine.gen_queries(rng, args.queries, args.cols,
                                 join_fraction=0.5)
    # the late single write: one column touched, so the ship batch takes
    # the single-column path (sort unit + dictionary merge on their own)
    late = schema.UpdateStream(
        thread_id=np.zeros(1, np.int32),
        commit_id=np.full(1, args.txns, np.int64), op=np.ones(1, np.int8),
        row=rng.integers(0, args.rows, size=1).astype(np.int64),
        col=np.zeros(1, np.int32),
        value=rng.integers(0, 1 << 24, size=1).astype(np.int32))
    late_query = engine.Query(args.queries, 0, 0, 1 << 24, 1, 0)
    return dict(table=table, stream=stream, late=late, queries=queries,
                late_query=late_query,
                setup_seconds=time.perf_counter() - t0)


def drive_spec(spec, wl, args, check_host: bool, devices=None, device=None):
    return drive(spec, wl["table"], wl["stream"], wl["late"], wl["queries"],
                 wl["late_query"], args.rounds, check_host, devices, device)


def same_columns(got: dict, want: dict, what: str) -> None:
    for c, col in got.items():
        ref = want[c]
        if not (torch.equal(col.codes, ref.codes)
                and torch.equal(col.valid, ref.valid)
                and torch.equal(col.dictionary, ref.dictionary)
                and col.version == ref.version):
            raise AssertionError(f"final column {c} differs: {what}")


class MergeCalls:
    """Counts the calls of the merge unit's wrappers (K5) where
    `core.backend` and `core.application` import them, each call that
    merges entries of two or more runs: `merge_sorted_runs` (ship batches'
    logs, dictionary merges, the delta plane's overlay merges) and
    `merge_sorted_pairs` (a batch of dictionary merges). The unit launches
    once for each."""

    SITES = (("backend", "merge_sorted_runs"),
             ("backend", "merge_sorted_pairs"),
             ("application", "merge_sorted_runs"))

    def __enter__(self):
        from repro_torch.core import application, backend
        modules = dict(backend=backend, application=application)
        self.counts, self._saved = {}, []
        for m, name in self.SITES:
            module, fn = modules[m], getattr(modules[m], name)
            self.counts[f"{m}.{name}"] = 0
            self._saved.append((module, name, fn))
            setattr(module, name, self._counted(f"{m}.{name}", fn))
        return self

    def _counted(self, key, fn):
        # merge_sorted_runs(runs, ...) / merge_sorted_pairs(a_list, b_list)
        n_lists = 2 if key.endswith("pairs") else 1

        def inner(*args, **kwargs):
            lists = args[:n_lists]
            n_runs = sum(len(runs) for runs in lists)
            n = sum(len(r) for runs in lists for r in runs)
            self.counts[key] += n_runs >= 2 and n > 0
            return fn(*args, **kwargs)
        return inner

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    def check(self, launches: dict, what: str) -> dict:
        """K5's launches must be one a merge call."""
        want = sum(self.counts.values())
        if launches.get("merge_runs", 0) != want:
            raise AssertionError(
                f"{what}: {launches.get('merge_runs', 0)} merge-unit launches"
                f", expected one a merge call: {self.counts}")
        return dict(self.counts, merge_runs=want)


def phase_main_path(args, wl) -> tuple[dict, dict, list, dict, list,
                                       object]:
    """Returns the launches per kernel and, per kernel, the launches each
    shape got, both of the `hopper` session alone, and that session's
    answers, final columns, round seconds and RunResult."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launch_counts()
    with MergeCalls() as merges:
        answers, seconds, session, result = drive_spec(
            SystemSpec.polynesia(backend="hopper"), wl, args,
            check_host=True)
    launches = kernel_launch_counts()
    shapes = kernel_launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    merge_unit = merges.check(result.stats["kernel_launches"], "main_path")

    if len(answers) != args.queries + 1:
        raise AssertionError("wrong number of answers")
    cols = session.replica.columns
    for c, col in cols.items():
        for t in (col.codes, col.valid, col.dictionary):
            if t.device.type != "cuda":
                raise AssertionError(f"column {c} has a tensor on {t.device}")
    missing = [k for k in REPLACES if k not in PATH_OF
               and k not in NO_CALLER_SHAPE and launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} (counts {launches})")
    if result.stats["kernel_launches"] != launches:
        raise AssertionError("session launch stats disagree with the counters")

    ref_answers, ref_seconds, ref_session, _ = drive_spec(
        SystemSpec.polynesia(backend="torch"), wl, args, check_host=False)
    if kernel_launch_counts() != launches:
        raise AssertionError("the plain backend launched a CUDA kernel")
    if answers != ref_answers:
        raise AssertionError(f"hopper answers {answers} != torch answers "
                             f"{ref_answers}")
    same_columns(cols, ref_session.replica.columns, "hopper vs torch")
    del ref_session

    total = sum(seconds)
    emit("main_path", rows=args.rows, cols=args.cols, txns=args.txns + 1,
         queries=len(answers), rounds=args.rounds, seed=args.seed,
         setup_seconds=wl["setup_seconds"], round_seconds=seconds,
         txns_per_s=(args.txns + 1) / total, queries_per_s=len(answers) / total,
         torch_backend_round_seconds=ref_seconds,
         ship_batches=session._ship_i, merge_unit=merge_unit,
         applications=session.applications,
         snapshots=session.cons.snapshots_created, launches=launches,
         distinct_launch_shapes={k: len(v) for k, v in shapes.items()},
         max_dictionary=max(c.dict_size for c in cols.values()),
         peak_device_bytes=peak, modeled_txn_seconds=result.txn_seconds,
         modeled_ana_seconds=result.ana_seconds,
         answers_checksum=sum(answers), ok=True)
    return launches, shapes, answers, cols, seconds, result


SCANS = ("scan_exact", "scan_exact_join")
SHARDED_SCANS = ("scan_exact_sharded", "scan_exact_join_sharded")


def phase_islands(args, wl, one_launches, one_answers, one_cols
                  ) -> tuple[dict, dict]:
    """The main path on each island count of `args.islands`, stacked on the
    card; returns the launches and launch shapes of all its runs."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    one_scans = sum(one_launches.get(k, 0) for k in SCANS)
    reset_kernel_launch_counts()
    for n in args.islands:
        before = kernel_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # the one-island session's final columns stay allocated for the
        # comparison; the run's own peak is the peak above them
        held = torch.cuda.memory_allocated()
        answers, seconds, session, result = drive_spec(
            SystemSpec.polynesia(backend="hopper", n_shards=n), wl, args,
            check_host=True)
        after = kernel_launch_counts()
        launches = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
        peak = torch.cuda.max_memory_allocated()

        if answers != one_answers:
            raise AssertionError(f"hopper@{n} answers {answers} != "
                                 f"one-island answers {one_answers}")
        same_columns(session.replica.columns, one_cols,
                     f"hopper@{n} vs one island")
        missing = [k for k in SHARDED_SCANS if launches.get(k, 0) < 1]
        if missing or any(launches.get(k, 0) for k in SCANS):
            raise AssertionError(f"the islands' scans did not run sharded: "
                                 f"{launches}")
        n_scans = sum(launches.get(k, 0) for k in SHARDED_SCANS)
        if n_scans != one_scans:
            raise AssertionError(f"{n_scans} sharded scan launches on {n} "
                                 f"islands, {one_scans} on one: one launch "
                                 "per query group is the contract")
        stats = result.stats
        if (stats["islands"] != n or stats["sharded_views"] < 1
                or session.hw.n_ana_islands != n):
            raise AssertionError(f"the session did not run on islands: "
                                 f"{stats}")
        n_rows = next(iter(session.replica.columns.values())).n_rows
        total = sum(seconds)
        emit("islands", islands=n, rows=n_rows,
             padded_slots=-(-n_rows // n) * n - n_rows,
             round_seconds=seconds, txns_per_s=(args.txns + 1) / total,
             queries_per_s=len(answers) / total, peak_device_bytes=peak,
             held_device_bytes=held, launches=launches, scan_launches=n_scans,
             one_island_scan_launches=one_scans,
             sharded_views=stats["sharded_views"],
             views_shared=stats["views_shared"],
             modeled_ana_seconds=result.ana_seconds,
             answers_checksum=sum(answers), ok=True)
        del session
    return kernel_launch_counts(), kernel_launch_shapes()


# rows of the correction stack(s) of a delta kernel's launch, from the shape
# its wrapper recorded
STACK_ROWS = {"scan_exact_group": lambda s: s[-1],
              "scan_exact_group_sharded": lambda s: s[-1],
              "scan_exact_join_group": lambda s: s[-2] + s[-1],
              "scan_exact_join_group_sharded": lambda s: s[-2] + s[-1],
              "scan_values_delta": lambda s: s[0]}
# the delta kernels that must carry query groups with a non-empty stack:
# on one island, and on several
DELTA_ONE = ("scan_exact_group", "scan_exact_join_group")
DELTA_ISLANDS = ("scan_exact_group_sharded", "scan_exact_join_group_sharded")
# on several islands each scan launches as often as its flat form on one
SHARDED_FORM = {"scan_exact": "scan_exact_sharded",
                "scan_exact_join": "scan_exact_join_sharded",
                "scan_exact_group": "scan_exact_group_sharded",
                "scan_exact_join_group": "scan_exact_join_group_sharded"}


def folded_columns(session) -> dict:
    """Each final column decoded, with its live overlay folded in:
    {col: (values, valid)} on the card."""
    out = {}
    for c, col in session.replica.columns.items():
        vals = col.dictionary[col.codes.long()].clone()
        valid = col.valid.clone()
        d = session._deltas.get(c)
        if d is not None and d.n_overlay:
            rows, dvals, dvalid = d.on(col.device)
            vals[rows] = dvals.to(vals.dtype)
            valid[rows] = dvalid
        out[c] = (vals, valid)
    return out


def phase_delta(args, wl, one_answers, one_cols, one_seconds
                ) -> tuple[dict, dict]:
    """The main path on the delta-store plane, once per count of
    `args.delta_islands`; returns the launches and launch shapes of all its
    runs."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    want = {c: (col.dictionary[col.codes.long()], col.valid)
            for c, col in one_cols.items()}
    reset_kernel_launch_counts()
    one = None                  # the one-island delta run's launches
    for n in args.delta_islands:
        before, shapes_before = kernel_launch_counts(), kernel_launch_shapes()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with MergeCalls() as merges:
            answers, seconds, session, result = drive_spec(
                SystemSpec.polynesia(backend="hopper", n_shards=n,
                                     delta_store=True,
                                     delta_capacity=args.delta_capacity),
                wl, args, check_host=True)
        after, shapes_after = kernel_launch_counts(), kernel_launch_shapes()
        launches = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
        peak = torch.cuda.max_memory_allocated()
        merge_unit = merges.check(result.stats["kernel_launches"],
                                  f"delta on {n} island(s)")

        if answers != one_answers:
            raise AssertionError(f"delta plane on {n} island(s): answers "
                                 f"{answers} != eager answers {one_answers}")
        for c, (vals, valid) in folded_columns(session).items():
            if not (torch.equal(vals, want[c][0])
                    and torch.equal(valid, want[c][1])):
                raise AssertionError(f"delta plane on {n} island(s): final "
                                     f"column {c} with its overlay folded "
                                     "differs from the eager column")
        stack_rows = {}
        for k, rows_of in STACK_ROWS.items():
            run = {s: m - shapes_before.get(k, {}).get(s, 0)
                   for s, m in shapes_after.get(k, {}).items()}
            stack_rows[k] = sum(rows_of(s) * m for s, m in run.items())
        need = DELTA_ONE if n == 1 else DELTA_ISLANDS
        missing = [k for k in need if stack_rows[k] < 1]
        if missing:
            raise AssertionError(f"delta plane on {n} island(s): no query "
                                 f"group went through {missing} with a "
                                 f"non-empty stack (launches {launches})")
        if n == 1:
            one = launches
        elif one is not None:
            # the same groups fold alike: each sharded form as often as
            # its flat form on one island, and nothing else scans
            for flat, sharded in SHARDED_FORM.items():
                if launches.get(sharded, 0) != one.get(flat, 0) or \
                        launches.get(flat, 0):
                    raise AssertionError(
                        f"delta plane on {n} islands: {sharded} launched "
                        f"{launches.get(sharded, 0)} times, {flat} "
                        f"{one.get(flat, 0)} on one island ({launches})")
        stats = result.stats
        total = sum(seconds)
        emit("delta", islands=n, capacity=session.delta_capacity,
             round_seconds=seconds, eager_round_seconds=one_seconds,
             txns_per_s=(args.txns + 1) / total,
             queries_per_s=len(answers) / total,
             delta_appends=stats["delta_appends"],
             compactions=stats["compactions"],
             delta_live_entries=stats["delta_live_entries"],
             applications=stats["applications"],
             ship_batches=session._ship_i, merge_unit=merge_unit,
             peak_device_bytes=peak, held_device_bytes=held,
             launches=launches, stack_rows_scanned=stack_rows,
             modeled_txn_seconds=result.txn_seconds,
             modeled_ana_seconds=result.ana_seconds,
             answers_checksum=sum(answers), ok=True)
        del session
    return kernel_launch_counts(), kernel_launch_shapes()


# the mesh scans, one launch per device and group of up to 16 islands, and
# the flat scans whose launches one island makes for the same query groups
MESH_SCANS = {"scan_exact_mesh": "scan_exact",
              "scan_exact_join_mesh": "scan_exact_join"}


def mesh_stack_rows(name, shape) -> int:
    """The correction stacks' rows a mesh launch of `shape` carried."""
    return sum(mesh_shape(shape, name == "scan_exact_join_mesh")[5:])


def mesh_launches_a_group(devices) -> int:
    """The mesh scans' launches for one query group: one per device and
    group of up to MAX_ISLANDS of its islands (every island of these runs
    holds rows)."""
    from repro_torch.kernels.dict_ops import MAX_ISLANDS
    per_device = {}
    for d in devices:
        per_device[d] = per_device.get(d, 0) + 1
    return sum(-(-n // MAX_ISLANDS) for n in per_device.values())


def mesh_run(args, wl, spec, devices, one_launches, one_answers, one_cols,
             what: str) -> None:
    """One eager session on the mesh placement, checked against the
    one-island session."""
    from repro_torch.kernels.common import kernel_launch_counts
    before = kernel_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    answers, seconds, session, result = drive_spec(spec, wl, args,
                                                   check_host=True,
                                                   devices=devices)
    launches = {k: v - before.get(k, 0)
                for k, v in kernel_launch_counts().items()
                if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated()
    n = session.islands
    if answers != one_answers:
        raise AssertionError(f"{what}: answers {answers} != one-island "
                             f"answers {one_answers}")
    same_columns(session.replica.columns, one_cols, f"{what} vs one island")
    stats = result.stats
    if (stats["placement"] != "mesh" or stats["views_resident"] < 1
            or stats["sharded_views"] != 0 or stats["islands"] != n):
        raise AssertionError(f"{what}: not the mesh's resident views: "
                             f"{stats}")
    sharded = [k for k in launches if k.endswith("_sharded")]
    if sharded:
        raise AssertionError(f"{what}: stacked scans launched: {sharded}")
    per_group = mesh_launches_a_group(session.be.devices)
    for mesh, flat in MESH_SCANS.items():
        if launches.get(flat, 0):
            raise AssertionError(f"{what}: {launches[flat]} flat {flat} "
                                 "launches on the mesh path")
        if launches.get(mesh, 0) != per_group * one_launches.get(flat, 0):
            raise AssertionError(
                f"{what}: {launches.get(mesh, 0)} {mesh} launches, "
                f"{per_group} a group x the one-island "
                f"{one_launches.get(flat, 0)} expected")
    total = sum(seconds)
    emit("mesh", run=what, islands=n,
         devices=[str(d) for d in session.be.devices],
         round_seconds=seconds, txns_per_s=(args.txns + 1) / total,
         queries_per_s=len(answers) / total, peak_device_bytes=peak,
         held_device_bytes=held, launches=launches,
         scan_launches={k: launches.get(k, 0) for k in MESH_SCANS},
         launches_a_group=per_group,
         one_island_scan_launches={k: one_launches.get(k, 0) for k in SCANS},
         views_resident=stats["views_resident"],
         views_shared=stats["views_shared"],
         modeled_ana_seconds=result.ana_seconds,
         answers_checksum=sum(answers), ok=True)
    del session


def phase_mesh(args, wl, one_launches, one_answers, one_cols, dev=None
               ) -> tuple[dict, dict]:
    """The main path on the mesh placement: each island count of
    `args.mesh_islands` with the islands on the one card (`dev`, default
    cuda:0), the first on the delta store, and over distinct cards when
    there are two or more. Returns the phase's launches and launch
    shapes."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    card0 = torch.device("cuda", 0) if dev is None else dev
    reset_kernel_launch_counts()
    for n in args.mesh_islands:
        mesh_run(args, wl, SystemSpec.polynesia(backend=f"hopper@{n}/mesh"),
                 [card0] * n, one_launches, one_answers, one_cols,
                 f"hopper@{n}/mesh on one card")

    # the delta store on the first island count, islands on the one card
    n = args.mesh_islands[0]
    want = {c: (col.dictionary[col.codes.long()], col.valid)
            for c, col in one_cols.items()}
    before, shapes_before = kernel_launch_counts(), kernel_launch_shapes()
    answers, seconds, session, result = drive_spec(
        SystemSpec.polynesia(backend=f"hopper@{n}/mesh", delta_store=True,
                             delta_capacity=args.delta_capacity),
        wl, args, check_host=True, devices=[card0] * n)
    launches = {k: v - before.get(k, 0)
                for k, v in kernel_launch_counts().items()
                if v != before.get(k, 0)}
    shapes_after = kernel_launch_shapes()
    if answers != one_answers:
        raise AssertionError(f"delta plane on hopper@{n}/mesh: answers "
                             f"{answers} != eager answers {one_answers}")
    for c, (vals, valid) in folded_columns(session).items():
        if not (torch.equal(vals, want[c][0])
                and torch.equal(valid, want[c][1])):
            raise AssertionError(f"delta plane on hopper@{n}/mesh: final "
                                 f"column {c} with its overlay folded "
                                 "differs from the eager column")
    if result.stats["placement"] != "mesh" or any(
            k.endswith("_sharded") or k in SCANS for k in launches):
        raise AssertionError(f"delta plane on hopper@{n}/mesh did not stay "
                             f"on the mesh: {launches}")
    # only the island scans scan, one launch a device and group; the
    # correction rides them (their shapes record its stacks' rows)
    per_group = mesh_launches_a_group(session.be.devices)
    stack_rows = {}
    for mesh, flat in MESH_SCANS.items():
        if launches.get(mesh, 0) != per_group * one_launches.get(flat, 0):
            raise AssertionError(
                f"delta plane on hopper@{n}/mesh: {launches.get(mesh, 0)} "
                f"{mesh} launches, {per_group} a group x the one-island "
                f"{one_launches.get(flat, 0)} expected")
        stack_rows[mesh] = sum(
            mesh_stack_rows(mesh, sh) * (c - shapes_before.get(mesh, {})
                                         .get(sh, 0))
            for sh, c in shapes_after.get(mesh, {}).items())
    others = [k for k in launches if "scan" in k and k not in MESH_SCANS]
    if others or not all(stack_rows.values()):
        raise AssertionError(f"delta plane on hopper@{n}/mesh: the "
                             f"corrections did not ride the mesh scans: "
                             f"stack rows {stack_rows}, launches {launches}")
    total = sum(seconds)
    emit("mesh", run=f"hopper@{n}/mesh delta store on one card", islands=n,
         capacity=session.delta_capacity, round_seconds=seconds,
         txns_per_s=(args.txns + 1) / total,
         queries_per_s=len(answers) / total,
         delta_appends=result.stats["delta_appends"],
         compactions=result.stats["compactions"],
         values_delta_launches=launches.get("scan_values_delta", 0),
         stack_rows_scanned=stack_rows, launches_a_group=per_group,
         launches=launches, answers_checksum=sum(answers), ok=True)
    del session

    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(4, cards)
        mesh_run(args, wl, SystemSpec.polynesia(backend=f"hopper@{n}/mesh"),
                 None, one_launches, one_answers, one_cols,
                 f"hopper@{n}/mesh on {n} cards")
    else:
        emit("mesh_cards", skipped="1 card visible")
    return kernel_launch_counts(), kernel_launch_shapes()


# ---------------------------------------------------------------------------
# the elastic island lifecycle: resize, checkpoint and restore, crash replay
# ---------------------------------------------------------------------------

# the scans that must carry a round's query groups under each partition
FLAT, STACKED, MESH = "flat", "stacked", "mesh"


def round_scans(qs, family: str, devices=None) -> dict:
    """The scan launches a round's query batch makes on `family`'s
    partition: once a query group (the mesh scans once a device and group
    of up to 16 of its islands)."""
    from repro_torch.core import engine
    groups = engine.group_queries(qs)
    n_join = sum(g[0].join_col is not None for g in groups)
    flat = {"scan_exact": len(groups) - n_join, "scan_exact_join": n_join}
    if family == STACKED:
        want = {SHARDED_FORM[k]: v for k, v in flat.items()}
    elif family == MESH:
        per_group = mesh_launches_a_group(devices)
        want = {mesh: per_group * flat[f] for mesh, f in MESH_SCANS.items()}
    else:
        want = flat
    return {k: v for k, v in want.items() if v}


def launches_since(before: dict) -> dict:
    from repro_torch.kernels.common import kernel_launch_counts
    return {k: v - before.get(k, 0) for k, v in kernel_launch_counts().items()
            if v != before.get(k, 0)}


def scans_of(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if "scan" in k}


def workload_rounds(args, wl) -> list:
    """(txn chunk, queries, main-path answers) of each round, the late
    round last, as `drive` splits them."""
    from repro_torch.core.workload import split_queries, split_stream
    rounds = list(zip(split_stream(wl["stream"], args.rounds),
                      split_queries(wl["queries"], args.rounds)))
    rounds.append((wl["late"], [wl["late_query"]]))
    return rounds


def ckpt_bytes(ckpt_dir: str, step: int) -> int:
    d = os.path.join(ckpt_dir, f"step_{step}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_elastic(args, wl, one_answers, one_cols, dev=None
                  ) -> tuple[dict, dict]:
    """The main path through the elastic lifecycle (`core/elastic.py`).

    (a) resize: `hopper`, resized after round 0 to 4 stacked islands, after
    round 1 to 4 mesh islands on the one card, after round 2 back to one
    island; every round's answers equal the main path's and the host
    evaluation, the final columns the main path's, and the round's scans
    are the partition's (flat, sharded, mesh; once a query group), the mesh
    adopting the shards the resize placed. (b) checkpoint and restore:
    `hopper@4` on the delta store, checkpointed after round 2 with live
    overlays; restored onto the same spec it finishes with the
    uninterrupted run's answers and modeled numbers, onto `hopper@2/mesh`
    (delta store) with its answers, and onto an eager `hopper` it is
    refused. (c) crash: `run_with_recovery` on `hopper`, the crash in round
    2 after the step-2 checkpoint, recovered onto `hopper@4/mesh`: the main
    path's answers. Returns the phase's launches and shapes (counts set to
    0 at its start)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.core import elastic
    from repro_torch.core.hwmodel import HardwareModel
    from repro_torch.core.session import HTAPSession, SystemSpec
    from repro_torch.core.timeline import simulate_timeline
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    start = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    rounds = workload_rounds(args, wl)
    offsets = np.cumsum([0] + [len(qs) for _, qs in rounds]).tolist()
    main_answers = [one_answers[offsets[r]:offsets[r + 1]]
                    for r in range(len(rounds))]
    reset_kernel_launch_counts()

    # (a) resize: 1 -> 4 stacked -> 4 on the mesh -> 1, one round each
    plan = {0: (4, STACKED, None), 1: (4, MESH, [dev] * 4),
            2: (1, STACKED, None)}
    session = HTAPSession(SystemSpec.polynesia(backend="hopper"),
                          wl["table"], device=dev)
    family, devices = FLAT, None
    resizes, ships, views = [], [], 0
    for r, (chunk, qs) in enumerate(rounds):
        if r:
            session.advance_round()
        before, resident = kernel_launch_counts(), session.cons.views_resident
        session.execute(chunk)
        got = session.query_batch(qs)
        sync(dev)
        ships.append(session._ship_i)
        launches = launches_since(before)
        host = host_answers(session.store.data, qs)
        if got != main_answers[r] or got != host:
            raise AssertionError(f"elastic resize, round {r} on {family}: "
                                 f"answers {got} != main path "
                                 f"{main_answers[r]} / host evaluation "
                                 f"{host}")
        want = round_scans(qs, family, devices)
        if scans_of(launches) != want:
            raise AssertionError(f"elastic resize, round {r} on {family}: "
                                 f"scans {scans_of(launches)}, the "
                                 f"partition's are {want}")
        if family == MESH:
            views += session.cons.views_resident - resident
            if session.cons.views_resident == resident:
                raise AssertionError("elastic resize: the mesh round adopted "
                                     "no shard the resize placed")
        if r in plan:
            n, placement, devices = plan[r]
            before = kernel_launch_counts()
            t0 = time.perf_counter()
            node = session.resize_islands(n, placement=placement,
                                          devices=devices)
            sync(dev)
            seconds = time.perf_counter() - t0
            if scans_of(launches_since(before)):
                raise AssertionError(f"elastic resize {node} scanned")
            family = MESH if placement == MESH else (
                STACKED if n > 1 else FLAT)
            resizes.append(dict(node=node, to=n, placement=placement,
                                wall_seconds=seconds))
    tl = simulate_timeline(session.cost, HardwareModel(session.hw))
    modeled = {n.tag.node: n.seconds for n in tl.nodes
               if n.tag.kind == "reshard"}
    for rs in resizes:
        rs["modeled_seconds"] = modeled[rs["node"]]
    same_columns(session.replica.columns, one_cols,
                 "elastic resize vs one island")
    result = session.finish()
    trail = [(t["from"], t["to"], t["placement"])
             for t in result.stats["resizes"]]
    if trail != [(1, 4, STACKED), (4, 4, MESH), (4, 1, STACKED)]:
        raise AssertionError(f"elastic resize trail {trail}")
    emit("elastic", part="resize", resizes=resizes, mesh_views_resident=views,
         ship_batches=ships, answers_checksum=sum(result.results), ok=True)
    del session

    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        # (b) checkpoint with live overlays, restore three ways
        spec = SystemSpec.polynesia(backend="hopper@4", delta_store=True,
                                    delta_capacity=args.delta_capacity)
        cut = 2
        t0 = time.perf_counter()
        session = HTAPSession(spec, wl["table"], device=dev)
        sync(dev)
        build_seconds = time.perf_counter() - t0
        for r, (chunk, qs) in enumerate(rounds[:cut + 1]):
            if r:
                session.advance_round()
            session.execute(chunk)
            session.query_batch(qs)
        live = sum(d.n_overlay for d in session._deltas.values())
        if not live:
            raise AssertionError("elastic checkpoint: no live overlay")
        t0 = time.perf_counter()
        step = session.checkpoint(os.path.join(tmp, "b"), step=cut + 1)
        write_seconds = time.perf_counter() - t0
        size = ckpt_bytes(os.path.join(tmp, "b"), step)

        def finish(s):
            for chunk, qs in rounds[cut + 1:]:
                s.advance_round()
                s.execute(chunk)
                s.query_batch(qs)
            return s.finish()

        whole = finish(session)
        del session
        restores = {}
        for what, target, devices in (
                ("same", None, None),
                ("hopper@2/mesh", SystemSpec.polynesia(
                    backend="hopper@2/mesh", delta_store=True,
                    delta_capacity=args.delta_capacity), [dev] * 2)):
            t0 = time.perf_counter()
            restored = HTAPSession.restore(
                os.path.join(tmp, "b"), spec=target,
                device=None if devices else dev, devices=devices)
            sync(dev)
            restores[what] = time.perf_counter() - t0
            res = finish(restored)
            if res.results != one_answers:
                raise AssertionError(f"elastic restore onto {what}: answers "
                                     f"{res.results} != main path "
                                     f"{one_answers}")
            if what == "same" and (
                    res.results, res.txn_seconds, res.ana_seconds,
                    res.energy_joules) != (
                    whole.results, whole.txn_seconds, whole.ana_seconds,
                    whole.energy_joules):
                raise AssertionError("elastic restore onto the same spec: "
                                     "modeled numbers differ from the "
                                     "uninterrupted run's")
            del restored
        t0 = time.perf_counter()
        try:
            HTAPSession.restore(os.path.join(tmp, "b"),
                                spec=SystemSpec.polynesia(backend="hopper"),
                                device=dev)
        except ValueError as err:
            restores["eager hopper, refused"] = time.perf_counter() - t0
            if "delta-overlay" not in str(err):
                raise
        else:
            raise AssertionError("elastic restore: a checkpoint with live "
                                 "overlays restored onto an eager target")
        emit("elastic", part="checkpoint", spec=spec.backend, step=step,
             live_overlay_rows=live, checkpoint_bytes=size,
             write_seconds=write_seconds, restore_seconds=restores,
             session_build_seconds=build_seconds,
             modeled_txn_seconds=whole.txn_seconds,
             modeled_ana_seconds=whole.ana_seconds,
             answers_checksum=sum(whole.results), ok=True)

        # (c) crash in round 2, after the step-2 checkpoint
        limit = ships[1] + (ships[2] - ships[1]) // 2
        if not ships[1] <= limit < ships[2]:
            raise AssertionError(f"elastic crash: no ship batch in round 2 "
                                 f"to crash at ({ships})")
        ckpt = os.path.join(tmp, "c")
        t0 = time.perf_counter()
        res, recovered = elastic.run_with_recovery(
            SystemSpec.polynesia(backend="hopper"), wl["table"],
            wl["stream"], wl["queries"], args.rounds, ckpt,
            crash_after_ships=limit, device=dev,
            restore_spec=SystemSpec.polynesia(backend="hopper@4/mesh"),
            restore_devices=[dev] * 4)
        sync(dev)
        seconds = time.perf_counter() - t0
        if not recovered or latest_step(ckpt) != 2:
            raise AssertionError(f"elastic crash: recovered {recovered}, "
                                 f"last step {latest_step(ckpt)}")
        if res.results != one_answers[:args.queries]:
            raise AssertionError(f"elastic crash: answers {res.results} != "
                                 f"main path {one_answers[:args.queries]}")
        if res.stats["placement"] != MESH or res.stats["islands"] != 4:
            raise AssertionError(f"elastic crash: recovered onto "
                                 f"{res.stats['placement']}")
        emit("elastic", part="crash", crash_after_ships=limit,
             recovered=recovered, restored_step=latest_step(ckpt),
             seconds=seconds, answers_checksum=sum(res.results), ok=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = kernel_launch_counts()
    emit("elastic", launches=launches,
         phase_seconds=time.perf_counter() - start, ok=True)
    return launches, kernel_launch_shapes()


def phase_ana_only(args, wl) -> tuple[dict, dict]:
    """`Ana-Only` (lone queries over the initial table) on one island and on
    the first island count; returns the launches and shapes of both runs
    together."""
    from repro_torch.core import htap
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.kernels.hash_probe import tables_built
    want = host_answers(wl["table"], wl["queries"])
    joined = {q.join_col for q in wl["queries"] if q.join_col is not None}
    reset_kernel_launch_counts()
    seconds, probes, tables = {}, {}, {}
    for spec in ("hopper", f"hopper@{args.islands[0]}"):
        before = kernel_launch_counts().get("hash_probe", 0)
        built = tables_built()
        t0 = time.perf_counter()
        res = htap.run("Ana-Only", wl["table"], queries=wl["queries"],
                       backend=spec)
        torch.cuda.synchronize()
        seconds[spec] = time.perf_counter() - t0
        if res.results != want:
            raise AssertionError(f"Ana-Only on {spec}: {res.results} != host "
                                 f"{want}")
        probes[spec] = kernel_launch_counts().get("hash_probe", 0) - before
        n_joins = sum(q.join_col is not None for q in wl["queries"])
        if probes[spec] != n_joins:
            raise AssertionError(f"Ana-Only on {spec}: {probes[spec]} probe "
                                 f"launches for {n_joins} lone join queries")
        tables[spec] = tables_built() - built
        if tables[spec] > len(joined):
            raise AssertionError(f"Ana-Only on {spec}: {tables[spec]} bucket "
                                 f"tables built for {len(joined)} joined "
                                 "dictionaries")
    launches = kernel_launch_counts()
    emit("ana_only", queries=len(want), seconds=seconds, probe_launches=probes,
         tables_built=tables, joined_columns=len(joined), launches=launches,
         answers_checksum=sum(want), ok=True)
    return launches, kernel_launch_shapes()


# ---------------------------------------------------------------------------
# phase 7: the float32 scan over the main path's columns
# ---------------------------------------------------------------------------

FLOAT_SCAN_PLAIN_RTOL = 1e-5   # of sum(|v|): the CPU tests' tolerance
FLOAT_SCAN_TOL = ("count exact; sum within float_scan_error_bound of the "
                  "exact sum and 1e-5 * sum(|v|) of the plain version's")


def float_scan_check(name, got, plain, exact, abs_sum, n, dev) -> float:
    """The kernel's (sum, count) `got` against the exact scan's `exact`:
    count equal, sum within `float_scan_error_bound` (the worst case of the
    kernel's own summation order, about 2e-6 * sum(|v|) at 10M rows); and
    against the plain version's `plain`: count equal, sums within
    FLOAT_SCAN_PLAIN_RTOL * sum(|v|). Returns the error against the exact
    sum relative to sum(|v|)."""
    from repro_torch.kernels.dict_ops.ops import (float_scan_error_bound,
                                                  float_scan_parts)
    (s, c), (ps, pc), (es, ec) = got, plain, exact
    err = abs(float(s) - es)
    bound = float_scan_error_bound(n, float_scan_parts(dev, n), abs_sum)
    if int(c) != ec or err > bound:
        raise AssertionError(
            f"{name}: float32 scan ({float(s)}, {int(c)}) against exact "
            f"({es}, {ec}): error {err} over its bound {bound} (sum(|v|) "
            f"{abs_sum}, n {n})")
    if int(pc) != ec or abs(float(s) - float(ps)) > \
            FLOAT_SCAN_PLAIN_RTOL * abs_sum:
        raise AssertionError(
            f"{name}: float32 scan ({float(s)}, {int(c)}) against its plain "
            f"version ({float(ps)}, {int(pc)}), tolerance "
            f"{FLOAT_SCAN_PLAIN_RTOL} * sum(|v|) {abs_sum}")
    return err / abs_sum if abs_sum else 0.0


def abs_sum(fcodes, acodes, valid, adict, lo, hi) -> int:
    """sum(|dict[acodes]|) over the rows a predicate selects (int64)."""
    mask = (fcodes >= lo) & (fcodes < hi) & valid
    return int(torch.where(mask, adict[acodes.long()].long().abs(), 0).sum())


def phase_float_scan(args, wl, cols) -> tuple[dict, dict]:
    """Every query's filter and aggregate columns through the float32 scan
    over the main path's final columns (one launch a query), then the same
    predicates through the exact scan to hold it against."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.kernels.dict_ops import (scan_filter_agg,
                                              scan_filter_agg_float_ref)
    be = get_backend("hopper")
    queries = list(wl["queries"]) + [wl["late_query"]]
    preds = []
    for q in queries:
        fcol, acol = cols[q.filter_col], cols[q.agg_col]
        preds.append((fcol, acol) + be.code_range(fcol, q.lo, q.hi))
    reset_kernel_launch_counts()
    t0 = time.perf_counter()
    got = [scan_filter_agg(f.codes, a.codes, f.valid, a.dictionary, lo, hi,
                           exact=False) for f, a, lo, hi in preds]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
    if launches != {"scan_float": len(queries)}:
        raise AssertionError(f"float scan launches {launches} for "
                             f"{len(queries)} queries")
    rel = []
    for (f, a, lo, hi), s_c in zip(preds, got):
        cols_pred = (f.codes, a.codes, f.valid, a.dictionary, lo, hi)
        rel.append(float_scan_check(
            "float_scan", s_c, scan_filter_agg_float_ref(*cols_pred),
            scan_filter_agg(*cols_pred), abs_sum(*cols_pred), f.n_rows,
            f.codes.device))
    emit("float_scan", queries=len(queries), seconds=seconds,
         launches=launches, max_rel_err=max(rel), tolerance=FLOAT_SCAN_TOL,
         ok=True)
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 8: mixed-traffic serving on the timeline
# ---------------------------------------------------------------------------

# Not a published traffic mix: 1.2e-4 queries a commit, so that nearly
# every arrival batch holds one query and runs the kernel path once. The
# reference's serve sweep (benchmarks/fig_serve.py: 3 clients, 1e6
# commits/s, 200 - 1,600 queries/s a client) sends 6e-4 - 4.8e-3, 5 - 40x
# more; the freshness and latency this phase prints hold for this schedule
# only.
MIXED_CLIENTS = 4           # the workload's queries dealt round-robin
MIXED_TXN_RATE = 100_000.0  # commits/s: a 4 s horizon at 400,000 commits
MIXED_QUERY_RATE = 3.0      # queries/s a client


def mixed_schedule(args, wl) -> list:
    """The seeded open arrival schedule of `mixed_traffic`."""
    from repro_torch.core.workload import mixed_traffic_schedule
    clients = [wl["queries"][c::MIXED_CLIENTS] for c in range(MIXED_CLIENTS)]
    return mixed_traffic_schedule(
        np.random.default_rng(args.seed + 1), clients, len(wl["stream"]),
        MIXED_TXN_RATE, [MIXED_QUERY_RATE] * MIXED_CLIENTS)


def drive_arrivals(spec, wl, arrivals, check_host: bool, device=None,
                   devices=None):
    """The arrival batches through `HTAPSession` as
    `htap.run_mixed_traffic` drives them, each batch timed (execute and
    query, to the card's last kernel) and, with `check_host`, its answers
    held to the host evaluation over the row store at its position.
    Returns (answers, wall seconds per batch, RunResult)."""
    from repro_torch.core.session import HTAPSession
    from repro_torch.core.workload import arrival_batches, slice_stream
    stream = wl["stream"]
    session = HTAPSession(spec, wl["table"], device=device, devices=devices)
    answers, seconds, cursor = [], [], 0
    for i, (pos, batch) in enumerate(arrival_batches(arrivals)):
        if i:
            session.advance_round()
        qs = [a.query for a in batch]
        t0 = time.perf_counter()
        session.execute(slice_stream(stream, cursor, pos))
        got = session.query_batch(qs)
        sync(session.device)
        seconds.append(time.perf_counter() - t0)
        cursor = pos
        if check_host and got != host_answers(session.store.data, qs):
            raise AssertionError(
                f"mixed traffic at position {pos}: answers {got} != host "
                f"evaluation {host_answers(session.store.data, qs)}")
        answers.extend(got)
    if cursor < len(stream):
        session.advance_round()
        session.execute(slice_stream(stream, cursor, len(stream)))
    return answers, seconds, session.finish()


def seconds_summary(seconds: list[float]) -> dict:
    return dict(sum=sum(seconds), mean=sum(seconds) / len(seconds),
                median=float(np.median(seconds)), max=max(seconds))


def timeline_numbers(res) -> dict:
    """The modeled numbers a timeline run reports (the paper's HMC
    parameters, not the card's)."""
    tl = res.stats["timeline"]
    return dict(freshness=res.freshness_seconds,
                latency_p50=res.stats["latency"]["p50"],
                latency_p99=res.stats["latency"]["p99"],
                makespan=tl["makespan"], utilization=tl["utilization"],
                txns_per_s=res.txn_throughput,
                queries_per_s=res.ana_throughput)


def phase_mixed_traffic(args, wl, dev=None) -> dict:
    """The workload's queries from four clients arriving inside the commit
    stream, served through `htap.run_mixed_traffic` on the timeline:
    `hopper` synchronous, `hopper` with async propagation, and
    `hopper@4/mesh` on the delta store with async propagation (islands on
    the one card). Each run is driven first batch by batch (timed; the
    first run's answers held to the host evaluation at each arrival's
    position), then served; the served answers and modeled numbers must
    equal the batch-by-batch run's, the answers the host evaluation; the
    served scans launch once a query group (the flat scans on `hopper`,
    the mesh scans on the mesh) and the values delta and the sort unit
    never. Returns each served run's launches and shapes (counts set to 0
    just before it, read just after) under its path's name."""
    from repro_torch.core import engine, htap
    from repro_torch.core.session import SystemSpec
    from repro_torch.core.workload import arrival_batches
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    start = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    arrivals = mixed_schedule(args, wl)
    batches = arrival_batches(arrivals)
    groups = [g for _, b in batches
              for g in engine.group_queries([a.query for a in b])]
    n_join = sum(g[0].join_col is not None for g in groups)
    want_scans = {"scan_exact": len(groups) - n_join,
                  "scan_exact_join": n_join}
    emit("mixed_traffic", schedule=True, clients=MIXED_CLIENTS,
         txn_rate=MIXED_TXN_RATE, query_rate=MIXED_QUERY_RATE,
         offered=len(wl["queries"]), arrivals=len(arrivals),
         positions=len(batches), query_groups=len(groups), join_groups=n_join)

    sync_spec = SystemSpec.polynesia(backend="hopper", timing="timeline")
    runs = [("hopper", "mixed_traffic", sync_spec, None),
            ("hopper async", "mixed_traffic_async",
             sync_spec.replace(async_propagation=True), None),
            ("hopper@4/mesh delta async", "mixed_traffic_mesh",
             SystemSpec.polynesia(backend="hopper@4/mesh", timing="timeline",
                                  async_propagation=True, delta_store=True,
                                  delta_capacity=args.delta_capacity),
             [dev] * 4)]
    want, paths = None, {}
    for what, path, spec, devices in runs:
        # by hand, batch by batch and timed (the first run held to the host
        # evaluation at every position), then through the public entry
        # point, which must give the same answers and modeled numbers
        answers, batch_seconds, by_hand = drive_arrivals(
            spec, wl, arrivals, check_host=want is None, device=dev,
            devices=devices)
        want = answers if want is None else want
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = htap.run_mixed_traffic(spec, wl["table"], wl["stream"],
                                     arrivals, device=dev, devices=devices)
        sync(dev)
        seconds = time.perf_counter() - t0
        launches = kernel_launch_counts()
        paths[path] = (launches, kernel_launch_shapes())
        for got, how in ((answers, "by hand"), (res.results, "served")):
            if got != want:
                raise AssertionError(f"mixed traffic, {what} {how}: answers "
                                     f"{got} != host evaluation {want}")
        if timeline_numbers(res) != timeline_numbers(by_hand):
            raise AssertionError(f"mixed traffic, {what}: run_mixed_traffic "
                                 "priced differently from its batches")
        scans = want_scans
        if devices is not None:
            per_group = mesh_launches_a_group(devices)
            scans = {mesh: per_group * want_scans[flat]
                     for mesh, flat in MESH_SCANS.items()}
        got_scans = {k: v for k, v in launches.items() if "scan" in k}
        if got_scans != {k: v for k, v in scans.items() if v}:
            raise AssertionError(f"mixed traffic, {what}: scan launches "
                                 f"{got_scans}, expected once a query group "
                                 f"{scans}")
        folded = {k: launches[k] for k in NEVER_ON_PATH if launches.get(k)}
        if folded:
            raise AssertionError(f"mixed traffic, {what}: {folded} launched")
        emit("mixed_traffic", run=what, batches=len(batches),
             batch_seconds=seconds_summary(batch_seconds),
             served_wall_seconds=seconds, modeled=timeline_numbers(res),
             launches=launches, answers_checksum=sum(res.results),
             phase_seconds=time.perf_counter() - start, ok=True)
    return paths


# ---------------------------------------------------------------------------
# phase 9: the single-instance baselines
# ---------------------------------------------------------------------------

def device_bytes(dev) -> int:
    dev = torch.device(dev)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def round_start_answers(wl, args) -> list[int]:
    """Host answers over the table as it stood at the start of each round
    of `drive` (SI-MVCC's consistency point)."""
    from repro_torch.core.nsm import RowStore
    from repro_torch.core.workload import split_queries, split_stream
    store = RowStore(wl["table"])
    rounds = list(zip(split_stream(wl["stream"], args.rounds),
                      split_queries(wl["queries"], args.rounds)))
    rounds.append((wl["late"], [wl["late_query"]]))
    out = []
    for chunk, qs in rounds:
        out.extend(host_answers(store.data, qs))
        store.execute(chunk)
    return out


def phase_si_baselines(args, wl, poly_answers, poly_result,
                       dev=None) -> tuple[dict, dict]:
    """SI-SS and SI-MVCC (`SystemSpec.si_ss()` / `si_mvcc()`) through
    `drive_spec` over the main path's workload: one host row store each,
    answered in numpy. SI-SS's answers must equal the host
    evaluation every round and Polynesia's (the round-end consistency
    point), SI-MVCC's the host evaluation over the table at each round's
    start; neither may launch a kernel or hold device memory. Polynesia's
    modeled throughputs over each baseline's are the paper's Fig. 6
    ratios, on its HMC parameters."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    start = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    mvcc_want = round_start_answers(wl, args)
    reset_kernel_launch_counts()
    for spec in (SystemSpec.si_ss(), SystemSpec.si_mvcc()):
        held = device_bytes(dev)
        answers, seconds, session, res = drive_spec(
            spec, wl, args, check_host=spec.kind == "si_ss", device=dev)
        if spec.kind == "si_ss" and answers != poly_answers:
            raise AssertionError(f"SI-SS answers {answers} != Polynesia's "
                                 f"{poly_answers}")
        if spec.kind == "si_mvcc" and answers != mvcc_want:
            raise AssertionError(f"SI-MVCC answers {answers} != the host "
                                 f"evaluation at round start {mvcc_want}")
        if kernel_launch_counts() or res.stats["kernel_launches"]:
            raise AssertionError(f"{spec.name} launched kernels: "
                                 f"{kernel_launch_counts()}")
        if hasattr(session, "replica") or device_bytes(dev) > held:
            raise AssertionError(f"{spec.name} built a replica on the "
                                 "device")
        total = sum(seconds)
        emit("si_baselines", system=spec.name, rows=args.rows,
             stats={k: v for k, v in res.stats.items()
                    if k != "kernel_launches"},
             round_seconds=seconds, txns_per_s=res.n_txn / total,
             queries_per_s=res.n_ana / total,
             modeled_txns_per_s=res.txn_throughput,
             modeled_queries_per_s=res.ana_throughput,
             polynesia_over_this=dict(
                 txn=poly_result.txn_throughput / res.txn_throughput,
                 ana=poly_result.ana_throughput / res.ana_throughput),
             modeled_on="the paper's HMC parameters (hwmodel.HMC_PARAMS)",
             launches={}, answers_checksum=sum(answers),
             phase_seconds=time.perf_counter() - start, ok=True)
        del session
    return kernel_launch_counts(), kernel_launch_shapes()


# ---------------------------------------------------------------------------
# phase 12: the LM serving path
# ---------------------------------------------------------------------------

def new_cache(cfg, batch: int, max_len: int, dev, cross_kv=None):
    """A decode cache in the activations' type: the LM's per-layer caches,
    or an encoder-decoder's self caches with `cross_kv` (its
    `precompute_cross_kv`, fixed for the requests) beside them."""
    from repro_torch.models.encdec import init_encdec_cache
    from repro_torch.models.lm import init_lm_cache
    if not cfg.is_encoder_decoder:
        return init_lm_cache(cfg, batch, max_len, dtype=cfg.adtype,
                             device=dev)
    cache = init_encdec_cache(cfg, batch, max_len, dtype=cfg.adtype,
                              device=dev)
    cache["cross_kv"] = cross_kv
    return cache


def serve(model, cfg, prompts, n_gen: int, max_len: int, cross_kv=None):
    """Greedy serving as `examples/serve_lm.py`: the prompt fed one token
    at a time through `make_serve_step`, then the generated tokens fed
    back. Returns (generated (B, n_gen), prompt seconds, generation
    seconds, cache)."""
    from repro_torch.launch.steps import make_serve_step
    dev = prompts.device
    batch, n_prompt = prompts.shape
    cache = new_cache(cfg, batch, max_len, dev, cross_kv)
    step = make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_prompt):
        tok, cache = step(model, cache, prompts[:, i:i + 1], i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for i in range(n_prompt, n_prompt + n_gen - 1):
        tok, cache = step(model, cache, tok, i)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gen = torch.cat(out, dim=1)
    if gen.shape != (batch, n_gen) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad generated tokens {gen.shape}")
    return gen, t1 - t0, t2 - t1, cache


def replay(model, cfg, prompts, gen, max_len: int, cross_kv=None) -> int:
    """After the timed run, untimed: the same tokens through
    `lm_decode_step` (`encdec_decode_step`) on a new cache. Every step's
    logits must be finite and their argmax the token `make_serve_step`
    gave there. Returns the steps checked."""
    from repro_torch.models.encdec import encdec_decode_step
    from repro_torch.models.lm import lm_decode_step
    decode = encdec_decode_step if cfg.is_encoder_decoder else lm_decode_step
    batch, n_prompt = prompts.shape
    feed = torch.cat([prompts, gen[:, :-1]], dim=1)
    cache = new_cache(cfg, batch, max_len, prompts.device, cross_kv)
    finite = torch.ones((), dtype=torch.bool, device=prompts.device)
    greedy = []
    for i in range(feed.shape[1]):
        logits, cache = decode(model, cache, feed[:, i:i + 1], i, cfg)
        finite &= torch.isfinite(logits).all()
        if i >= n_prompt - 1:
            greedy.append(torch.argmax(logits[:, -1], dim=-1))
    del cache
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: a decode step gave a logit that "
                             "is not finite")
    greedy = torch.stack(greedy, dim=1).to(gen.dtype)
    if not torch.equal(greedy, gen):
        raise AssertionError(
            f"{cfg.name}: the argmax of lm_decode_step's logits differs from "
            f"make_serve_step's tokens at {int((greedy != gen).sum())} of "
            f"{gen.numel()} places")
    return feed.shape[1]


BACKWARD_SCOPE = 1    # torch's RecordScope.BACKWARD_FUNCTION


class _Spans:
    """Time spans by thread, merged; `holds(thread, t)` says whether one
    of them covers time t on that thread."""

    def __init__(self, spans):
        by_thread = {}
        for tid, t0, t1 in sorted(spans):
            merged = by_thread.setdefault(tid, ([], []))
            if merged[0] and t0 <= merged[1][-1]:
                merged[1][-1] = max(merged[1][-1], t1)
            else:
                merged[0].append(t0)
                merged[1].append(t1)
        self.by_thread = by_thread

    def holds(self, tid, t) -> bool:
        starts, ends = self.by_thread.get(tid, ((), ()))
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= ends[k]


def own_ops(events, name: str) -> list:
    """The profile's host events (its raw `_KinetoEvent`s, in launch
    order) that belong to the `record_function` ranges called `name`:
    every op inside such a range (its forward calls, and the remat's
    recompute, which runs the range again inside the backward), and every
    op inside an autograd node that differentiates an op of a forward
    range (linked to it by sequence number and forward thread). An op
    lies inside a span when it starts within it on the same thread."""
    host = [e for e in events if str(e.device_type()).endswith("CPU")]

    def span(e):
        return (e.start_thread_id(), e.start_ns(), e.end_ns())
    backward = _Spans(span(e) for e in host if e.scope() == BACKWARD_SCOPE)
    ranges = [span(e) for e in host if e.name() == name]
    forward = _Spans(r for r in ranges if not backward.holds(r[0], r[1]))
    seqs = {(e.start_thread_id(), e.sequence_nr()) for e in host
            if e.sequence_nr() >= 0
            and forward.holds(e.start_thread_id(), e.start_ns())}
    own = _Spans(ranges + [span(e) for e in host
                           if e.scope() == BACKWARD_SCOPE
                           and (e.fwd_thread_id(), e.sequence_nr()) in seqs])
    return [e for e in host if own.holds(e.start_thread_id(), e.start_ns())]


def profile_device(run, n: int, ranges=()) -> dict:
    """`run()`, which takes `n` steps, under `torch.profiler`: device time
    per step (the device events' own times, summed) against the wall time,
    which the profiler inflates; "not measured" when it records no device
    time. For each `record_function` range named in `ranges`, the device
    time of the kernels its own ops launched (`own_ops`) a step and its
    share of the device time. Read from the profiler's raw events: its
    event tree would take minutes to build for a step of 100,000
    launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if _on_device(e)]
    device_us = sum(e.duration_ns() for e in device) / 1e3
    if not device_us:
        return {"device_time": "not measured (no device events)"}
    by_name = {}
    for e in device:
        acc = by_name.setdefault(e.name(), [0, 0])
        acc[0] += e.duration_ns() / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda k: -k[1][0])[:8]
    out = dict(steps=n, wall_ms_per_step=wall / n * 1e3,
               device_ms_per_step=device_us / 1e3 / n,
               device_busy_share=device_us / 1e6 / wall,
               kernel_launches_per_step=len(device) / n,
               top_kernels=[dict(name=k[:60], ms_per_step=us / 1e3 / n,
                                 calls_per_step=c / n)
                            for k, (us, c) in top])
    if ranges:
        out["ranges"] = {}
        for name in ranges:
            launched = {e.correlation_id() for e in own_ops(events, name)}
            own = [e for e in device if e.linked_correlation_id() in launched]
            us = sum(e.duration_ns() for e in own) / 1e3
            out["ranges"][name] = dict(
                device_ms_per_step=us / 1e3 / n,
                kernels_per_step=len(own) / n,
                share_of_device_time=us / device_us)
    return out


def profile_steps(model, cfg, cache, tok, start: int, n: int) -> dict:
    """`n` more serve steps from position `start`, profiled."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(cfg)

    def run():
        t, c = tok, cache
        for i in range(start, start + n):
            t, c = step(model, c, t, i)
    return profile_device(run, n)


FREE_BYTES = 8 * 2**30    # device memory a model's weights must leave free


def card_bytes(dev) -> int | None:
    """The card's memory; None on the CPU (a rehearsal), where no model
    is refused for its size."""
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def cross_check(cfg, args, dev) -> dict:
    """Full width, float32 weights, reduced depth (one period, else up to
    two layers): the prefill's logits against token-by-token decode logits
    at every prompt position. A MoE model's capacity routing depends on
    the batch (the reference's `test_decode_matches_parallel_apply` leaves
    MoE out for it), so its capacity factor is raised to E here, which
    makes C = Sg: no token drops, and prefill and decode route each token
    alike. Skipped, saying why, where the float32 weights would not leave
    FREE_BYTES of the card free."""
    import dataclasses
    from repro_torch.models.lm import (init_lm, init_lm_cache, lm_apply,
                                       lm_decode_step)
    depth = cfg.period if cfg.period > 1 else min(2, cfg.n_layers)
    small = dataclasses.replace(cfg, n_layers=depth, param_dtype="float32",
                                activ_dtype="float32")
    if cfg.n_experts:
        small = dataclasses.replace(small,
                                    capacity_factor=float(cfg.n_experts))
    need, card = small.param_count() * 4, card_bytes(dev)
    if card is not None and need > card - FREE_BYTES:
        return dict(skipped=f"float32 weights of {depth} layer(s) at full "
                            f"width are {need / 1e9:.1f} GB, over the "
                            f"card's {card / 1e9:.1f} GB less "
                            f"{FREE_BYTES / 1e9:.1f} GB free")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    model = init_lm(small, generator=gen, device=dev)
    n = LM_CHECK
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                         device=dev, dtype=torch.int32)
    want, _ = lm_apply(model, toks, small)
    cache = init_lm_cache(small, 2, n, dtype=torch.float32, device=dev)
    err = decode_matches(cfg.name, want, toks, lambda t, i: lm_decode_step(
        model, cache, t, i, small)[0])
    del model, cache
    out = dict(layers=depth, dtype="float32", batch=2, positions=n,
               max_abs_err=err, max_abs_logit=float(want.abs().max()),
               tolerance=2e-3)
    if cfg.n_experts:
        out["capacity_factor"] = small.capacity_factor
    return out


def decode_matches(name: str, want, toks, decode) -> float:
    """`decode(token (B, 1), i)`'s logits (B, 1, V) at every position i of
    toks (B, n) against the parallel logits `want` (B, n, V), 2e-3
    relative plus absolute; returns the largest absolute error. Raises on
    a failure."""
    if not bool(torch.isfinite(want).all()):
        raise AssertionError(f"{name} cross-check: prefill logits not "
                             "finite")
    err = 0.0
    for i in range(toks.shape[1]):
        got = decode(toks[:, i:i + 1], i)
        e = float((got[:, 0] - want[:, i]).abs().max())
        if not torch.allclose(got[:, 0], want[:, i], rtol=2e-3, atol=2e-3):
            raise AssertionError(
                f"{name} cross-check: decode logits at position {i} differ "
                f"from the prefill's (max abs err {e}, tolerance 2e-3 "
                "relative plus absolute)")
        err = max(err, e)
    return err


def enc_layers(cfg) -> int:
    """An encoder-decoder's encoder layers; 0 for a decoder-only LM."""
    if not cfg.is_encoder_decoder:
        return 0
    return cfg.n_enc_layers or cfg.n_layers


def encdec_cross_check(cfg, args, dev) -> dict:
    """The reference's `test_encdec_decode_matches_parallel_apply` at full
    width and full depth in float32: `encdec_apply`'s logits against
    token-by-token `encdec_decode_step` logits at every one of LM_CHECK
    positions, over `enc_context` frames, 2e-3 relative plus absolute (the
    apply takes the plain attention, the decode K16 and the plain cross
    attention over the precomputed cross K/V)."""
    import dataclasses
    from repro_torch.models.encdec import (encdec_apply, encdec_decode_step,
                                           encode, init_encdec,
                                           precompute_cross_kv)
    small = dataclasses.replace(cfg, param_dtype="float32",
                                activ_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    model = init_encdec(small, generator=gen, device=dev)
    n, T = LM_CHECK, cfg.enc_context
    frames = torch.randn((2, T, cfg.d_model), generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                         device=dev, dtype=torch.int32)
    want, _ = encdec_apply(model, frames, toks, small)
    cache = new_cache(small, 2, n, dev, precompute_cross_kv(
        model, encode(model, frames, small), small, dtype=torch.float32))
    err = decode_matches(cfg.name, want, toks, lambda t, i: encdec_decode_step(
        model, cache, t, i, small)[0])
    del model, cache
    return dict(layers=enc_layers(cfg) + cfg.n_layers, dtype="float32",
                batch=2, frames=T, positions=n, max_abs_err=err,
                max_abs_logit=float(want.abs().max()), tolerance=2e-3)


def encdec_blocked(cfg, dev) -> bool:
    """Whether an encoder-decoder's attentions at whisper's 1,500 frames
    take the blocked kernel on `dev`: on a card, whenever the kernel takes
    the head size and type (`nn.attention._blocked`); on the CPU not (the
    reference's rule wants multiples of 1,024)."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    return dev.type == "cuda" and flash_ops.takes(cfg.head_dim_, cfg.adtype)


def encdec_requests(model, cfg, prompts, gen) -> tuple[list, dict]:
    """An encoder-decoder's requests: `enc_context` frames each (the stub
    frontend's precomputed embeddings, drawn from `gen`), encoded and
    turned into the cross K/V (timed: ``encode_ms``), then
    `make_prefill_step` over the prompts against the frames; each twice,
    the first call warming up. Returns (the cross K/V, the line's
    fields)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.encdec import encode, precompute_cross_kv
    B, P = prompts.shape
    frames = torch.randn((B, cfg.enc_context, cfg.d_model), generator=gen,
                         device=prompts.device)
    encode_ms = []
    for _ in range(2):                     # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            cross_kv = precompute_cross_kv(model, encode(model, frames, cfg),
                                           cfg, dtype=cfg.adtype)
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
    prefill, secs = make_prefill_step(cfg), []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(model, {"frames": frames, "tokens": prompts})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if logits.shape != (B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: bad prefill logits")
    cross_bytes = sum(t.numel() * t.element_size() for kv in cross_kv
                      for t in kv.values())
    return cross_kv, dict(frames=cfg.enc_context, encode_ms=encode_ms,
                          cross_kv_bytes=cross_bytes,
                          prefill_tokens=B * P, prefill_seconds=secs,
                          prefill_tokens_per_s=B * P / secs[1])


def decode_read_bytes(model, cfg) -> int:
    """The weights a decode step reads: every one but the embedding
    table's (B rows of it) - every expert of a MoE layer too (the
    reference's dispatch computes all E x C slots) - and of an
    encoder-decoder only the decoder's, without the cross attention's K/V
    projections (the encoder and those run once a request)."""
    def read(name):
        if name.startswith("embed."):
            return False
        if cfg.is_encoder_decoder:
            return not name.startswith(("enc.", "ln_enc.")) and \
                ".xattn.wk." not in name and ".xattn.wv." not in name
        return True
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters() if read(name))


MOE_CHECK_TOL = 2**-6    # of the oracle's largest |value|


def moe_layer_check(p, cfg, x) -> dict:
    """One MoE layer `p` at the served types on x (B, S, d): the experts
    `moe_apply` routes each token to (`moe.route`, which it calls) must
    equal those of a float32 oracle routing the same bf16-rounded input
    through the same float32 router, exactly; its output must equal the
    oracle's sum of gate x expert(x), plus the shared expert, computed in
    float32 from each token's k experts' weight slices, within
    MOE_CHECK_TOL of the oracle's largest |value| (four bf16 roundings at
    the output's scale; 1.3 - 1.6 of them measured at llama4-scout's and
    kimi-k2's widths, while one token sent to a wrong expert moved it by
    1.37 at kimi-k2's width on the CPU, 30 times the tolerance).
    The capacity must hold every token (C = Sg), so nothing can drop.
    Raises on a failure."""
    from repro_torch.nn import moe
    from repro_torch.nn.layers import silu
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G, Sg, C = moe.capacity(B, S, E, k, cfg.capacity_factor)
    if C != Sg:
        raise ValueError(f"{cfg.name}: C {C} < Sg {Sg}, tokens could drop")
    y, _ = moe.moe_apply(p, x, n_experts=E, top_k=k,
                         capacity_factor=cfg.capacity_factor)
    got_idx = moe.route(p, x.reshape(G, Sg, d), k)[3].reshape(B * S, k)
    xf = x.float().reshape(B * S, d)
    probs = torch.softmax(xf @ p["router"]["w"].float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    if not torch.equal(got_idx, idx):
        bad = (got_idx != idx).any(-1).nonzero().flatten().tolist()
        raise AssertionError(f"{cfg.name} MoE layer check: moe_apply routes "
                             f"tokens {bad} to experts other than the "
                             "float32 oracle's")
    want = torch.empty_like(xf)
    for t in range(B * S):
        w = {n: p[n][idx[t]].float() for n in ("w_gate", "w_up", "w_down")}
        xt = xf[t].expand(k, 1, d)
        h = silu(torch.bmm(xt, w["w_gate"])) * torch.bmm(xt, w["w_up"])
        want[t] = (gates[t, :, None] * torch.bmm(h, w["w_down"])[:, 0]).sum(0)
    if "shared" in p:
        sw = {n: p["shared"][n]["w"].float()
              for n in ("w_gate", "w_up", "w_down")}
        want += (silu(xf @ sw["w_gate"]) * (xf @ sw["w_up"])) @ sw["w_down"]
    got = y.float().reshape(B * S, d)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if y.dtype != x.dtype or not bool(torch.isfinite(got).all()) \
            or not err <= MOE_CHECK_TOL * scale:
        raise AssertionError(
            f"{cfg.name} MoE layer check: moe_apply's output {y.dtype} "
            f"differs from the float32 oracle's by {err}, over "
            f"{MOE_CHECK_TOL} x {scale}")
    return dict(tokens=B * S, experts=E, top_k=k, capacity=C,
                dtype=str(x.dtype), experts_equal=True, max_abs_err=err,
                max_abs_oracle=scale, tolerance=f"{MOE_CHECK_TOL} x "
                                                "max |oracle|")


def add_counts(into: tuple[dict, dict], launches: dict, shapes: dict):
    counts, seen = into
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v
    for k, by_shape in shapes.items():
        acc = seen.setdefault(k, {})
        for shape, v in by_shape.items():
            acc[shape] = acc.get(shape, 0) + v


LM_MAX_LEN = 4096        # KV cache slots per request
LM_CHECK = 64            # positions of the reduced-depth cross-check
LM_PROFILE_STEPS = 4     # serve steps traced after each model's run
# depth cuts: layers run where one card cannot hold them all in bf16 at
# full width (llama4-scout: 48 layers are 216 GB; kimi-k2: 61 are 2.1 TB)
LM_DEPTH = {"llama4-scout-17b-a16e": 12, "kimi-k2-1t-a32b": 1}
# attention models whose prefill runs, at `LM_ATTN_PREFILL_LEN` tokens a
# request (>= 2,048, so every attention layer takes the blocked kernel)
LM_ATTN_PREFILL = ("gemma2-9b",)
LM_ATTN_PREFILL_LEN = 4096


def lm_config(name: str, dev):
    """The model's full config cut to `LM_DEPTH`'s layers; refused where
    its weights (from `param_count()`) would not leave FREE_BYTES free."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    layers = min(LM_DEPTH.get(name, cfg.n_layers), cfg.n_layers)
    cut = dataclasses.replace(cfg, n_layers=layers)
    need, card = cut.param_count() * cut.pdtype.itemsize, card_bytes(dev)
    if card is not None and need > card - FREE_BYTES:
        raise ValueError(
            f"{name} at {layers} of {cfg.n_layers} layers: "
            f"{cut.param_count()} parameters, {need / 1e9:.1f} GB of "
            f"{cut.pdtype} weights, leave under {FREE_BYTES / 1e9:.1f} GB "
            f"of the card's {card / 1e9:.1f} GB free")
    return cut, cfg.n_layers


def phase_lm_serve(args, dev=None) -> tuple[dict, dict]:
    """Each model of `--lm-models` at full width and `LM_DEPTH`'s depth in
    bf16; returns the launches and launch shapes of the models' runs
    together (the cross-checks and the MoE layer checks are not counted).
    `dev` is the card (a rehearsal on the CPU passes the CPU and smoke
    configs)."""
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.lm import init_lm
    dev = torch.device("cuda", 0) if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    total = ({}, {})
    for name in args.lm_models:
        cfg, full_layers = lm_config(name, dev)
        encdec = cfg.is_encoder_decoder
        check = (encdec_cross_check if encdec else cross_check)(cfg, args,
                                                                dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.perf_counter()
        model = (init_encdec if encdec else init_lm)(cfg, generator=gen,
                                                     device=dev)
        torch.cuda.synchronize()
        init_seconds = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        read_bytes = decode_read_bytes(model, cfg)
        B, P, G = args.lm_batch, args.lm_prompt, args.lm_gen
        n_attn = sum(cfg.blocks[i % cfg.period].mixer != "mamba"
                     for i in range(cfg.n_layers))
        n_mamba = cfg.n_layers - n_attn
        fields = {}
        reset_kernel_launch_counts()
        n_prefill = (args.lm_prefill if n_mamba else LM_ATTN_PREFILL_LEN
                     if name in LM_ATTN_PREFILL else 0)
        # their attention layers' prefill calls take the blocked kernel
        n_blocked = 2 * n_attn if name in LM_ATTN_PREFILL else 0
        if n_prefill:
            prefill = make_prefill_step(cfg)
            toks = torch.randint(0, cfg.vocab_size, (B, n_prefill),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
            secs = []
            with attention_calls() as calls:
                for _ in range(2):                 # the first call warms up
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits = prefill(model, {"tokens": toks})
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            if logits.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: bad prefill logits")
            want = {BLOCKED: n_blocked, "_sdpa": 0, PLAIN_BLOCKED: 0}
            if calls != want:
                raise AssertionError(f"{name}: prefill attention calls "
                                     f"{calls}, expected {want}")
            fields.update(prefill_tokens=B * n_prefill,
                          prefill_seconds=secs,
                          prefill_tokens_per_s=B * n_prefill / secs[1],
                          prefill_attention_calls=calls)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev, dtype=torch.int32)
        cross_kv = None
        if encdec:
            cross_kv, more = encdec_requests(model, cfg, prompts, gen)
            fields.update(more)
            # a step reads the cross K/V besides the weights
            fields["read_bound_ms_with_cross_kv"] = (
                read_bytes + more["cross_kv_bytes"]) / HBM_BYTES_PER_S * 1e3
        out, prompt_s, gen_s, cache = serve(model, cfg, prompts, G,
                                            LM_MAX_LEN, cross_kv)
        torch.cuda.synchronize()
        launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
        # after the counts: the profiled steps, the replay and the MoE
        # layer check are not part of the run
        prof = profile_steps(model, cfg, cache, out[:, -1:], P + G - 1,
                             LM_PROFILE_STEPS)
        del cache
        peak = torch.cuda.max_memory_allocated()
        checked = replay(model, cfg, prompts, out, LM_MAX_LEN, cross_kv)
        if cfg.n_experts:
            # nothing of the model may outlive the iteration: a kept layer
            # would hold its experts' weights under the next model's peak
            x = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev)
            fields["moe_check"] = moe_layer_check(
                next(layer for layer in model.layers
                     if layer.spec.mlp == "moe")["moe"], cfg,
                x.to(cfg.adtype))
        want = {}
        if n_attn:
            want["decode_attn"] = n_attn * (P + G - 1)
        if n_mamba:
            want["selective_scan"] = want["causal_conv"] = n_mamba * 2
        if encdec and encdec_blocked(cfg, dev):
            # the encoder's attentions in both encode calls and the three
            # attentions of both prefill calls, at any lengths on the card
            n_blocked += 2 * enc_layers(cfg) + 2 * (enc_layers(cfg)
                                                    + 2 * cfg.n_layers)
        if n_blocked:
            want[BLOCKED] = n_blocked
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} ({n_attn} attention layers x "
                                 f"{P + G - 1} decode steps, {n_mamba} Mamba "
                                 f"layers x 2 prefill calls (the scan and "
                                 f"the conv), {n_blocked} "
                                 "blocked attention calls in the prefill "
                                 "and, for an encoder-decoder, the encode)")
        add_counts(total, launches, shapes)
        if cfg.n_layers < full_layers:
            fields["reduced"] = "depth: one card's memory"
        if encdec:
            fields.update(enc_layers=enc_layers(cfg),
                          dec_layers=cfg.n_layers)
        emit("lm_serve", model=name, layers=enc_layers(cfg) + cfg.n_layers,
             full_layers=enc_layers(cfg) + full_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size,
             params=sum(p.numel() for p in model.parameters()),
             weight_bytes=weight_bytes, dtype=str(cfg.pdtype), batch=B,
             prompt=P, generated=G, max_len=LM_MAX_LEN, seed=args.seed,
             init_seconds=init_seconds, decode_steps=P + G - 1,
             finite_checked_steps=checked,
             prompt_seconds=prompt_s, prompt_ms_per_step=prompt_s / P * 1e3,
             gen_seconds=gen_s, gen_ms_per_step=gen_s / (G - 1) * 1e3,
             decode_tokens_per_s=B * (G - 1) / gen_s,
             weights_read_bytes=read_bytes,
             weights_read_bound_ms=read_bytes / HBM_BYTES_PER_S * 1e3,
             peak_device_bytes=peak, launches=launches,
             first_tokens=out[0, :8].tolist(), cross_check=check,
             profile=prof, **fields, ok=True)
        del model, out, cross_kv
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 13: LM training fed by the HTAP token pipeline
# ---------------------------------------------------------------------------

TRAIN_CELL = "fm7b-train"    # the benchmark's cell the phase runs
LM_TRAIN_STEPS = 4
# the token pipeline's kernels: ship, one-column apply stage, snapshot
PIPELINE_KERNELS = ("merge_runs", "bitonic_apply", "snapshot_copy")
# the gradient cross-check: layers, batch, sequence (float32, full width)
LM_GRAD_CHECK = (2, 1, 512)
LM_GRAD_TOL = 1e-3           # of each parameter's largest |g| (and the loss)


def train_cell(seed: int, dev):
    """`TRAIN_CELL` as the benchmark's harness hands it to
    `bench/drivers/lm_train.py`: the workload, its configuration and
    traffic read from their files."""
    from bench import harness
    wl, config, traffic = harness.load_cell(harness.load_benchmark(),
                                            TRAIN_CELL)
    return harness.Cell(name=TRAIN_CELL, config_name=wl["config"],
                        config=config, traffic_name=wl["traffic"],
                        traffic=traffic, chips=int(wl["chips"]), seed=seed,
                        seconds=0.0, trace=False, device=dev,
                        t_start=STARTED)


def same_batch(got, want, step) -> None:
    """`got` (tokens, labels) on the card equals `want`, the window the
    benchmark's reference works out from the seed's token column, token for
    token: the apply and the snapshot wrote the ingested tokens."""
    for what, g, w in zip(("tokens", "labels"), got, want):
        g = g.cpu().numpy()
        if g.shape != w.shape or not np.array_equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else g.size
            raise AssertionError(
                f"lm_train: get_batch({step})'s {what} differ from the "
                f"ingested tokens at {bad} of {w.size} places")


def train_grad_check(cfg, args, dev) -> dict:
    """`LM_GRAD_CHECK`'s layers at full width in float32: the loss and
    every parameter's gradient on `dev` (the scan kernel and its backward
    kernel; remat as the config says) against the same model's on the
    CPU (the plain scan, differentiated by autograd), each within
    LM_GRAD_TOL of the CPU gradient's largest |value|, and every Mamba
    mixer parameter's gradient non-zero. Raises on a failure."""
    import copy
    import dataclasses
    from repro_torch.models.lm import init_lm, lm_loss
    layers, batch, seq = LM_GRAD_CHECK
    small = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                                activ_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    model = init_lm(small, generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    host = copy.deepcopy(model).to("cpu")

    def loss_and_grads(m, t):
        t0 = time.perf_counter()
        m.requires_grad_(True)
        loss = lm_loss(m, t[:, :-1], t[:, 1:], small)
        loss.backward()
        grads = {k: p.grad.float().cpu() for k, p in m.named_parameters()
                 if p.grad is not None}
        return float(loss.detach()), grads, time.perf_counter() - t0

    loss_dev, g_dev, dev_s = loss_and_grads(model, toks)
    loss_cpu, g_cpu, cpu_s = loss_and_grads(host, toks.cpu())
    del model, host
    errs = grads_match("lm_train", loss_dev, g_dev, loss_cpu, g_cpu,
                       nonzero=".mamba.")
    return dict(layers=layers, batch=batch, seq=seq, dtype="float32",
                remat=small.remat, loss_card=loss_dev, loss_cpu=loss_cpu,
                leaves=len(errs), max_rel_err=max(errs.values()),
                worst_leaf=max(errs, key=errs.get),
                tolerance=f"{LM_GRAD_TOL} x each leaf's max |g|",
                card_seconds=dev_s, cpu_seconds=cpu_s)


def grads_match(what, loss_dev, g_dev, loss_cpu, g_cpu,
                nonzero: str) -> dict:
    """The card's loss within LM_GRAD_TOL of the CPU's, the same leaves,
    each leaf's gradient within LM_GRAD_TOL of the CPU gradient's largest
    |value|, and no zero gradient on a leaf whose name holds `nonzero`.
    Returns each leaf's error over that largest |value|; raises on a
    failure."""
    if not math.isfinite(loss_dev) or abs(loss_dev - loss_cpu) > \
            LM_GRAD_TOL * abs(loss_cpu):
        raise AssertionError(f"{what} gradient check: loss {loss_dev} on "
                             f"the card, {loss_cpu} on the CPU")
    if set(g_dev) != set(g_cpu):
        raise AssertionError(f"{what} gradient check: the card and the CPU "
                             f"reached other parameters: "
                             f"{sorted(set(g_dev) ^ set(g_cpu))}")
    errs = {}
    for k, want in g_cpu.items():
        scale = float(want.abs().max())
        err = float((g_dev[k] - want).abs().max())
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        errs[k] = rel
        if not rel <= LM_GRAD_TOL:
            raise AssertionError(
                f"{what} gradient check: {k}'s gradient differs from the "
                f"CPU's by {err}, over {LM_GRAD_TOL} x {scale}")
        if nonzero in k and scale == 0:
            raise AssertionError(f"{what} gradient check: {k} has a zero "
                                 "gradient")
    return errs


def phase_lm_train(args, dev=None) -> tuple[dict, dict]:
    """`TRAIN_CELL`'s training object, built by the benchmark's
    `bench/drivers/lm_train.py` (the configuration's sizes and seeded
    weights, its AdamW, `make_train_step`, an `HTAPTokenPipeline` on the
    card), run for `LM_TRAIN_STEPS` of its `Program.step`s (the
    traffic's tokens ingested, `propagate`, `get_batch(step)`, the train
    step). Holds what the benchmark does not: the kernels' launches a
    step, the pipeline's kernels, every ingested token applied with no
    freshness lag, every batch the reference's window, every Mamba call
    through the gated scan (``mamba.gated_scan``, under
    `tracing.recording()`), and the float32 gradient cross-check on the
    cell's block. Returns the launches and launch shapes of the steps (the
    cross-check before them is not counted)."""
    from bench.drivers import lm_train
    from bench.trace import Spans
    from repro_torch import tracing
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    dev = torch.device("cuda", 0) if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    cell = train_cell(args.seed, dev)
    cfg, tr, job = cell.config, cell.traffic, cell.config["job"]
    mcfg = lm_train.model_config(cfg)
    check = train_grad_check(mcfg, args, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prog = lm_train.Program(cell, Spans(dev, False))
    want = lm_train.reference_batches(cell, LM_TRAIN_STEPS)
    reset_kernel_launch_counts()
    tracing.clear()
    with tracing.recording():
        for step in range(LM_TRAIN_STEPS):
            prog.step(step)
            rows = prog.pipe.replica.columns[prog.pipe.TOKEN_COL].n_rows
            if rows != tr["initial_tokens"] + (step + 1) * \
                    tr["ingest_per_step"] or prog.pipe.freshness_lag() != 0:
                raise AssertionError(
                    f"lm_train: after step {step} the column holds {rows} "
                    f"rows, lag {prog.pipe.freshness_lag()}: propagate did "
                    "not apply every ingested token")
            toks, labels = prog.batches[step]
            if toks.shape != (tr["batch"], tr["seq_len"]) or \
                    toks.device != dev or toks.dtype != torch.int32:
                raise AssertionError(f"lm_train: batch {tuple(toks.shape)} "
                                     f"{toks.dtype} on {toks.device}")
            same_batch((toks, labels), want[step], step)
    gated = sum(r.counts.get("mamba.gated_scan", 0)
                for r in tracing.records())
    tracing.clear()
    launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
    losses = [float(x) for x in prog.losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"lm_train: a loss is not finite: {losses}")
    n_mamba = sum(mcfg.blocks[i % mcfg.period].mixer == "mamba"
                  for i in range(mcfg.n_layers))
    remat = 2 if mcfg.remat else 1
    micro = job["micro_batches"]
    forward = n_mamba * remat * micro * LM_TRAIN_STEPS
    backward = n_mamba * micro * LM_TRAIN_STEPS
    expect = {"selective_scan": forward, "selective_scan_bwd": backward,
              "causal_conv": forward, "causal_conv_bwd": backward,
              "adamw": adamw_launches(prog.model, prog.opt_state)
              * LM_TRAIN_STEPS}
    got = {k: launches.get(k, 0) for k in expect}
    if got != expect:
        raise AssertionError(
            f"lm_train: launches {got}, expected {expect} ({n_mamba} Mamba "
            f"layers x {remat} (remat) x {micro} micro-batches x "
            f"{LM_TRAIN_STEPS} steps forward, the scan and the conv; their "
            "backward calls once a layer and micro-batch; AdamW once a group "
            "of leaves and step)")
    if gated != forward:
        raise AssertionError(f"lm_train: {gated} Mamba calls took the gated "
                             f"scan, of {forward} scan launches")
    idle = [k for k in PIPELINE_KERNELS if not launches.get(k)]
    if idle:
        raise AssertionError(f"lm_train: the token pipeline launched no "
                             f"{idle}")
    emit("lm_train", cell=TRAIN_CELL, config=cell.config_name,
         layers=mcfg.n_layers, d_model=mcfg.d_model, d_inner=mcfg.d_inner,
         d_state=mcfg.d_state, vocab=mcfg.vocab_size,
         params=sum(p.numel() for p in prog.model.parameters()),
         dtype=str(mcfg.pdtype), remat=mcfg.remat,
         optimizer=job["optimizer"], batch=tr["batch"], seq=tr["seq_len"],
         micro_batches=micro, loss_chunk=mcfg.loss_chunk,
         steps=LM_TRAIN_STEPS, seed=args.seed, reduced=cfg["reduced"],
         losses=losses, peak_device_bytes=torch.cuda.max_memory_allocated(),
         pipeline=dict(initial_tokens=tr["initial_tokens"],
                       ingest_per_step=tr["ingest_per_step"],
                       rows_at_end=rows,
                       batches_equal_ingested_tokens=LM_TRAIN_STEPS),
         launches=launches, gated_scans=gated, grad_check=check, ok=True)
    del prog
    torch.cuda.empty_cache()
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 14: the encoder-decoder's training on the blocked attention
# ---------------------------------------------------------------------------

ENCDEC_TRAIN_MODEL = "whisper-base"
ENCDEC_TRAIN_BATCH = 2        # sequences a step, one micro-batch
ENCDEC_TRAIN_SEQ = 4096       # tokens and frames a sequence (the reference's
                              # train_4k: enc_len = dec_len = seq_len)
ENCDEC_TRAIN_STEPS = 4
BLOCKED = "flash_attention"
PLAIN_BLOCKED = "flash_attention_fwd_ref"
# the float32 gradient cross-check: (encoder and decoder layers, batch,
# tokens and frames): the blocked branch (S >= 2,048)
ENCDEC_GRAD_CHECK = (1, 1, 2048)


@contextlib.contextmanager
def attention_calls(annotate: bool = False):
    """While open, counts the calls of the blocked attention
    (`nn.flash.flash_attention`), of the plain one (`nn.attention._sdpa`)
    and of the plain blocked loop (`flash_attention_fwd_ref`, which a CUDA
    tensor must never reach) that the prefill and training forms reach (the
    modules look each up at each call); with `annotate`, each blocked call
    runs inside a `torch.profiler.record_function` range named BLOCKED."""
    from torch.profiler import record_function

    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.nn import attention, flash
    calls = {BLOCKED: 0, "_sdpa": 0, PLAIN_BLOCKED: 0}
    real = {BLOCKED: (flash, flash.flash_attention),
            "_sdpa": (attention, attention._sdpa),
            PLAIN_BLOCKED: (flash_ops, flash_ops.flash_attention_fwd_ref)}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            if annotate and name == BLOCKED:
                with record_function(BLOCKED):
                    return fn(*a, **kw)
            return fn(*a, **kw)
        return call
    for name, (mod, fn) in real.items():
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)


def encdec_grad_check(cfg, args, dev) -> dict:
    """`ENCDEC_GRAD_CHECK`'s encoder and decoder layers at full width in
    float32 on the blocked branch: the loss and every parameter's gradient
    on `dev` (the blocked attention's kernel and its backward kernels;
    remat as the config says) against the same model's on the CPU (the
    plain blocked loop, differentiated by autograd), by `grads_match`
    (LM_GRAD_TOL), every attention parameter's gradient non-zero, and the
    backward kernels launched on `dev`. Raises on a failure."""
    import copy
    import dataclasses
    from repro_torch.kernels.common import kernel_launch_counts
    from repro_torch.models.encdec import encdec_loss, init_encdec
    layers, batch, seq = ENCDEC_GRAD_CHECK
    small = dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers,
                                param_dtype="float32", activ_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    model = init_encdec(small, generator=gen, device=dev)
    frames = torch.randn((batch, seq, cfg.d_model), generator=gen,
                         device=dev)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    host = copy.deepcopy(model).to("cpu")

    def loss_and_grads(m, f, t):
        t0 = time.perf_counter()
        m.requires_grad_(True)
        before = kernel_launch_counts().get("flash_attention_bwd", 0)
        with attention_calls() as calls:
            loss = encdec_loss(m, f, t[:, :-1], t[:, 1:], small)
            loss.backward()
        grads = {k: p.grad.float().cpu() for k, p in m.named_parameters()
                 if p.grad is not None}
        return (float(loss.detach()), grads, time.perf_counter() - t0,
                calls, kernel_launch_counts().get("flash_attention_bwd", 0)
                - before)

    loss_dev, g_dev, dev_s, calls, bwd = loss_and_grads(model, frames, toks)
    loss_cpu, g_cpu, cpu_s, _, _ = loss_and_grads(host, frames.cpu(),
                                                  toks.cpu())
    del model, host
    if calls[PLAIN_BLOCKED] or not calls[BLOCKED] or calls["_sdpa"] or \
            bwd != 2 * 3 * layers:
        raise AssertionError(f"{cfg.name} gradient check: attention calls "
                             f"{calls} and {bwd} backward launches on the "
                             "card, expected only blocked calls through the "
                             f"kernels and {2 * 3 * layers} backward "
                             "launches")
    errs = grads_match(f"{cfg.name} train", loss_dev, g_dev, loss_cpu, g_cpu,
                       nonzero="attn.")
    return dict(enc_layers=layers, dec_layers=layers, batch=batch, seq=seq,
                frames=seq, dtype="float32", remat=small.remat,
                loss_card=loss_dev, loss_cpu=loss_cpu, leaves=len(errs),
                max_rel_err=max(errs.values()),
                worst_leaf=max(errs, key=errs.get),
                tolerance=f"{LM_GRAD_TOL} x each leaf's max |g|",
                blocked_calls_card=calls[BLOCKED],
                backward_launches_card=bwd, card_seconds=dev_s,
                cpu_seconds=cpu_s)


def phase_encdec_train(args, dev=None) -> tuple[dict, dict]:
    """`ENCDEC_TRAIN_MODEL` at full width and depth, bf16, remat,
    ``loss_chunk`` as configured, the optimizer `default_optimizer_for`
    picks, `ENCDEC_TRAIN_STEPS` steps of `ENCDEC_TRAIN_BATCH` x
    `ENCDEC_TRAIN_SEQ` tokens (a `SyntheticPipeline`) against as many
    frames (drawn from ``--seed``) in one micro-batch. Every attention of
    the step (encoder, decoder self and cross) takes the blocked path, the
    hand-written kernel and its backward: the phase fails unless the
    blocked attention ran (encoder layers + 2 x decoder layers) x (2 with
    remat) times a step, each one forward launch, and its backward as
    often as (encoder layers + 2 x decoder layers) a step, two launches
    each (the dQ pass, the dK/dV pass); on any other kernel's launch, on a
    call of the plain attention or of the plain blocked loop, on a loss
    that is not finite, and on the float32 gradient cross-check
    (`encdec_grad_check`). Returns the steps' launches and launch
    shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.encdec import init_encdec
    from repro_torch.optim import default_optimizer_for, get_optimizer
    dev = torch.device("cuda", 0) if dev is None else dev
    cfg = get_config(ENCDEC_TRAIN_MODEL)
    B, S = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
    grad_check = encdec_grad_check(cfg, args, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    model = init_encdec(cfg, generator=gen, device=dev)
    opt_name = default_optimizer_for(cfg.param_count())
    lr = adamw_hyper()["lr"]
    opt = get_optimizer(opt_name, lr=lr, period=cfg.period)
    opt_state = opt[0](dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt, micro_batches=1)
    pipe = SyntheticPipeline(cfg.vocab_size, S, B, seed=args.seed,
                             device=dev)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t0

    def batch(step):
        toks, labels = pipe.get_batch(step)
        frames = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        return {"tokens": toks, "labels": labels, "frames": frames}
    losses, step_s = [], []
    reset_kernel_launch_counts()
    with attention_calls() as calls:
        for step in range(ENCDEC_TRAIN_STEPS):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, step, b)
            losses.append(float(metrics["loss"]))   # synchronises
            step_s.append(time.perf_counter() - t0)
    launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name} train: a loss is not finite: "
                             f"{losses}")
    n_attn = enc_layers(cfg) + 2 * cfg.n_layers
    per_step = n_attn * (2 if cfg.remat else 1)
    want = {BLOCKED: per_step * ENCDEC_TRAIN_STEPS,
            BLOCKED + "_bwd": 2 * n_attn * ENCDEC_TRAIN_STEPS,
            "adamw": adamw_launches(model, opt_state)
            * ENCDEC_TRAIN_STEPS}
    if launches != want:
        raise AssertionError(
            f"{cfg.name} train: launches {launches}, expected {want} "
            f"({per_step} forward launches a step, {n_attn} backward calls "
            "a step of two launches each, AdamW once a group of leaves and "
            "step; no other hand-written kernel is on this path)")
    want = {BLOCKED: per_step * ENCDEC_TRAIN_STEPS, "_sdpa": 0,
            PLAIN_BLOCKED: 0}
    if calls != want:
        raise AssertionError(
            f"{cfg.name} train: attention calls {calls}, expected {want} "
            f"({enc_layers(cfg)} encoder + 2 x {cfg.n_layers} decoder "
            "attentions a forward, all blocked at S = T = "
            f"{S}, twice with remat, never the plain blocked loop)")
    peak = torch.cuda.max_memory_allocated()
    b = batch(ENCDEC_TRAIN_STEPS)

    def profiled():
        with attention_calls(annotate=True):
            step_fn(model, opt_state, ENCDEC_TRAIN_STEPS, b)
    t0 = time.perf_counter()
    prof = profile_device(profiled, 1, (BLOCKED,))
    prof["seconds_with_post_processing"] = time.perf_counter() - t0
    steady = step_s[1:] or step_s
    emit("lm_train", model=ENCDEC_TRAIN_MODEL,
         layers=enc_layers(cfg) + cfg.n_layers,
         enc_layers=enc_layers(cfg), dec_layers=cfg.n_layers,
         full_layers=enc_layers(cfg) + cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_],
         vocab=cfg.vocab_size,
         params=sum(p.numel() for p in model.parameters()),
         dtype=str(cfg.pdtype), remat=cfg.remat, optimizer=opt_name,
         lr=lr, batch=B, seq=S, frames=S, micro_batches=1,
         loss_chunk=cfg.loss_chunk, steps=ENCDEC_TRAIN_STEPS,
         seed=args.seed, setup_seconds=setup_seconds, losses=losses,
         step_seconds=step_s, ms_per_step=sum(steady) / len(steady) * 1e3,
         ms_per_step_of="the steps after the first",
         tokens_per_s=B * S * len(steady) / sum(steady),
         peak_device_bytes=peak, attention_calls_per_step=per_step,
         backward_calls_per_step=n_attn, grad_check=grad_check,
         profile=prof, launches=launches, ok=True)
    del model, opt_state, b
    torch.cuda.empty_cache()
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 15: every kernel against its plain version
# ---------------------------------------------------------------------------
# Each kernel has a `*_cost(shape)` -> (bytes, operations) of one launch at a
# shape its wrapper recorded (each input read once, each output written
# once; compares, adds and moves outside the tensor cores), an `edge_*`
# check, and a `measure_*` that holds and times it at one recorded shape.

def bits(x: int) -> int:
    """Steps of a binary search over x entries."""
    return max(1, math.ceil(math.log2(x + 1)))


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def sort_ops(width: int) -> int:
    """Compare-exchanges (two operations each) of a bitonic sort network."""
    lg = next_pow2(width).bit_length() - 1
    return (next_pow2(width) // 2) * (lg * (lg + 1) // 2) * 2


def scan_sharded_cost(shape, join):
    """(S, W, k[, kj], Q): every slot of the stacked shards is read once
    (the benchmark's `scan_cost` over S x W rows), and S partials out."""
    n_shards, width = shape[0], shape[1]
    nbytes, ops = scan_cost((n_shards * width,) + tuple(shape[2:]))
    lanes = 3 if join else 2
    return nbytes + (n_shards - 1) * lanes * shape[-1] * 8, ops


def probe_cost(shape):
    """(S, W, n_buckets, slots): each query read and written once, the
    table read once; a mod, a sign fix, and a compare and max per slot."""
    n_shards, width, n_buckets, slots = shape
    q = n_shards * width
    return q * 8 + n_buckets * slots * 8, q * (2 * slots + 3)


def merge_cost(shape):
    """(rows, wa, wb): the row-wise pair merge, keys and index lanes read
    and written; (k, n): the k-way merge of n keys in k runs of about n / k,
    keys read, keys and source indices written, each entry a search of its
    run's offset and k - 1 binary searches."""
    if len(shape) == 2:
        k, n = shape
        return (20 * n + 4 * (k + 1),
                n * (bits(k) + (k - 1) * bits(max(n // k, 1))))
    rows, wa, wb = shape
    return (2 * rows * (wa + wb) * 12,
            rows * (wa * bits(wb) + wb * bits(wa)))


def sort_cost(shape):
    rows, width = shape
    return 2 * rows * width * 4, rows * sort_ops(width)


def apply_cost(shape):
    """(rows, w_old, w_val): old and the values read, the sorted values and
    the merged row written; the values' sort network once and a compare,
    a select and a move a merged slot."""
    rows, w_old, w_val = shape
    w_merge = next_pow2(w_old + w_val)
    return (rows * 4 * (w_old + w_val + w_val + w_merge),
            rows * (sort_ops(w_val) + 3 * w_merge))


def snapshot_cost(shape):
    n, block = shape
    return 2 * n * 4 + (n + block - 1) // block, n


def scan_inputs(gen, n, kf, ka, kj, dev, invalid=0.1):
    fcodes = torch.randint(0, kf, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    acodes = torch.randint(0, ka, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    jcodes = torch.randint(0, kj, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    fvalid = torch.rand(n, generator=gen, device=dev) >= invalid
    jvalid = torch.rand(n, generator=gen, device=dev) >= invalid
    adict = torch.sort(torch.randint(-2**31, 2**31 - 1, (ka,), generator=gen,
                                     device=dev, dtype=torch.int64)
                       ).values.to(torch.int32)
    rcount = torch.randint(0, max(n, 2), (kj,), generator=gen, device=dev,
                           dtype=torch.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, adict, rcount


def edge_scan(gen, dev) -> int:
    """Ragged tails, one row, Q over one register tile, a dictionary larger
    than L1, unaligned views."""
    from repro_torch.kernels.dict_ops import scan_exact, scan_exact_ref
    cases = 0
    for n, kf, ka, kj, nq in ((1, 3, 3, 3, 1), (1_000_003, 40, 40, 40, 5),
                              (777_777, 64, 100_000, 60_000, 19),
                              (4096, 2, 2, 2, 8), (65_537, 1000, 50_000, 9, 9)):
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, kf, ka, kj, dev)
        lows = torch.randint(0, kf, (nq,), generator=gen, device=dev).tolist()
        bounds = [(lo, lo + 1 + (i * 7) % kf) for i, lo in enumerate(lows)]
        bounds[0] = (0, kf)                      # everything
        for off in (0, 1):                       # off=1: unaligned pointers
            args = (f[off:], a[off:], fv[off:], ad, bounds)
            must_equal(f"scan n={n} off={off}", scan_exact(*args),
                       scan_exact_ref(*args))
            jargs = args + (j[off:], jv[off:], rc)
            must_equal(f"scan+join n={n} off={off}", scan_exact(*jargs),
                       scan_exact_ref(*jargs))
            cases += 2
    return cases


def measure_scan(gen, dev, shape, join: bool) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_exact, scan_exact,
                                              scan_exact_ref)
    n, k, nq = shape[0], shape[1], shape[-1]
    kj = shape[2] if join else 1
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, kj, dev, invalid=0.0)
    span = max(1, 3 * k // 10)                   # each range selects ~30 %
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (j, jv, rc) if join else ()
    args = (f, a, fv, ad, bounds) + extra
    err = must_equal(f"scan {shape}", scan_exact(*args), scan_exact_ref(*args))
    res = torch.zeros((3 if join else 2, nq), dtype=torch.int64, device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    bare = (f, a, fv.view(torch.uint8), ad, barr, res) + (
        (j, jv.view(torch.uint8), rc) if join else ())
    return dict(max_abs_err=err,
                **({"instances": join_instances(nq)} if join else {}),
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                **device_time(lambda: launch_scan_exact(*bare)),
                wrapper_ms=time_ms(lambda: scan_exact(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_ref(*args), 3),
                library_ms=None)


def stacked(flat, sizes):
    """Lay a flat tensor's rows out as shards of `sizes` (zero padded), as
    a ShardedView does."""
    from repro_torch.core.dsm import stack_rows
    bounds = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return stack_rows([flat[lo:hi] for lo, hi in zip(bounds, bounds[1:])],
                      max(sizes))


def edge_scan_sharded(gen, dev) -> int:
    """An empty shard, more shards than rows, a padded tail, a width that
    is not a multiple of 4 (no 16-byte loads), k = 0, many shards."""
    from repro_torch.kernels.dict_ops import scan_exact, scan_exact_ref
    cases = 0
    for sizes, k, nq in (((0, 40, 41), 30, 3), ((1, 1, 0, 0, 0), 3, 1),
                         ((250_001, 250_000, 250_000, 250_000), 25_000, 9),
                         ((1001, 1000), 64, 19), ((7,) * 100, 5, 2),
                         ((2_500_000,) * 4, 100_000, 1)):
        n = sum(sizes)
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, max(n, 1), k, k, k, dev)
        lay = [stacked(t[:n], sizes) for t in (f, a, j, fv, jv)]
        bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7) for i in range(nq - 1)]
        args = (lay[0], lay[1], lay[3], ad, bounds)
        must_equal(f"sharded scan {sizes[:4]}", scan_exact(*args),
                   scan_exact_ref(*args))
        jargs = args + (lay[2], lay[4], rc)
        must_equal(f"sharded join scan {sizes[:4]}", scan_exact(*jargs),
                   scan_exact_ref(*jargs))
        cases += 2
    # k = 0: only padded (invalid) slots, nothing is gathered
    z = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    zv = torch.zeros((3, 5), dtype=torch.bool, device=dev)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    must_equal("sharded scan k=0", scan_exact(z, z, zv, empty, [(0, 1)], z,
                                              zv, empty),
               scan_exact_ref(z, z, zv, empty, [(0, 1)], z, zv, empty))
    return cases + 1


def measure_scan_sharded(gen, dev, shape, join: bool) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_exact, scan_exact,
                                              scan_exact_ref)
    n_shards, width, k, nq = shape[0], shape[1], shape[2], shape[-1]
    kj = shape[3] if join else 1
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n_shards * width, k, k, kj,
                                          dev, invalid=0.0)
    f, a, j, fv, jv = (t.reshape(n_shards, width) for t in (f, a, j, fv, jv))
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (j, jv, rc) if join else ()
    args = (f, a, fv, ad, bounds) + extra
    err = must_equal(f"sharded scan {shape}", scan_exact(*args),
                     scan_exact_ref(*args))
    res = torch.zeros((n_shards, 3 if join else 2, nq), dtype=torch.int64,
                      device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    bare = (f, a, fv.view(torch.uint8), ad, barr, res) + (
        (j, jv.view(torch.uint8), rc) if join else ())
    return dict(max_abs_err=err,
                **({"instances": join_instances(nq)} if join else {}),
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                **device_time(lambda: launch_scan_exact(*bare)),
                wrapper_ms=time_ms(lambda: scan_exact(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_ref(*args), 3),
                library_ms=None)


def mesh_shape(shape, join):
    """(N, W, k, kj, Q, nr_a, nr_j) of a mesh launch's recorded shape ((N,
    W, k, Q, nr_a) without the join lane: kj and nr_j 0)."""
    if join:
        return tuple(shape)
    n_isl, width, k, q, nr_a = shape
    return n_isl, width, k, 0, q, nr_a, 0


def scan_mesh_cost(shape, join):
    """(N, W, k[, kj], Q, nr_a[, nr_j]), N islands of W rows in one launch
    and the correction slice over stacks of nr_a (and nr_j) rows: every
    island's rows read once, its dictionary (and histogram) once each, the
    bounds in, each stack read once, one (2|3, Q) partial out."""
    n_isl, width, k, kj, q, nr_a, nr_j = mesh_shape(shape, join)
    lanes = 3 if join else 2
    nbytes = n_isl * (width * (9 + (5 if join else 0)) + k * 4
                      + kj * 4) + q * 8 + lanes * q * 8
    ops = n_isl * width * (2 * q + 2) * (2 if join else 1)
    for nr in (nr_a, nr_j):
        b, o = values_cost((nr, q))
        nbytes, ops = nbytes + b - 2 * q * 8, ops + o
    return nbytes, ops


def mesh_islands(flat_tensors, sizes):
    """Split flat tensors into per-island slices of `sizes`."""
    cuts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return [[t[lo:hi] for lo, hi in zip(cuts, cuts[1:])]
            for t in flat_tensors]


def edge_scan_mesh(gen, dev) -> int:
    """The mesh scans' edges, islands on the one card: an empty island,
    more islands than rows, uneven splits (so unaligned island bases), 17,
    33 and 100 islands (two, three and seven launches of up to 16), Q = 1,
    3 and 33, a dictionary holding int32's extremes (and negatives), each
    island's dictionary its own tensor; then the correction slice (the
    delta plane's groups) with stacks of 0, 1, 3 and 4,097 rows, Q = 1, 3,
    9 and 65 (two launches of at most 64 predicates), islands that are all
    empty (a launch of the slice alone) and 17 islands (the slice on the
    first of two launches)."""
    from repro_torch.kernels.dict_ops import (scan_exact_mesh,
                                              scan_exact_mesh_ref)
    cases = 0
    for sizes, k, nq in (((0, 40, 41), 30, 3), ((1, 1, 0, 0, 0), 3, 1),
                         ((250_001, 250_000, 250_000, 250_000), 25_000, 33),
                         ((1001, 1000), 64, 3), ((7,) * 100, 5, 1),
                         ((2_500_000,) * 4, 100_000, 33),
                         ((1001,) * 17, 300, 9),
                         (tuple(5000 + 3 * i for i in range(33)), 1000, 3)):
        n = sum(sizes)
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, max(n, 1), k, k, k, dev)
        ad[0], ad[-1] = I32_MIN, I32_MAX
        ad = torch.sort(ad).values
        fi, ai, ji, fvi, jvi = mesh_islands(
            [t[:n] for t in (f, a, j, fv, jv)], sizes)
        bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7)
                             for i in range(nq - 1)]
        dicts = [ad.clone() for _ in sizes] if len(sizes) in (17, 33) \
            else [ad] * len(sizes)
        args = (fi, ai, fvi, dicts, bounds)
        must_equal(f"mesh scan {sizes[:4]} Q={nq}", scan_exact_mesh(*args),
                   scan_exact_mesh_ref(*args))
        jargs = args + (ji, jvi, [rc] * len(sizes))
        must_equal(f"mesh join scan {sizes[:4]} Q={nq}",
                   scan_exact_mesh(*jargs), scan_exact_mesh_ref(*jargs))
        cases += 2
    for sizes, k in (((0, 40, 41), 30), ((3001, 3000, 2999, 3000), 500),
                     ((0, 0, 0), 3), ((1001,) * 17, 300)):
        n = sum(sizes)
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, max(n, 1), k, k, k, dev)
        fi, ai, ji, fvi, jvi = mesh_islands(
            [t[:n] for t in (f, a, j, fv, jv)], sizes)
        for nr in (0, 1, 3, 4097):
            for nq in (1, 3, 9, 65):
                bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7)
                                     for i in range(nq - 1)]
                vb = (EDGE_VBOUNDS * 8)[:nq]
                ca = corr_stack(gen, dev, 6, nr)
                cj = corr_stack(gen, dev, 6, nr + 2 if nr else 0, 0, 5000)
                args = (fi, ai, fvi, [ad] * len(sizes), bounds)
                must_equal(f"mesh group {sizes[:4]} nr={nr} Q={nq}",
                           scan_exact_mesh(*args, corr_a=ca, vbounds=vb),
                           scan_exact_mesh_ref(*args, corr_a=ca, vbounds=vb))
                jargs = args + (ji, jvi, [rc] * len(sizes), ca, cj, vb)
                must_equal(f"mesh join group {sizes[:4]} nr={nr} Q={nq}",
                           scan_exact_mesh(*jargs),
                           scan_exact_mesh_ref(*jargs))
                cases += 2
    return cases


def measure_scan_mesh(gen, dev, shape, join: bool) -> dict:
    """At (N, W, k[, kj], Q, nr_a[, nr_j]), the N islands on the one card:
    `ms` the bare launches (one a group of up to 16 islands, with the adds
    of other devices' partials: none here), with the correction slice over
    stacks of nr_a (and nr_j) rows where they are not 0, and then
    `base_ms` / `base_device_ms` the same launches without it;
    `wrapper_ms` through the wrapper."""
    from repro_torch.kernels.dict_ops import (launch_scan_exact_mesh,
                                              mesh_launch_groups,
                                              scan_exact_mesh,
                                              scan_exact_mesh_ref)
    n_isl, width, k, kj, nq, nr_a, nr_j = mesh_shape(shape, join)
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n_isl * width, k, k,
                                          max(kj, 1), dev, invalid=0.0)
    fi, ai, ji, fvi, jvi = mesh_islands((f, a, j, fv, jv), [width] * n_isl)
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (ji, jvi, [rc] * n_isl) if join else ()
    corr = None
    if nr_a or nr_j:
        cj = corr_stack(gen, dev, 6, nr_j, 0, 1 << 24, extremes=False) \
            if join else None
        corr = dict(corr_a=corr_stack(gen, dev, 6, nr_a, 0, 1 << 24,
                                      extremes=False),
                    corr_j=cj, vbounds=delta_vbounds(nq))
    ckw = corr or {}
    args = (fi, ai, fvi, [ad] * n_isl, bounds) + extra
    err = must_equal(f"mesh scan {shape}", scan_exact_mesh(*args, **ckw),
                     scan_exact_mesh_ref(*args, **ckw))
    islands = [(fi[s], ai[s], fvi[s].view(torch.uint8), ad) + (
        (ji[s], jvi[s].view(torch.uint8), rc) if join else ())
        for s in range(n_isl)]
    groups = mesh_launch_groups([dev] * n_isl, [width] * n_isl)
    barrs = {dev: torch.tensor(bounds, dtype=torch.int32, device=dev)}
    outs = {dev: torch.zeros((3 if join else 2, nq), dtype=torch.int64,
                             device=dev)}

    def bare(with_corr=corr):
        return launch_scan_exact_mesh(islands, groups, barrs, outs, with_corr)
    every = scan_instances()
    keys = [island_key(int(join), 0, join_qn(nq) if join else 8)]
    if corr:
        keys.append(island_key(int(join), 1, join_qn(nq)))
    out = dict(max_abs_err=err, launches_a_call=len(groups),
               instances={key: every[key] for key in keys},
               ms=time_ms(bare, 50), **device_time(bare),
               wrapper_ms=time_ms(lambda: scan_exact_mesh(*args, **ckw), 20),
               plain_ms=time_ms(lambda: scan_exact_mesh_ref(*args, **ckw), 3),
               library_ms=None)
    if corr:
        base = device_time(lambda: bare(None))
        out.update(base_ms=time_ms(lambda: bare(None), 50),
                   base_device_ms=base["device_ms"])
    return out


def probe_table(gen, dev, n_keys, lo=-(1 << 24), hi=1 << 24):
    """A bucket table over `n_keys` distinct keys (negative ones too), its
    keys on the card, and their values."""
    from repro_torch.kernels.hash_probe import build_table
    keys = torch.randperm(hi - lo, generator=gen, device=dev)[:n_keys] + lo
    keys = keys.to(torch.int32)
    vals = torch.randint(0, 1 << 20, (n_keys,), generator=gen, device=dev,
                         dtype=torch.int32)
    return build_table(keys.cpu().numpy(), vals.cpu().numpy()), keys


def probe_queries(gen, keys, n):
    """n queries, half of them keys of the table, half random misses."""
    hits = keys[torch.randint(0, max(len(keys), 1), (n - n // 2,),
                              generator=gen, device=keys.device)]
    miss = torch.randint(-(1 << 24), 1 << 24, (n // 2,), generator=gen,
                         device=keys.device, dtype=torch.int32)
    return torch.cat([hits, miss])


def edge_probe(gen, dev) -> int:
    """Negative keys, the int32 extremes, a query equal to EMPTY (it hits
    the free slots: 0), misses, one key, a large table, ragged islands."""
    from repro_torch.kernels.hash_probe import (EMPTY, build_table, probe,
                                                probe_ref, probe_sharded)
    cases = 0
    for n_keys, n_q in ((1, 5), (37, 1000), (25_133, 1_000_000)):
        table, keys = probe_table(gen, dev, n_keys)
        q = probe_queries(gen, keys, n_q)
        q[:3] = torch.tensor([EMPTY, -1, 0], dtype=torch.int32, device=dev)
        kt, vt = table.on(dev)
        must_equal(f"probe {n_keys} keys", probe(table, q, default=-9),
                   probe_ref(kt, vt, q, -9))
        parts = [q[:0], q[:3], q[3:700], q[:64]]
        for g, part in zip(probe_sharded(table, parts, default=-9), parts):
            must_equal(f"sharded probe {n_keys} keys", g,
                       probe_ref(kt, vt, part, -9))
        cases += 2
    ext = np.asarray([2**31 - 1, -2**31 + 1, 5, -5], dtype=np.int32)
    table = build_table(ext, np.arange(4, dtype=np.int32) + 1)
    q = torch.tensor([2**31 - 1, -2**31 + 1, EMPTY, -5, 6], dtype=torch.int32,
                     device=dev)
    kt, vt = table.on(dev)
    got = probe(table, q)
    must_equal("probe extremes", got, probe_ref(kt, vt, q, -1))
    if got.tolist() != [1, 2, 0, 4, -1]:
        raise AssertionError(f"probe extremes: {got.tolist()}")
    return cases + 1


def measure_probe(gen, dev, shape) -> dict:
    """At the recorded (S, W, n_buckets, slots): a table of the same bucket
    count (n_buckets // 2 keys at the builder's load factor), W queries per
    island. Also the sharded form at four islands of the same width."""
    from repro_torch.kernels.hash_probe import (launch_hash_probe, probe,
                                                probe_ref, probe_sharded)
    n_shards, width, n_buckets, _ = shape
    table, keys = probe_table(gen, dev, max(1, n_buckets // 2))
    kt, vt = table.on(dev)
    q = probe_queries(gen, keys, n_shards * width).reshape(n_shards, width)
    flat = q.reshape(-1) if n_shards == 1 else q
    got = probe(table, flat) if n_shards == 1 else \
        torch.stack(probe_sharded(table, list(q)))
    err = must_equal(f"probe {shape}", got, probe_ref(kt, vt, flat, -1))
    out = torch.empty_like(flat)
    skeys = torch.sort(keys).values
    four = list(probe_queries(gen, keys, 4 * width).reshape(4, width))
    sh_err = max(must_equal(f"sharded probe {shape}", g,
                            probe_ref(kt, vt, p, -1))
                 for g, p in zip(probe_sharded(table, four), four))
    stack4 = torch.stack(four)
    out4 = torch.empty_like(stack4)
    return dict(max_abs_err=err, slots_measured=int(kt.shape[1]),
                host_us=probe_host_costs(table, flat.reshape(-1), kt, vt,
                                         out.reshape(-1), skeys),
                ms=time_ms(lambda: launch_hash_probe(flat, kt, vt, -1, out),
                           200),
                **device_time(lambda: launch_hash_probe(flat, kt, vt, -1,
                                                        out)),
                wrapper_ms=time_ms(lambda: probe(table, flat.reshape(-1)),
                                   200),
                plain_ms=time_ms(lambda: probe_ref(kt, vt, flat, -1), 50),
                library_ms=time_ms(lambda: torch.searchsorted(skeys, flat),
                                   200),
                sharded=dict(
                    shape=[4, width, int(kt.shape[0]), int(kt.shape[1])],
                    max_abs_err=sh_err,
                    ms=time_ms(lambda: launch_hash_probe(stack4, kt, vt, -1,
                                                         out4), 200),
                    wrapper_ms=time_ms(lambda: probe_sharded(table, four),
                                       200),
                    plain_ms=time_ms(lambda: probe_ref(kt, vt, stack4, -1),
                                     50)))


HOST_REPS = 10_000


def host_us(fn) -> float:
    """Microseconds of the host's clock per call of `fn` over HOST_REPS
    calls (after one warm-up; the card is synchronised after the loop, not
    inside it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / HOST_REPS * 1e6


def probe_host_costs(table, q, kt, vt, out, skeys) -> dict:
    """The host's cost of one probe launch at the path's shape, item by
    item: what `build.launch` and the wrapper `probe` do, each in a loop of
    its own; beside them what the first design did instead (a device guard
    and a `torch.cuda.Stream` object a launch) and `torch.searchsorted`."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import check_tensor, count_launch, on_gpu
    from repro_torch.kernels.hash_probe import launch_hash_probe, probe
    fn = build.entry("hash_probe")
    idx = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    shape = (1, q.shape[0]) + tuple(kt.shape)

    def arguments():
        return (q.data_ptr(), 1, q.shape[-1], kt.data_ptr(), vt.data_ptr(),
                kt.shape[0], kt.shape[1], -1, out.data_ptr())

    args = arguments() + (stream,)

    def checks():
        table.on(q.device)
        on_gpu(q)
        check_tensor(q, torch.int32, "queries", 1)

    def old_guard():
        with torch.cuda.device(q.device):
            pass

    return dict(
        reps=HOST_REPS,
        ctypes_call_and_launch=host_us(lambda: fn(*args)),
        stream_lookup=host_us(
            lambda: torch._C._cuda_getCurrentRawStream(idx)),
        device_check=host_us(torch._C._cuda_getDevice),
        arguments=host_us(arguments),
        bare_launch=host_us(lambda: launch_hash_probe(q, kt, vt, -1, out)),
        checks=host_us(checks),
        allocation=host_us(lambda: torch.empty_like(q)),
        count_launch=host_us(lambda: count_launch("hash_probe", shape)),
        wrapper=host_us(lambda: probe(table, q)),
        first_design_guard=host_us(old_guard),
        first_design_stream=host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        library_searchsorted=host_us(lambda: torch.searchsorted(skeys, q)))


def sorted_runs(gen, dev, rows, w, lo=-2**62, hi=2**62):
    k = torch.randint(lo, hi, (rows, w), generator=gen, device=dev,
                      dtype=torch.int64)
    return torch.sort(k, dim=1).values


def kway_runs(gen, dev, lens, lo=-2**62, hi=2**62):
    """Ascending int64 runs of `lens` entries on the card."""
    return [torch.sort(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                     dtype=torch.int64)).values
            for n in lens]


def edge_merge(gen, dev) -> int:
    from repro_torch.kernels.merge_runs import (MAX_RUNS, merge_pair_ref,
                                                merge_runs_ref,
                                                merge_sorted_pair,
                                                merge_sorted_pairs,
                                                merge_sorted_runs)
    cases = 0
    for rows, wa, wb in ((1, 1, 1), (1, 512, 512), (3, 1000, 7), (8, 0, 33),
                         (2, 40_000, 1024)):
        a, b = sorted_runs(gen, dev, rows, wa), sorted_runs(gen, dev, rows, wb)
        if wa and wb:    # equal keys across runs, and the int64 extremes
            b[:, 0] = a[:, 0]
            a[:, -1] = 2**63 - 1
            b[:, -1] = 2**63 - 1
            a[0, 0] = -2**63
            a, b = torch.sort(a, dim=1).values, torch.sort(b, dim=1).values
        ai = torch.arange(wa, device=dev, dtype=torch.int32).repeat(rows, 1)
        bi = wa + torch.arange(wb, device=dev, dtype=torch.int32).repeat(rows, 1)
        must_equal(f"merge {rows}x({wa}+{wb})", merge_sorted_pair(a, b, ai, bi),
                   merge_pair_ref(a, b, ai, bi))
        cases += 1
    # the k-way merge, bit for bit against the stable sort of the
    # concatenation: empty runs, one-entry runs, equal keys across runs
    # (narrow key ranges), int64.max and int64.min, shared-memory inputs and
    # ones too large for it (over 4,096 keys), more runs than one launch
    for k, lens, lo, hi in (
            (1, (300,), -5, 5), (2, (1, 0), 0, 1), (2, (700, 300), -20, 20),
            (3, (0, 1, 500), -3, 3), (4, (256, 256, 255, 257), 0, 2**40),
            (4, (3000, 2000, 1, 0), -100, 100), (7, (0, 9, 1, 64, 0, 33, 2),
                                                 -9, 9),
            (8, (1300,) * 8, 0, 500), (MAX_RUNS + 6, (17,) * (MAX_RUNS + 6),
                                       -50, 50)):
        runs = kway_runs(gen, dev, lens, lo, hi)
        for i, r in enumerate(runs):
            if r.numel() > 1:
                r[-1] = 2**63 - 1
                if i % 2:
                    r[0] = -2**63
        got = merge_sorted_runs(runs, device=dev)
        must_equal(f"merge k={k} {lens[:8]}", got, merge_runs_ref(runs))
        cases += 1
    # host runs (commit ids beyond 2^31) copied to the card by the wrapper
    host = [np.sort(np.random.default_rng(i).integers(2**31, 2**40, size=s))
            for i, s in enumerate((257, 0, 300, 255, 1))]
    keys, src = merge_sorted_runs(host, device=dev)
    cat = np.concatenate(host)
    order = np.argsort(cat, kind="stable")
    must_equal("merge host runs", (keys, src),
               (torch.from_numpy(cat[order]).to(dev),
                torch.from_numpy(order.astype(np.int32)).to(dev)))
    pairs = merge_sorted_pairs([host[0], host[2]], [host[3], host[4]],
                               device=dev)
    for got, (x, y) in zip(pairs, ((host[0], host[3]), (host[2], host[4]))):
        must_equal("merge pairs", got,
                   torch.from_numpy(np.sort(np.concatenate([x, y]))).to(dev))
    return cases + 2


SHIP_MERGE = (4, 1024)     # a ship batch: four thread logs of about 256


def measure_merge(gen, dev, shape) -> dict:
    """(k, n): the k-way merge of k runs of about n / k commit-id-like
    keys: `ms` the bare launch, `wrapper_ms` `merge_sorted_runs` on the
    card's runs, `plain_ms` its plain version, `library_ms` one
    `torch.sort(cat, stable=True)`. (rows, wa, wb): the row-wise pair
    merge (no library call returns its index lane as one call)."""
    from repro_torch.kernels.merge_runs import (launch_merge_kway,
                                                launch_merge_runs,
                                                merge_pair_ref,
                                                merge_runs_ref,
                                                merge_sorted_pair,
                                                merge_sorted_runs,
                                                run_offsets)
    if len(shape) == 2:
        k, n = shape
        lens = [n // k + (r < n % k) for r in range(k)]
        runs = kway_runs(gen, dev, lens, 0, 2**40)
        want = merge_runs_ref(runs)
        err = must_equal(f"merge {shape}", merge_sorted_runs(runs), want)
        cat = torch.cat(runs)
        offs = run_offsets(lens)
        ok, oi = torch.empty_like(cat), torch.empty(n, dtype=torch.int32,
                                                    device=dev)
        return dict(max_abs_err=err, runs=lens[:8],
                    ms=time_ms(lambda: launch_merge_kway(cat, offs, ok, oi),
                               200),
                    **device_time(lambda: launch_merge_kway(cat, offs, ok,
                                                            oi)),
                    wrapper_ms=time_ms(lambda: merge_sorted_runs(runs), 200),
                    plain_ms=time_ms(lambda: merge_runs_ref(runs), 200),
                    library_ms=time_ms(
                        lambda: torch.sort(cat, stable=True), 200),
                    library="torch.sort(cat, stable=True)")
    rows, wa, wb = shape
    a = sorted_runs(gen, dev, rows, wa, 0, 2**40)
    b = sorted_runs(gen, dev, rows, wb, 0, 2**40)
    ai = torch.arange(wa, device=dev, dtype=torch.int32).repeat(rows, 1)
    bi = wa + torch.arange(wb, device=dev, dtype=torch.int32).repeat(rows, 1)
    args = (a, b, ai, bi)
    err = must_equal(f"merge {shape}", merge_sorted_pair(*args),
                     merge_pair_ref(*args))
    ok, oi = merge_sorted_pair(*args)
    return dict(max_abs_err=err,
                ms=time_ms(lambda: launch_merge_runs(a, ai, b, bi, ok, oi), 200),
                **device_time(lambda: launch_merge_runs(a, ai, b, bi, ok, oi)),
                wrapper_ms=time_ms(lambda: merge_sorted_pair(*args), 200),
                plain_ms=time_ms(lambda: merge_pair_ref(*args), 50),
                library_ms=None)


def rand_i32(gen, dev, rows, w):
    return torch.randint(-2**31, 2**31 - 1, (rows, w), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)


def apply_stacks(gen, dev, rows, n_old, w_old, n_val, w_val):
    """Sentinel-padded (old dictionaries, update values) of a ship batch."""
    old = torch.full((rows, w_old), I32_MAX, dtype=torch.int32, device=dev)
    old[:, :n_old] = torch.sort(rand_i32(gen, dev, rows, n_old), dim=1).values
    val = torch.full((rows, w_val), I32_MAX, dtype=torch.int32, device=dev)
    val[:, :n_val] = rand_i32(gen, dev, rows, n_val)
    val[:, 0] = old[:, 0]                        # a value already present
    return old, val


def edge_bitonic(gen, dev) -> int:
    from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                                  apply_pipeline_batch_ref,
                                                  sort_rows, sort_rows_ref)
    cases = 0
    for rows, w in ((1, 1), (1, 5), (8, 1024), (3, 1000), (2, 32768),
                    (2, 70_000), (1, 200_001)):  # wider than one tile
        x = rand_i32(gen, dev, rows, w)
        x[0, 0] = I32_MAX
        x[0, -1] = -2**31
        must_equal(f"sort {rows}x{w}", sort_rows(x), sort_rows_ref(x))
        cases += 1
    for rows, w in ((1, 7), (3, 1000), (2, 70_000)):   # float32, NaN last
        x = torch.randn((rows, w), generator=gen, device=dev) * 1e6
        x[:, 0], x[:, 1], x[:, 2] = float("nan"), float("inf"), -0.0
        x[:, -1] = float("-inf")
        torch.testing.assert_close(sort_rows(x), sort_rows_ref(x), rtol=0,
                                   atol=0, equal_nan=True)
        cases += 1
    # the tile merge: values sorted in every merge block up to 2,048 (w_val
    # 1, 2,048), the separate sort above (4,096; 65,536 with pairwise
    # merges), old widths that are not a multiple of a tile (4,096 slots) or
    # of 4, a row of sentinels only, values all equal to an old key,
    # int32.min, 1 and 65 rows, the path's (8, 32,768, 256)
    for rows, n_old, w_old, n_val, w_val, case in (
            (1, 1, 8, 1, 8, None), (8, 32, 32, 100, 128, None),
            (2, 5000, 8192, 1024, 1024, None),
            (3, 40_000, 65536, 700, 1024, None),
            (2, 100, 128, 40_000, 65536, None),
            (3, 40, 64, 1, 1, None), (2, 5000, 8192, 2000, 2048, None),
            (2, 6000, 8192, 3000, 4096, None),
            (3, 4500, 5003, 200, 256, None), (2, 4000, 4097, 20, 32, None),
            (3, 300, 512, 50, 64, "old_sentinels_only"),
            (4, 300, 512, 60, 64, "values_equal_an_old_key"),
            (2, 300, 512, 70, 128, "int32_min"),
            (1, 9000, 16384, 100, 128, None), (65, 90, 128, 20, 32, None),
            (8, 24_000, 32768, 200, 256, None)):
        old, val = apply_stacks(gen, dev, rows, n_old, w_old, n_val, w_val)
        if case == "old_sentinels_only":
            old[0] = I32_MAX
        elif case == "values_equal_an_old_key":
            val[:, :n_val] = old[:, n_old // 2:n_old // 2 + 1]
        elif case == "int32_min":
            val[:, 1] = I32_MIN
            old[:, 0] = I32_MIN
        must_equal(f"apply {rows}x({w_old}+{w_val}) {case or ''}",
                   apply_pipeline_batch(old, val),
                   apply_pipeline_batch_ref(old, val))
        cases += 1
    # the tile merge alone (K6): runs of any lengths, float32 keys with NaN
    from repro_torch.kernels.bitonic_sort import (launch_merge_rows,
                                                  merge_rows_ref)
    for rows, wa, wb, w_out, dtype in ((1, 1, 1, 2, torch.int32),
                                       (3, 5000, 7, 8192, torch.int32),
                                       (2, 0, 33, 40, torch.int32),
                                       (2, 32768, 32768, 65536, torch.int32),
                                       (3, 4099, 3001, 9000, torch.float32)):
        if dtype == torch.int32:
            a = torch.sort(rand_i32(gen, dev, rows, wa), dim=1).values
            b = torch.sort(rand_i32(gen, dev, rows, wb), dim=1).values
        else:
            a = torch.randn((rows, wa), generator=gen, device=dev)
            b = torch.randn((rows, wb), generator=gen, device=dev)
            a[:, :3] = float("nan")
            b[:, 1] = a[:, 7]
            a, b = torch.sort(a, dim=1).values, torch.sort(b, dim=1).values
        out = torch.empty((rows, w_out), dtype=dtype, device=dev)
        launch_merge_rows(a.data_ptr(), wa, wa, b.data_ptr(), wb, wb, out,
                          w_out, w_out, rows)
        torch.testing.assert_close(out, merge_rows_ref(a, b, w_out), rtol=0,
                                   atol=0, equal_nan=True)
        cases += 1
    return cases


def measure_sort(gen, dev, shape) -> dict:
    from repro_torch.kernels.bitonic_sort import (MAX_TILE, launch_sort_rows,
                                                  sort_rows, sort_rows_ref)
    rows, width = shape
    x = rand_i32(gen, dev, rows, width)
    err = must_equal(f"sort {shape}", sort_rows(x), sort_rows_ref(x))
    out = torch.empty((rows, next_pow2(width)), dtype=torch.int32,
                      device=dev)
    scratch = torch.empty_like(out) if out.shape[1] > MAX_TILE else None

    def bare():          # the wrapper's one call of the C entry
        launch_sort_rows(x, out, scratch)
    return dict(max_abs_err=err, ms=time_ms(bare, 200), **device_time(bare),
                wrapper_ms=time_ms(lambda: sort_rows(x), 200),
                plain_ms=time_ms(lambda: sort_rows_ref(x), 50),
                library_ms=time_ms(lambda: torch.sort(x, dim=1), 50))


def measure_apply(gen, dev, shape) -> dict:
    from repro_torch.kernels.bitonic_sort import (MAX_TILE,
                                                  apply_pipeline_batch,
                                                  apply_pipeline_batch_ref,
                                                  launch_bitonic_apply)
    rows, w_old, w_val = shape
    # buckets are powers of two above the real lengths: fill three quarters
    old, val = apply_stacks(gen, dev, rows, max(1, 3 * w_old // 4), w_old,
                            max(1, 3 * w_val // 4), w_val)
    err = must_equal(f"apply {shape}", apply_pipeline_batch(old, val),
                     apply_pipeline_batch_ref(old, val))
    svals, merged = apply_pipeline_batch(old, val)
    scratch = torch.empty_like(val) if w_val > MAX_TILE else None

    def bare():          # the wrapper's one call of the C entry
        launch_bitonic_apply(old, val, svals, merged, scratch)
    return dict(max_abs_err=err, ms=time_ms(bare, 100), **device_time(bare),
                wrapper_ms=time_ms(lambda: apply_pipeline_batch(old, val),
                                   100),
                plain_ms=time_ms(lambda: apply_pipeline_batch_ref(old, val),
                                 20),
                library_ms=None)


def merge_rows_cost(shape):
    """(rows, wa, wb): both runs read, the merged row written (int32); a
    compare, a select and a move a slot (a merge's least work)."""
    rows, wa, wb = shape
    return rows * (wa + wb) * 8, rows * (wa + wb) * 3


def measure_merge_rows(gen, dev, shape) -> dict:
    """K6, the tile merge alone, at (rows, wa, wb) int32 runs: `ms` the
    bare launch, `library_ms` one `torch.sort` of the concatenated runs,
    `plain_ms` the plain version (the same sort with the output width's
    padding). No public wrapper: the sort's pairwise merges call it."""
    from repro_torch.kernels.bitonic_sort import (launch_merge_rows,
                                                  merge_rows_ref)
    rows, wa, wb = shape
    a = torch.sort(rand_i32(gen, dev, rows, wa), dim=1).values
    b = torch.sort(rand_i32(gen, dev, rows, wb), dim=1).values
    out = torch.empty((rows, wa + wb), dtype=torch.int32, device=dev)

    def bare():
        launch_merge_rows(a.data_ptr(), wa, wa, b.data_ptr(), wb, wb, out,
                          wa + wb, wa + wb, rows)
    bare()
    err = must_equal(f"merge rows {shape}", out, merge_rows_ref(a, b, wa + wb))
    cat = torch.cat([a, b], dim=1)
    return dict(max_abs_err=err, ms=time_ms(bare, 100), **device_time(bare),
                wrapper_ms=None,
                plain_ms=time_ms(lambda: merge_rows_ref(a, b, wa + wb), 20),
                library_ms=time_ms(lambda: torch.sort(cat, dim=1), 20),
                library="torch.sort(cat(a, b), dim=1)")


def edge_snapshot(gen, dev) -> int:
    from repro_torch.kernels.snapshot_copy import (snapshot_copy,
                                                   snapshot_copy_ref)
    cases = 0
    for n in (1, 8192, 8193, 100_000, 3 * 8192 + 5):
        nc = (n + 8191) // 8192
        src = torch.randint(0, 1000, (n + 1,), generator=gen, device=dev,
                            dtype=torch.int32)
        prev = torch.randint(0, 1000, (n + 1,), generator=gen, device=dev,
                             dtype=torch.int32)
        for dirty in (torch.zeros(nc, dtype=torch.bool, device=dev),
                      torch.ones(nc, dtype=torch.bool, device=dev),
                      torch.rand(nc, generator=gen, device=dev) < 0.5):
            for off in (0, 1):                   # off=1: unaligned pointers
                s, p = src[off:n + off], prev[off:n + off]
                must_equal(f"snapshot n={n} off={off}",
                           snapshot_copy(s, p, dirty),
                           snapshot_copy_ref(s, p, dirty))
                cases += 1
        must_equal("snapshot int32 flags",
                   snapshot_copy(src[:n], prev[:n], dirty.to(torch.int32)),
                   snapshot_copy_ref(src[:n], prev[:n], dirty))
        cases += 1
    return cases


def measure_snapshot(gen, dev, shape) -> dict:
    """Half the chunks dirty: the copy moves the same bytes whatever the
    flags say (a chunk is read from one side and written once)."""
    from repro_torch.kernels.snapshot_copy import (launch_snapshot_copy,
                                                   snapshot_copy,
                                                   snapshot_copy_ref)
    n, block = shape
    nc = (n + block - 1) // block
    src = torch.randint(0, 25_000, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    prev = torch.randint(0, 25_000, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    dirty = torch.rand(nc, generator=gen, device=dev) < 0.5
    args = (src, prev, dirty, block)
    err = must_equal(f"snapshot {shape}", snapshot_copy(*args),
                     snapshot_copy_ref(*args))
    mask = torch.repeat_interleave(dirty, block)[:n]
    res = torch.empty_like(src)
    flags = dirty.view(torch.uint8)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: launch_snapshot_copy(src, prev, flags, res, block),
                   50),
        **device_time(lambda: launch_snapshot_copy(src, prev, flags, res,
                                                   block)),
        wrapper_ms=time_ms(lambda: snapshot_copy(*args), 20),
        plain_ms=time_ms(lambda: snapshot_copy_ref(*args), 5),
        library_ms=time_ms(lambda: torch.where(mask, src, prev), 20))


def values_cost(shape, rows=6):
    """(nr, Q): the stack read once, bounds in, (2, Q) int64 out; per row
    and predicate two compares, a select and an add per triple."""
    nr, nq = shape
    return nr * rows * 4 + nq * 8 + 2 * nq * 8, nr * nq * 4 * (rows // 3)


def group_cost(shape, kind):
    """The base scan's cost plus the correction lane's over its stack(s)
    and the output's one more row."""
    if kind == "flat":
        *base, nr = shape
        nbytes, ops = scan_cost(tuple(base))
        stacks = (nr,)
    elif kind == "sharded":
        *base, nr = shape
        nbytes, ops = scan_sharded_cost(tuple(base), False)
        stacks = (nr,)
    elif kind == "join":
        *base, nr_a, nr_j = shape
        nbytes, ops = scan_cost(tuple(base))
        stacks = (nr_a, nr_j)
    else:
        *base, nr_a, nr_j = shape
        nbytes, ops = scan_sharded_cost(tuple(base), True)
        stacks = (nr_a, nr_j)
    nq = base[-1]
    for nr in stacks:
        b, o = values_cost((nr, nq))
        nbytes, ops = nbytes + b - 2 * nq * 8, ops + o
    return nbytes + (3 if kind.startswith("join") else 2) * nq * 8, ops


EDGE_VBOUNDS = [(I32_MIN, I32_MAX), (5, -5), (0, I32_MAX), (-1000, 1000),
                (I32_MIN, I32_MIN), (-7, 7), (100, 900), (-900, -100), (0, 0)]


def corr_stack(gen, dev, rows, nr, lo=-1000, hi=1000, extremes=True):
    """A (rows, nr) int32 correction stack: values in [lo, hi) (and the
    int32 ends), validity lanes 0/1."""
    x = torch.randint(lo, hi, (rows, nr), generator=gen, device=dev,
                      dtype=torch.int32)
    if extremes and nr:
        x[0, 0], x[1, 0] = I32_MIN, I32_MAX
        if rows == 6:
            x[3, 0], x[4, 0] = I32_MAX, I32_MIN
    for r in (2, 5)[:rows // 3]:
        x[r] = torch.rand(nr, generator=gen, device=dev) < 0.8
    return x


def edge_delta(gen, dev) -> int:
    """The correction lane alone (3- and 6-row stacks) and fused with the
    flat, the sharded (3 and 4 islands, padded slots), the join and the
    sharded join scans:
    stacks of 0, 1, 3 and 4097 rows, negative and int32-extreme values,
    empty ranges, hi = int32.max, Q of 1, 3 and 9 (two predicate
    slices)."""
    from repro_torch.kernels.dict_ops import (scan_exact_group,
                                              scan_exact_group_ref,
                                              scan_values_exact,
                                              scan_values_exact_ref)
    cases = 0
    n, k = 65_537, 40
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, k, dev)
    for nr in (0, 1, 3, 4097):
        for nq in (1, 3, 9):
            vb = EDGE_VBOUNDS[-nq:] if nq == 3 else EDGE_VBOUNDS[:nq]
            for rows in (3, 6):
                st = corr_stack(gen, dev, rows, nr)
                must_equal(f"values lane {rows}x{nr} Q={nq}",
                           scan_values_exact(st, vb),
                           scan_values_exact_ref(st, vb))
                cases += 1
            bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7)
                                 for i in range(nq - 1)]
            ca = corr_stack(gen, dev, 6, nr)
            cj = corr_stack(gen, dev, 6, nr + 2 if nr else 0, 0, 5000)
            off = nr % 2                        # odd: unaligned pointers
            args = (f[off:], a[off:], fv[off:], ad, bounds, ca, vb)
            must_equal(f"group nr={nr} Q={nq}", scan_exact_group(*args),
                       scan_exact_group_ref(*args))
            jargs = args + (j[off:], jv[off:], rc, cj)
            must_equal(f"join group nr={nr} Q={nq}",
                       scan_exact_group(*jargs), scan_exact_group_ref(*jargs))
            for sizes in ((21_846, 21_846, 21_845), (16_385,) * 4):
                m = sum(sizes)
                lay = [stacked(t[:m], sizes) for t in (f, a, fv, j, jv)]
                sargs = (lay[0], lay[1], lay[2], ad, bounds, ca, vb)
                must_equal(f"sharded group {len(sizes)} nr={nr} Q={nq}",
                           scan_exact_group(*sargs),
                           scan_exact_group_ref(*sargs))
                jsargs = sargs + (lay[3], lay[4], rc, cj)
                must_equal(f"sharded join group {len(sizes)} nr={nr} "
                           f"Q={nq}", scan_exact_group(*jsargs),
                           scan_exact_group_ref(*jsargs))
            cases += 6
    for nq in (1, 9, 17):           # more rows than one pass of the grid
        st = corr_stack(gen, dev, 6, 300_001)
        vb = (EDGE_VBOUNDS * 2)[:nq]
        must_equal(f"values lane 6x300001 Q={nq}", scan_values_exact(st, vb),
                   scan_values_exact_ref(st, vb))
        cases += 1
    return cases


JOIN_LANE_QS = (1, 2, 8, 9, 17)


def edge_join_lane(gen, dev) -> int:
    """The join lane's passes bit for bit: Q = 1 (its one-predicate pass),
    2 and 8 (the wide pass), 9 and 17 (a second and a third grid slice of
    8); flat views at row offsets 0 - 3 (16-byte loads after 0 - 3 head
    rows) of 1, 3, 4,101 and 1,000,003 rows, columns at different offsets
    (read a row at a time), shards 1,001 wide (each after the first starts
    off a 16-byte boundary), and the join group with empty and one-row
    correction stacks; about 10 % of the rows are fvalid but not
    jvalid."""
    from repro_torch.kernels.dict_ops import (scan_exact, scan_exact_group,
                                              scan_exact_group_ref,
                                              scan_exact_ref)
    cases = 0
    k = 5000
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, 1_000_003 + 4, k, k, k, dev)
    ad[0], ad[-1] = I32_MIN, I32_MAX
    ad = torch.sort(ad).values
    cols = (f, a, fv, j, jv)
    for nq in JOIN_LANE_QS:
        lows = torch.randint(0, k, (nq,), generator=gen, device=dev).tolist()
        bounds = ([(0, k), (7, 7)] + [(lo, lo + 1 + (i * 37) % k)
                                      for i, lo in enumerate(lows)])[:nq]
        vb = (EDGE_VBOUNDS * 2)[:nq]

        def check(what, view, corr=None):
            f_, a_, fv_, j_, jv_ = view
            args = (f_, a_, fv_, ad, bounds, j_, jv_, rc)
            if corr is None:
                must_equal(f"join lane {what} Q={nq}", scan_exact(*args),
                           scan_exact_ref(*args))
            else:
                gargs = (f_, a_, fv_, ad, bounds, corr[0], vb, j_, jv_, rc,
                         corr[1])
                must_equal(f"join group {what} Q={nq}",
                           scan_exact_group(*gargs),
                           scan_exact_group_ref(*gargs))
        for n in (1, 3, 4101, 1_000_003):
            for off in range(4):
                check(f"n={n} off={off}",
                      [t[off:off + n] for t in cols])
                cases += 1
        n = 65_537                       # every column at its own offset
        check("columns at offsets 1, 2, 3, 0, 1",
              [t[o:o + n] for t, o in zip(cols, (1, 2, 3, 0, 1))])
        sizes = (1001, 1000, 999)
        check(f"shards {sizes}",
              [stacked(t[:sum(sizes)], sizes) for t in cols])
        cases += 2
        for nr in (0, 1):
            corr = (corr_stack(gen, dev, 6, nr),
                    corr_stack(gen, dev, 6, nr, 0, 5000))
            for off in (0, 3):
                check(f"stacks of {nr} n=4101 off={off}",
                      [t[off:off + 4101] for t in cols], corr)
                cases += 1
    return cases


def delta_vbounds(nq):
    """Q inclusive ranges over the workload's value domain, ~30 % each."""
    dom = 1 << 24
    return [((q * dom) // (nq + 1), (q * dom) // (nq + 1) + 3 * dom // 10)
            for q in range(nq)]


def measure_group(gen, dev, shape, kind) -> dict:
    """At a recorded shape: the fused kernel (`ms`, the bare launch), the
    same launch without the correction lane (`base_ms`: the flat, sharded
    or join scan alone over the same columns), the wrapper and the plain
    version."""
    from repro_torch.kernels.dict_ops import (launch_scan_exact,
                                              scan_exact_group,
                                              scan_exact_group_ref)
    join = kind.startswith("join")
    if kind == "sharded":
        n_shards, width, k, nq, nr = shape
        n = n_shards * width
    elif kind == "join_sharded":
        n_shards, width, k, kj, nq, nr, nr_j = shape
        n = n_shards * width
    elif join:
        n, k, kj, nq, nr, nr_j = shape
    else:
        n, k, nq, nr = shape
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, kj if join else 1,
                                          dev, invalid=0.0)
    if kind.endswith("sharded"):
        f, a, fv, j, jv = (t.reshape(n_shards, width)
                           for t in (f, a, fv, j, jv))
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    vb = delta_vbounds(nq)
    ca = corr_stack(gen, dev, 6, nr, 0, 1 << 24, extremes=False)
    extra = ()
    if join:
        extra = (j, jv, rc, corr_stack(gen, dev, 6, nr_j, 0, 1 << 24,
                                       extremes=False))
    args = (f, a, fv, ad, bounds, ca, vb) + extra
    err = must_equal(f"{kind} group {shape}", scan_exact_group(*args),
                     scan_exact_group_ref(*args))
    slices = 1 if f.dim() == 1 else f.shape[0]
    lanes = 3 if join else 2
    res = torch.zeros((slices + 1, lanes, nq), dtype=torch.int64, device=dev)
    base_res = torch.zeros((slices, lanes, nq), dtype=torch.int64,
                           device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    vbarr = torch.tensor(vb, dtype=torch.int32, device=dev)
    cols = (f, a, fv.view(torch.uint8), ad, barr)
    jl = (j, jv.view(torch.uint8), rc) if join else ()
    def bare():
        launch_scan_exact(*cols, res, *jl, corr_a=ca,
                          corr_j=extra[3] if join else None,
                          vbounds_dev=vbarr)
    return dict(
        max_abs_err=err,
        **({"instances": join_instances(nq)} if join else {}),
        ms=time_ms(bare, 50), **device_time(bare),
        base_ms=time_ms(lambda: launch_scan_exact(*cols, base_res, *jl), 50),
        base_device_ms=device_time(
            lambda: launch_scan_exact(*cols, base_res, *jl))["device_ms"],
        wrapper_ms=time_ms(lambda: scan_exact_group(*args), 20),
        plain_ms=time_ms(lambda: scan_exact_group_ref(*args), 3),
        library_ms=None)


def measure_values(gen, dev, shape, rows) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_values,
                                              scan_values_exact,
                                              scan_values_exact_ref)
    nr, nq = shape
    st = corr_stack(gen, dev, rows, nr, 0, 1 << 24, extremes=False)
    vb = delta_vbounds(nq)
    err = must_equal(f"values lane {rows}x{shape}", scan_values_exact(st, vb),
                     scan_values_exact_ref(st, vb))
    res = torch.zeros((2, nq), dtype=torch.int64, device=dev)
    vbarr = torch.tensor(vb, dtype=torch.int32, device=dev)
    def bare():
        launch_scan_values(st, vbarr, res)
    return dict(max_abs_err=err,
                instances={values_key(v): scan_instances()[values_key(v)]
                           for v in (1, 8)},
                ms=time_ms(bare, 200), **device_time(bare),
                wrapper_ms=time_ms(lambda: scan_values_exact(st, vb), 200),
                plain_ms=time_ms(lambda: scan_values_exact_ref(st, vb), 20),
                library_ms=None)


def measure_values_delta(gen, dev, shape) -> dict:
    """The values delta at its recorded shape; beside it the raw-value scan
    (the same kernel over a 3-row stack), which no path launches, at the
    same made-up shape."""
    m = measure_values(gen, dev, shape, 6)
    m["raw_value_scan"] = with_bound(measure_values(gen, dev, shape, 3),
                                     shape, 0,
                                     roofline_ms(values_cost(shape, 3)))
    return m


# -- the float32 scan, flash-decode attention, the selective scan ----------

def float_scan_cost(shape):
    """(n, k): each row's 9 bytes read once, the (1,) sum and count out; a
    gather of 4 bytes per selected row is data-dependent and not counted;
    two compares, an and, a convert and an add per row."""
    n, k = shape
    return n * 9 + 8, n * 5


def edge_float_scan(gen, dev) -> int:
    """Ragged tails, one row, views at row offsets 0 - 3 (16-byte loads
    after 0 - 3 head rows), columns at different offsets (a row at a time),
    an empty range; every call twice, the two sums bit for bit one."""
    from repro_torch.kernels.dict_ops import (scan_filter_agg,
                                              scan_filter_agg_float_ref)
    cases = 0
    for n, k in ((1, 3), (3, 7), (255, 40), (257, 1000),
                 (1_000_003, 50_000)):
        f, a, _, fv, _, ad, _ = scan_inputs(gen, n + 3, k, k, 1, dev)
        views = [(o, o, o) for o in range(4)] + [(1, 2, 0)]
        for fo, ao, vo in views:
            fc, ac, vv = f[fo:fo + n], a[ao:ao + n], fv[vo:vo + n]
            for lo, hi in ((0, k), (k // 3, k // 2 + 1), (1, 1)):
                cols_pred = (fc, ac, vv, ad, lo, hi)
                name = f"float scan n={n} offsets {fo},{ao},{vo}"
                got = scan_filter_agg(*cols_pred, exact=False)
                again = scan_filter_agg(*cols_pred, exact=False)
                if not (torch.equal(got[0].view(torch.int32),
                                    again[0].view(torch.int32))
                        and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{name}: two calls differ: "
                                         f"{got} and {again}")
                float_scan_check(
                    name, got, scan_filter_agg_float_ref(*cols_pred),
                    scan_filter_agg(*cols_pred), abs_sum(*cols_pred), n, dev)
                cases += 1
    return cases


def measure_float_scan(gen, dev, shape) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_float,
                                              scan_filter_agg,
                                              scan_filter_agg_float_ref)
    from repro_torch.kernels.dict_ops.ops import (float_scan_counter,
                                                  float_scan_parts)
    n, k = shape
    f, a, _, fv, _, ad, _ = scan_inputs(gen, n, k, k, 1, dev, invalid=0.0)
    lo, hi = k // 4, k // 4 + max(1, 3 * k // 10)   # about 30 % of rows
    s, c = scan_filter_agg(f, a, fv, ad, lo, hi, exact=False)
    es, ec = scan_filter_agg(f, a, fv, ad, lo, hi)
    rel = float_scan_check(f"float scan {shape}", (s, c),
                           scan_filter_agg_float_ref(f, a, fv, ad, lo, hi),
                           (es, ec), abs_sum(f, a, fv, ad, lo, hi), n, dev)
    parts = float_scan_parts(dev, n)
    psum = torch.empty(parts, dtype=torch.float32, device=dev)
    pcnt = torch.empty(parts, dtype=torch.int32, device=dev)
    out_s = torch.empty(1, dtype=torch.float32, device=dev)
    out_c = torch.empty(1, dtype=torch.int32, device=dev)
    counter = float_scan_counter(dev)
    fvu = fv.view(torch.uint8)

    def bare():
        launch_scan_float(f, a, fvu, ad, lo, hi, psum, pcnt, counter, out_s,
                          out_c)
    return dict(
        max_abs_err=abs(float(s) - es), rel_err=rel,
        tolerance=FLOAT_SCAN_TOL, parts=parts,
        instances={float_key(v): scan_instances()[float_key(v)]
                   for v in (0, 1)},
        ms=time_ms(bare, 50), **device_time(bare),
        wrapper_ms=time_ms(lambda: scan_filter_agg(f, a, fv, ad, lo, hi,
                                                   exact=False), 20),
        plain_ms=time_ms(lambda: scan_filter_agg_float_ref(f, a, fv, ad, lo,
                                                           hi), 3),
        library_ms=None)


def decode_cost(shape, kv_bytes=2, q_bytes=2):
    """(B, S, H, Hkv, d, length): the valid prefix of K and V read once
    (slots past `length` are never read), q in, out written; a dot product
    and an update of the output (two multiply-adds) per (head, slot,
    element), a softcap and an exponential per (head, slot)."""
    B, S, H, Hkv, d, length = shape
    nbytes = 2 * B * length * Hkv * d * kv_bytes + 2 * B * H * d * q_bytes
    return nbytes, B * H * length * (4 * d + 8)


def decode_inputs(gen, dev, shape, q_dtype, kv_dtype):
    B, S, H, Hkv, d, length = shape
    q = torch.randn((B, H, d), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(kv_dtype)
    v = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(kv_dtype)
    return q, k, v


def edge_decode(gen, dev) -> int:
    """Ragged S, length 1 and length = S, G 1 to 8, d 16 to 256 (kimi-k2's
    112 with G 8 and whisper's 64 with G 1 among them), softcap on and
    off, a full rolling cache (S = window = length), a float32 and a bf16
    cache (float32 queries: the plain version up-casts the cache), then
    bf16 queries and output."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    cases = 0
    for shape, cap in (((2, 1000, 8, 8, 128, 1), 0.0),
                       ((3, 777, 10, 2, 128, 777), 50.0),
                       ((1, 4097, 56, 8, 128, 3001), 0.0),
                       ((2, 9, 4, 2, 64, 5), 30.0),
                       ((1, 300, 8, 1, 256, 300), 0.0),
                       ((2, 4096, 16, 8, 256, 4096), 50.0),   # rolling, full
                       ((1, 5000, 28, 4, 128, 4999), 0.0),    # G 7
                       ((2, 1001, 64, 8, 112, 1), 50.0),      # kimi-k2: d 112
                       ((1, 777, 64, 8, 112, 777), 0.0),
                       ((3, 4099, 64, 8, 112, 2050), 50.0),
                       ((4, 4096, 8, 8, 64, 287), 50.0),      # whisper: G 1
                       ((3, 1500, 8, 8, 64, 1500), 0.0),
                       ((2, 300, 4, 2, 16, 300), 30.0),       # smoke configs
                       ((1, 97, 8, 8, 16, 1), 0.0),
                       ((2, 513, 12, 4, 48, 400), 50.0),
                       ((1, 2000, 24, 8, 96, 1999), 0.0),
                       ((1, 65, 8, 2, 240, 64), 50.0)):
        B, S, H, Hkv, d, length = shape
        for kv in (torch.float32, torch.bfloat16):
            q, k, v = decode_inputs(gen, dev, shape, torch.float32, kv)
            want = decode_attention_ref(q, k, v, length, d ** -0.5, cap)
            must_be_close(f"decode {shape} cap={cap} {kv}",
                          decode_attention(q, k, v, length, softcap=cap),
                          want, 2e-5)
            cases += 1
        q = q.bfloat16()                    # the serving path's types
        must_be_close_bf16(f"decode {shape} cap={cap} bf16 q",
                           decode_attention(q, k, v, length, softcap=cap),
                           decode_attention_ref(q.float(), k, v, length,
                                                d ** -0.5, cap))
        cases += 1
    return cases


def measure_decode(gen, dev, shape) -> dict:
    """Checked against the plain version with float32 queries (2e-5) and
    at the path's types, bf16 queries and cache (one bf16 rounding more),
    then timed at the path's types; with the split plan (splits, the
    resident blocks of one wave, waves), the achieved rate and ptxas'
    registers of the instance that ran."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref,
                                                 launch_decode_attention)
    from repro_torch.kernels.decode_attn.ops import (resident_blocks,
                                                     split_counters,
                                                     split_plan)
    import torch.nn.functional as F
    B, S, H, Hkv, d, length = shape
    cap = 50.0
    q, k, v = decode_inputs(gen, dev, shape, torch.float32, torch.bfloat16)
    err = must_be_close(f"decode {shape}",
                        decode_attention(q, k, v, length, softcap=cap),
                        decode_attention_ref(q, k, v, length, d ** -0.5, cap),
                        2e-5)
    q = q.bfloat16()
    err_bf16 = must_be_close_bf16(
        f"decode {shape} bf16 q", decode_attention(q, k, v, length,
                                                   softcap=cap),
        decode_attention_ref(q.float(), k, v, length, d ** -0.5, cap))
    out = torch.empty_like(q)
    G = H // Hkv
    resident = resident_blocks(dev, True, True, d, G)
    ns, chunk = split_plan(length, B, Hkv, resident)
    pm = torch.empty(B * H * ns, dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pa = torch.empty(B * H * ns * d, dtype=torch.float32, device=dev)
    cnt = split_counters(dev, B * Hkv)
    scale = d ** -0.5
    q4 = q[:, :, None, :]
    kl = k[:, :length].transpose(1, 2)
    vl = v[:, :length].transpose(1, 2)
    def bare():
        launch_decode_attention(q, k, v, length, out, scale, cap, ns, chunk,
                                pm, pl, pa, cnt)
    ms = time_ms(bare, 50)
    return dict(
        max_abs_err=err, tolerance=2e-5, max_abs_err_bf16=err_bf16,
        tolerance_bf16=f"{BF16_OUT_RTOL} relative plus {BF16_OUT_ATOL}",
        splits=ns, chunk=chunk, resident_blocks=resident,
        waves=ns * B * Hkv / resident,
        registers=decode_registers().get("bf16 cache, bf16 q"),
        ms=ms, **device_time(bare),
        achieved_GBps=decode_cost(shape)[0] / ms / 1e6,
        wrapper_ms=time_ms(lambda: decode_attention(q, k, v, length,
                                                    softcap=cap), 20),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, length, scale,
                                                      cap), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kl, vl, enable_gqa=True), 20),
        library="F.scaled_dot_product_attention, softcap 0, on the valid "
                "prefix (a transposed view of the cache)")


def ssm_inputs(gen, dev, shape):
    B, T, D, N = shape
    x = torch.randn((B, T, D), generator=gen, device=dev)
    dt = torch.randn((B, T, D), generator=gen, device=dev).abs() * 0.1
    a = -torch.randn((D, N), generator=gen, device=dev).abs()
    b = torch.randn((B, T, N), generator=gen, device=dev)
    c = torch.randn((B, T, N), generator=gen, device=dev)
    d = torch.randn((D,), generator=gen, device=dev)
    return x, dt, a, b, c, d


def ssm_instance(n, gated, elem) -> str:
    """The key of a selective-scan instance from its mangled template
    arguments: "N<d_state>", and " gated bf16" or " gated f32" for the
    gated form's."""
    kind = "bf16" if "bfloat16" in elem else "f32"
    return f"N{n}" + (f" gated {kind}" if gated == "1" else "")


def ssm_registers(backward: bool = False) -> dict[str, dict]:
    """ptxas' registers and spill bytes of each selective-scan instance, by
    d_state, form (plain or gated, and the gated form's element type) and
    staging (16-byte or element copies); of the backward's, by d_state and
    form."""
    out = {}
    for entry, n in REGISTERS.items():
        if backward:
            m = re.search(r"selective_scan_bwd_kernelILi(\d+)ELb([01])E"
                          r"(\w+?)E", entry)
            key = m and ssm_instance(m.group(1), m.group(2), m.group(3))
        else:
            m = re.search(r"selective_scan_kernelILi(\d+)ELb([01])ELb([01])E"
                          r"(\w+?)E", entry)
            key = m and (ssm_instance(m.group(1), m.group(3), m.group(4))
                         + f" {'16B' if m.group(2) == '1' else 'element'}")
        if m:
            out[key] = dict(registers=n, spill_bytes=SPILLS.get(entry, 0))
    return out


SSM_EDGES = ((1, 1, 1, 4), (2, 257, 100, 8), (3, 1000, 130, 16),
             (1, 33, 8192, 16), (4, 31, 4096, 4),
             # falcon-mamba-7b's prefill; D not a multiple of a block's 32
             # channels (16-byte staging), and D % 4 != 0 (4-byte staging)
             (4, 2048, 8192, 16), (2, 300, 8200, 16), (2, 129, 4101, 8))


def edge_ssm(gen, dev) -> int:
    """T and D not multiples of the tiles, one step, one channel, N 4, 8
    and 16, the prefill's shape."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_ref)
    for shape in SSM_EDGES:
        args = ssm_inputs(gen, dev, shape)
        must_be_close(f"selective scan {shape}", selective_scan(*args),
                      selective_scan_ref(*args), 3e-5)
    return len(SSM_EDGES)


def measure_ssm(gen, dev, shape) -> dict:
    """Held to 3e-5, then timed."""
    from repro_torch.kernels.selective_scan import (launch_selective_scan,
                                                    selective_scan,
                                                    selective_scan_ref)
    args = ssm_inputs(gen, dev, shape)
    t0 = time.perf_counter()
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = must_be_close(f"selective scan {shape}", selective_scan(*args),
                        want, 3e-5)
    y = torch.empty_like(args[0])
    out = dict(
        max_abs_err=err, tolerance=3e-5,
        ms=time_ms(lambda: launch_selective_scan(*args, y), 10),
        **device_time(lambda: launch_selective_scan(*args, y)),
        wrapper_ms=time_ms(lambda: selective_scan(*args), 10),
        plain_ms=plain_ms, library_ms=None, registers=ssm_registers())
    del args, want, y
    return dict(out, gated=measure_ssm_gated(gen, dev, shape))


SSM_BWD_TOL = 1e-4     # of each gradient's largest |value|


def ssm_bwd_check(name, got, want) -> float:
    """Each of the six gradients within SSM_BWD_TOL of the plain version's
    largest |value| (sums over T, B and D in other orders); returns the
    largest absolute difference."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: gradient {i} shape "
                                 f"{tuple(g.shape)} != {tuple(w.shape)}")
        e = float((g - w).abs().max()) if g.numel() else 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        if not e <= SSM_BWD_TOL * scale:
            raise AssertionError(
                f"kernel check {name!r}: gradient {i} differs from its "
                f"plain version (max abs err {e}, tolerance {SSM_BWD_TOL} x "
                f"{scale})")
        err = max(err, e)
    return err


def ssm_bwd_repeatable(name, args, got) -> None:
    """A second identical call gives identical bits (no float atomics)."""
    from repro_torch.kernels.selective_scan import selective_scan_bwd
    again = selective_scan_bwd(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"kernel check {name!r}: two identical calls "
                             "gave different bits")


def ssm_bwd_inputs(gen, dev, shape):
    x = ssm_inputs(gen, dev, shape)
    return (*x, torch.randn(x[0].shape, generator=gen, device=dev))


def edge_ssm_bwd(gen, dev) -> int:
    """The backward at the forward's edge shapes, bit for bit repeatable."""
    from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                    selective_scan_bwd_ref)
    for shape in SSM_EDGES:
        args = ssm_bwd_inputs(gen, dev, shape)
        got = selective_scan_bwd(*args)
        name = f"selective scan backward {shape}"
        ssm_bwd_check(name, got, selective_scan_bwd_ref(*args))
        ssm_bwd_repeatable(name, args, got)
    return len(SSM_EDGES)


def measure_ssm_bwd(gen, dev, shape) -> dict:
    """Held to SSM_BWD_TOL and bit for bit repeatable, then timed."""
    from repro_torch.kernels.selective_scan import (
        BWD_LANES, launch_selective_scan_bwd, selective_scan_bwd,
        selective_scan_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import _bwd_buffers
    B, T, D, N = shape
    args = ssm_bwd_inputs(gen, dev, shape)
    t0 = time.perf_counter()
    want = selective_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = selective_scan_bwd(*args)
    name = f"selective scan backward {shape}"
    err = ssm_bwd_check(name, got, want)
    ssm_bwd_repeatable(name, args, got)
    del got, want
    bufs = (torch.empty_like(args[0]), torch.empty_like(args[0]),
            *_bwd_buffers(B, T, D, N, dev))
    return dict(
        max_abs_err=err, tolerance=f"{SSM_BWD_TOL} x each gradient's max "
                                   "|value|", bitwise_repeatable=True,
        ms=time_ms(lambda: launch_selective_scan_bwd(*args, *bufs), 10),
        **device_time(lambda: launch_selective_scan_bwd(*args, *bufs)),
        wrapper_ms=time_ms(lambda: selective_scan_bwd(*args), 10),
        plain_ms=plain_ms, library_ms=None,
        scratch_bytes=sum(b.numel() * 4 for b in bufs[2:]),
        registers=ssm_registers(backward=True), lanes=BWD_LANES[N])


# The gated scan (`selective_scan_gated`, what Mamba's block calls): dt's
# bias and softplus before the scan and the silu(z) gate after it, in the
# gated instances of the scan and of its backward, against the same chain
# in float32 on the same operands (`selective_scan_gated_f32`,
# `selective_scan_gated_bwd_ref`), each output there rounded once.

def ssm_gated_inputs(gen, dev, shape, dtype=torch.bfloat16):
    """Mamba's operands at `shape` (B, T, D, N): x, dt_raw (about -2.5,
    so dt about 0.08), dt_bias and z of `dtype`, z the second half of a
    (B, T, 2 D) projection; a, b, c, d float32; and an upstream gradient g
    of `dtype`."""
    B, T, D, N = shape
    x, _, a, b, c, d = ssm_inputs(gen, dev, shape)
    raw = torch.randn((B, T, D), generator=gen, device=dev) - 2.5
    bias = torch.randn((D,), generator=gen, device=dev) * 0.3
    xz = torch.randn((B, T, 2 * D), generator=gen, device=dev).to(dtype)
    g = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
    return (x.to(dtype), raw.to(dtype), bias.to(dtype), a, b, c, d,
            xz.chunk(2, dim=-1)[1]), g


def rounding(dtype) -> float:
    """One ulp of `dtype`, relative: 2**-7 in bf16; in float32 a few ulps
    of the float32 work."""
    return 2**-7 if dtype == torch.bfloat16 else 1e-6


def gated_fwd_check(name, args, y, y_pre) -> float:
    """The gated forward's y and y_pre against the float32 chain: y_pre
    within the scan's 3e-5 (relative plus absolute) and one ulp of the
    output's type; y the same, the scan's part scaled by |silu(z)|.
    Returns the largest absolute difference of y."""
    from repro_torch.kernels.selective_scan import selective_scan_gated_f32
    want, pre = selective_scan_gated_f32(*args)
    z = args[7].float()
    silu = z * torch.sigmoid(z)
    r = rounding(y.dtype)
    err = 0.0
    for what, got, w, tol in (
            ("y_pre", y_pre, pre, r * pre.abs() + 3e-5 * (1 + pre.abs())),
            ("y", y, want, r * want.abs()
             + 3e-5 * (1 + pre.abs()) * silu.abs())):
        if got.dtype != args[0].dtype or got.shape != w.shape:
            raise AssertionError(f"kernel check {name!r}: {what} is "
                                 f"{got.dtype} {tuple(got.shape)}")
        diff = (got.float() - w).abs()
        if got.numel() and not bool((diff <= tol + 1e-30).all()):
            raise AssertionError(
                f"kernel check {name!r}: {what} differs from the float32 "
                f"chain (max abs err {float(diff.max())}, over the "
                f"tolerance by {float((diff - tol).max())})")
        if what == "y" and got.numel():
            err = float(diff.max())
    return err


SSM_GATED_BWD_NAMES = ("gx", "g_raw", "gbias", "ga", "gb", "gc", "gd", "gz")


def gated_bwd_check(name, got, want) -> float:
    """The gated backward's eight gradients against the float32 plain
    version on the same operands and y_pre: each within SSM_BWD_TOL of
    its largest |value| (the scan's sums in other orders; gz, which needs
    no sum, 1e-6) plus an ulp of its type (both sides rounded once).
    Returns the largest absolute difference."""
    err = 0.0
    for what, g, w in zip(SSM_GATED_BWD_NAMES, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel check {name!r}: {what} is "
                                 f"{g.dtype} {tuple(g.shape)}, not "
                                 f"{w.dtype} {tuple(w.shape)}")
        if not g.numel():
            continue
        gf, wf = g.float(), w.float()
        scale = float(wf.abs().max())
        tol = ((1e-6 if what == "gz" else SSM_BWD_TOL) * scale
               + rounding(g.dtype) * wf.abs())
        diff = (gf - wf).abs()
        if not bool((diff <= tol + 1e-30).all()):
            raise AssertionError(
                f"kernel check {name!r}: gradient {what} differs from its "
                f"plain version (max abs err {float(diff.max())}, scale "
                f"{scale})")
        err = max(err, float(diff.max()))
    return err


def gated_case(name, args, g) -> None:
    """One gated case: forward and backward checked, the backward twice
    bit for bit, the launches counted under the plain kernels' names."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_gated_bwd, selective_scan_gated_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import _gated_forward_gpu
    y, y_pre = _gated_forward_gpu(*args, True)
    gated_fwd_check(name, args, y, y_pre)
    got = selective_scan_gated_bwd(*args, y_pre, g)
    gated_bwd_check(f"{name} backward", got,
                    selective_scan_gated_bwd_ref(*args, y_pre, g))
    again = selective_scan_gated_bwd(*args, y_pre, g)
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"kernel check {name!r}: two identical "
                             "backward calls gave different bits")


def edge_ssm_gated(gen, dev) -> int:
    """The gated forms at the scan's edge shapes (`SSM_EDGES`), bf16 and
    float32, z the in-projection's strided half; in bf16 also z as a
    contiguous copy and a view one element off a 4-byte boundary (the
    element-wise staging)."""
    from repro_torch.kernels.common import (kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    cases = 0
    for shape in SSM_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            args, g = ssm_gated_inputs(gen, dev, shape, dtype)
            reset_kernel_launch_counts()
            gated_case(f"gated scan {shape} {dtype}", args, g)
            if kernel_launch_shapes() != {
                    "selective_scan": {tuple(shape): 1},
                    "selective_scan_bwd": {tuple(shape): 2}}:
                raise AssertionError(f"gated scan {shape}: launches "
                                     f"{kernel_launch_shapes()}")
            cases += 1
        B, T, D, N = shape
        args, g = ssm_gated_inputs(gen, dev, shape)
        wide = torch.randn((B, T, D + 1), generator=gen, device=dev).to(
            torch.bfloat16)
        for layout, z in (("contiguous z", args[7].contiguous()),
                          ("odd z", wide[..., 1:])):
            gated_case(f"gated scan {shape} {layout}", (*args[:7], z), g)
            cases += 1
    return cases


def measure_ssm_gated(gen, dev, shape) -> dict:
    """The gated forms in bf16 at `shape`, z the in-projection's strided
    half: checked, then timed forward (``forward``) and backward
    (``backward``): the bare launch (``ms``, ``device_ms``), the
    benchmark's bound of the plain kernel at the shape (its yardstick
    counts the gated form's launches so), and the chain the gated form
    replaced (``chain_ms``, ``chain_device_ms``: the bf16 softplus of the
    biased projection, float32 copies, the plain kernel, y back to bf16,
    times silu(z); backward, autograd through it, the plain kernel's
    backward included)."""
    import torch.nn.functional as F
    from repro_torch.kernels.selective_scan import (
        launch_selective_scan_gated, launch_selective_scan_gated_bwd,
        selective_scan, selective_scan_gated_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import (_bwd_buffers,
                                                         _gated_forward_gpu)
    B, T, D, N = shape
    card = card_sfu()
    args, g = ssm_gated_inputs(gen, dev, shape)
    y, y_pre = _gated_forward_gpu(*args, True)
    err = gated_fwd_check(f"gated scan {shape}", args, y, y_pre)
    parts = _bwd_buffers(B, T, D, N, dev)
    # gx, g_raw, gz, ga .. gd partials, the bias's partials, ckpt
    bufs = (*(torch.empty_like(y) for _ in range(3)), *parts[:4],
            torch.empty((B, D), dtype=torch.float32, device=dev), parts[4])
    launch_selective_scan_gated_bwd(*args, y_pre, g, *bufs)
    got = (bufs[0], bufs[1],
           bufs[7].sum(0).to(args[2].dtype), *(p.sum(0) for p in bufs[3:7]),
           bufs[2])
    bwd_err = gated_bwd_check(f"gated scan backward {shape}", got,
                              selective_scan_gated_bwd_ref(*args, y_pre, g))
    del got

    def f32(t):
        return t.to(torch.float32).contiguous()

    def chain(x, raw, bias, a, b, c, d, z):
        dt = F.softplus(raw + bias)
        out = selective_scan(f32(x), f32(dt), f32(a), f32(b), f32(c),
                             f32(d))
        return out.to(x.dtype) * (z * torch.sigmoid(z))

    def fwd():
        launch_selective_scan_gated(*args, y, y_pre)

    def bwd():
        launch_selective_scan_gated_bwd(*args, y_pre, g, *bufs)
    forward = dict(max_abs_err=err, ms=time_ms(fwd, 10), **device_time(fwd),
                   bound_ms=least_ms("selective_scan", shape, card)[0])
    with torch.no_grad():
        forward.update(chain_ms=time_ms(lambda: chain(*args), 10),
                       chain_device_ms=device_time(
                           lambda: chain(*args))["device_ms"])
    backward = dict(max_abs_err=bwd_err, ms=time_ms(bwd, 10),
                    **device_time(bwd),
                    bound_ms=least_ms("selective_scan_bwd", shape, card)[0])
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in args]
    out = chain(*leaves)

    def chain_bwd():
        torch.autograd.grad(out, leaves, g, retain_graph=True)
    backward.update(chain_ms=time_ms(chain_bwd, 10),
                    chain_device_ms=device_time(chain_bwd)["device_ms"])
    regs = ssm_registers()
    bwd_regs = ssm_registers(backward=True)
    return dict(forward=dict(forward, registers={
                    k: v for k, v in regs.items() if "gated bf16" in k}),
                backward=dict(backward, registers={
                    k: v for k, v in bwd_regs.items() if "gated" in k}),
                dtype="bfloat16", z="the in-projection's strided half")


# The blocked attention: shapes are the wrappers' `launch_shape`, (B, Sq,
# Skv, H, Hkv, dh, causal, window, softcap).

FLASH_TOL = 2e-4             # float32: the reference's own flash-vs-SDPA
                             # tolerance (tests/test_kernels.py:191-206)
FLASH_BWD_TOL = 1e-4         # float32 gradients, of each one's max |value|
FLASH_BWD_TOL_BF16 = 2**-7 + FLASH_BWD_TOL    # bf16: one bf16 step more


def flash_flops(shape, products: int) -> float:
    """2 dh flops a product for each pair in the band, head and sequence."""
    B, Sq, Skv, H, Hkv, dh, causal, window, _ = shape
    return 2.0 * products * dh * B * H * band_pairs(Sq, Skv, causal, window)


def flash_cost(shape):
    """At the paths' bf16: q, k, v read once, out and the float32 lse
    written once; QK^T and PV on the pairs in the band. It ranks the
    shapes; the bound is the benchmark's (`least_ms`)."""
    B, Sq, Skv, H, Hkv, dh = shape[:6]
    nbytes = 2 * (2 * B * Sq * H * dh + 2 * B * Skv * Hkv * dh) \
        + 4 * B * H * Sq
    return nbytes, flash_flops(shape, 2)


def flash_bwd_cost(shape):
    """One backward call (both launches) at bf16: q, k, v, out, dout and
    lse read once, dq, dk, dv and D written once; five products on the
    pairs in the band (QK^T again, dO V^T, P^T dO, dS K, dS^T Q)."""
    B, Sq, Skv, H, Hkv, dh = shape[:6]
    nbytes = 2 * (4 * B * Sq * H * dh + 4 * B * Skv * Hkv * dh) \
        + 8 * B * H * Sq
    return nbytes, flash_flops(shape, 5)


def flash_inputs(gen, dev, shape, dtype=torch.bfloat16):
    B, Sq, Skv, H, Hkv, dh = shape[:6]
    return (torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(dtype),
            *(torch.randn((B, Skv, Hkv, dh), generator=gen,
                          device=dev).to(dtype) for _ in range(2)))


def flash_kw(shape) -> dict:
    causal, window, cap = shape[6:]
    return dict(causal=bool(causal), window=int(window), softcap=float(cap))


def flash_blocks(q, k) -> dict:
    """The plain versions' blocks for these lengths: their defaults where
    they divide the lengths, else one block a length."""
    Sq, Skv = q.shape[1], k.shape[1]
    return dict(q_block=256 if Sq % 256 == 0 else Sq,
                kv_block=1024 if Skv % 1024 == 0 else Skv)


FLASH_PASSES = ("fwd", "bwd_dq", "bwd_dkdv")
FLASH_PATH_DH = (64, 128, 256)   # whisper's, Jamba's and gemma2's


def flash_key(entry: str) -> str | None:
    """The blocked-attention instance a kernel entry is, by pass, head_dim
    and type ("fwd d64 bf16"), if it is one: the bf16 tensor-core kernels
    (``flash_*_wgmma_kernel<DH>``) and the float32 FMA kernels
    (``flash_*_kernel<DH, BR, BC, float>``)."""
    m = re.search(r"flash_(fwd|bwd_dq|bwd_dkdv)_(?:wgmma_)?kernelILi(\d+)E",
                  entry)
    if not m:
        return None
    return (f"{m.group(1)} d{m.group(2)} "
            f"{'bf16' if 'bfloat16' in entry else 'f32'}")


def flash_registers() -> dict[str, dict]:
    """ptxas' registers and spill bytes of each blocked-attention instance,
    by pass, head_dim and type."""
    out = {}
    for entry, n in REGISTERS.items():
        key = flash_key(entry)
        if key:
            out[key] = dict(registers=n, spill_bytes=SPILLS.get(entry, 0))
    return out


def sass_text(library) -> str:
    """`cuobjdump -sass` of the built library (the tool beside nvcc)."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout


def flash_sass(text: str) -> dict[str, dict]:
    """Per blocked-attention instance in `cuobjdump -sass` output: its
    HGMMA (``wgmma``) and HMMA (``mma.sync``) instructions."""
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = flash_key(m.group(1))
            if key:
                out[key] = dict(HGMMA=0, HMMA=0)
        elif key:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    out[key][op] += 1
    return out


def flash_build_check(instances: dict) -> None:
    """Raises unless every bf16 blocked-attention instance (three passes x
    four head_dims) issues HGMMA or HMMA, the forward at the paths'
    head_dims HGMMA, and no bf16 instance at the paths' head_dims spills
    (where ptxas' report was read: a library this process built)."""
    want = {f"{p} d{d} bf16" for p in FLASH_PASSES for d in (64, 112, 128,
                                                           256)}
    bad = {k: "not in the SASS" for k in want - instances.keys()}
    for key in want & instances.keys():
        got = instances[key]
        d = int(key.split()[1][1:])
        if not (got.get("HGMMA") or got.get("HMMA")):
            bad[key] = "no HGMMA or HMMA"
        elif key.startswith("fwd ") and d in FLASH_PATH_DH and \
                not got.get("HGMMA"):
            bad[key] = "no HGMMA"
        elif d in FLASH_PATH_DH and got.get("spill_bytes"):
            bad[key] = f"{got['spill_bytes']} bytes of spill"
    if bad:
        raise AssertionError(f"blocked attention's bf16 instances: {bad}")


def flash_fwd_check(name, got, lse, q, k, v, kw) -> float:
    """The kernel's output and log-sum-exp against the plain version's:
    float32 within FLASH_TOL relative plus absolute; a bf16 output against
    the plain version's float32 answer on the same bf16 values by
    `must_be_close_bf16`. Returns the output's largest difference."""
    from repro_torch.kernels.flash_attn import flash_attention_fwd_ref
    want, want_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                             **kw, **flash_blocks(q, k))
    must_be_close(f"{name} lse", lse, want_lse, FLASH_TOL)
    if q.dtype == torch.bfloat16:
        return must_be_close_bf16(name, got, want)
    return must_be_close(name, got, want, FLASH_TOL)


def flash_bwd_check(name, got, want) -> float:
    """dq, dk, dv within FLASH_BWD_TOL (bf16: FLASH_BWD_TOL_BF16) of the
    plain version's largest |value| each; returns the largest absolute
    difference."""
    err = 0.0
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        tol = FLASH_BWD_TOL_BF16 if w.dtype == torch.bfloat16 else \
            FLASH_BWD_TOL
        g, w = g.float(), w.float()
        if g.shape != w.shape:
            raise AssertionError(f"{name}: {what} shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        e, scale = float((g - w).abs().max()), float(w.abs().max())
        if not e <= tol * scale:
            raise AssertionError(
                f"kernel check {name!r}: {what} differs from its plain "
                f"version (max abs err {e}, tolerance {tol} x {scale})")
        err = max(err, e)
    return err


def flash_bwd_run(name, q, k, v, kw, gen) -> tuple:
    """The backward at these inputs against its plain version and bit for
    bit repeatable; returns (the largest difference, the inputs of a call:
    q, k, v, out, lse, dout)."""
    from repro_torch.kernels.flash_attn import (flash_attention_bwd,
                                                flash_attention_bwd_ref,
                                                flash_attention_fwd)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device=q.device).to(q.dtype)
    args = (q, k, v, out, lse, dout)
    got = flash_attention_bwd(*args, **kw)
    err = flash_bwd_check(name, got, flash_attention_bwd_ref(
        *args, **kw, **flash_blocks(q, k)))
    if not all(torch.equal(a, b) for a, b in
               zip(got, flash_attention_bwd(*args, **kw))):
        raise AssertionError(f"kernel check {name!r}: two identical calls "
                             "gave different bits")
    return err, args


# (B, Sq, Skv, H, Hkv, dh, causal, window, softcap): each in float32 and bf16
FLASH_EDGES = (
    (2, 300, 300, 8, 8, 64, 1, 0, 0),        # whisper's heads, ragged tiles
    (2, 1000, 1500, 8, 8, 64, 0, 0, 0),      # the cross form: Sq != Skv
    (1, 8192, 8192, 16, 8, 256, 1, 4096, 50),  # gemma2's heads, a window
                                             # shorter than S: whole leading
                                             # tiles masked
    (1, 4096, 2048, 16, 8, 256, 1, 0, 50),   # causal with Sq > Skv
    (1, 777, 777, 64, 8, 112, 1, 0, 50),     # kimi-k2's heads: d 112, G 8
    (2, 513, 513, 40, 8, 128, 1, 100, 0),    # llama4-scout's: d 128, G 5
    (1, 200, 333, 5, 1, 128, 0, 0, 30),      # G 5 over one KV head
)


def edge_flash(gen, dev) -> int:
    """The forward and the backward at FLASH_EDGES in float32 and bf16."""
    from repro_torch.kernels.flash_attn import flash_attention_fwd
    cases = 0
    for shape in FLASH_EDGES:
        kw = flash_kw(shape)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, dev, shape, dtype)
            name = f"blocked attention {shape} {dtype}"
            flash_fwd_check(name, *flash_attention_fwd(q, k, v, **kw),
                            q, k, v, kw)
            flash_bwd_run(f"{name} backward", q, k, v, kw, gen)
            cases += 2
    return cases


# whisper-large-v3's three attentions at a micro-batch of 16 clips (bf16, as
# its training runs them): the encoder's bidirectional 1,500, the
# decoder's causal 448, the cross 448 x 1,500
WHISPER_FLASH = ((16, 1500, 1500, 20, 20, 64, 0, 0, 0),
                 (16, 448, 448, 20, 20, 64, 1, 0, 0),
                 (16, 448, 1500, 20, 20, 64, 0, 0, 0))
# tail lengths: under one tile, a tile and one short or over, whisper's
FLASH_TAILS = (1, 63, 65, 449, 1500)


def single_key(shape) -> bool:
    """Whether every query row has one key in its band (Skv 1, or Sq 1
    under the causal mask): the softmax is then 1 whatever the scores, and
    dq and dk are 0 in exact arithmetic."""
    return shape[2] == 1 or (bool(shape[6]) and shape[1] == 1)


def flash_bwd_single_key(name, q, k, v, kw, gen) -> float:
    """The backward where `single_key` holds: dv against the plain version
    as `flash_bwd_check` holds it, dq and dk (both sides' are rounding
    noise about 0) within the same share of dv's largest |value|, the
    call's gradient scale. Returns the largest difference."""
    from repro_torch.kernels.flash_attn import (flash_attention_bwd,
                                                flash_attention_bwd_ref,
                                                flash_attention_fwd)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device=q.device).to(q.dtype)
    args = (q, k, v, out, lse, dout)
    dq, dk, dv = flash_attention_bwd(*args, **kw)
    want = flash_attention_bwd_ref(*args, **kw, **flash_blocks(q, k))
    err = flash_bwd_check(name, [dv], [want[2]])
    tol = (FLASH_BWD_TOL_BF16 if q.dtype == torch.bfloat16 else
           FLASH_BWD_TOL) * float(want[2].float().abs().max())
    for g, what in ((dq, "dq"), (dk, "dk")):
        e = float(g.float().abs().max())
        if not e <= tol:
            raise AssertionError(f"kernel check {name!r}: {what} is {e} "
                                 f"where it is 0 (tolerance {tol})")
        err = max(err, e)
    return err


def edge_flash_whisper(gen, dev) -> int:
    """The forward and the backward at WHISPER_FLASH (bf16) and at every
    pair of Sq and Skv in FLASH_TAILS, causal and not, in float32 and
    bf16 at whisper's heads (B 1, 4 heads of 64), against the plain
    versions (`flash_fwd_check`; `flash_bwd_run`, or where each row has a
    single key `flash_bwd_single_key`)."""
    from repro_torch.kernels.flash_attn import flash_attention_fwd
    shapes = [(sh, torch.bfloat16) for sh in WHISPER_FLASH]
    shapes += [((1, sq, skv, 4, 4, 64, causal, 0, 0), dtype)
               for sq in FLASH_TAILS for skv in FLASH_TAILS
               for causal in (0, 1)
               for dtype in (torch.float32, torch.bfloat16)]
    for shape, dtype in shapes:
        kw = flash_kw(shape)
        q, k, v = flash_inputs(gen, dev, shape, dtype)
        name = f"blocked attention {shape} {dtype}"
        flash_fwd_check(name, *flash_attention_fwd(q, k, v, **kw), q, k, v,
                        kw)
        (flash_bwd_single_key if single_key(shape) else flash_bwd_run)(
            f"{name} backward", q, k, v, kw, gen)
        del q, k, v
    return 2 * len(shapes)


# whisper's block at its published widths and lengths, 2 + 2 layers, a step
# of 4 clips in 2 micro-batches
WHISPER_STEP = (2, 4, 2)


def whisper_step_check(dev) -> dict:
    """One training step of whisper-large-v3 at full width and lengths
    (3,000 mel frames, 448 tokens; `WHISPER_STEP`'s layers and clips),
    bf16, remat, AdamW, under `tracing.recording()`: no attention call on
    the card may take the plain `_sdpa` (the count ``attn.plain_calls``
    reads 0), and the blocked attention launches (encoder + 2 x decoder
    layers) x 2 (remat) forward and as many backward calls of two
    launches, a micro-batch, at whisper's three shapes. Raises on a
    failure."""
    import dataclasses
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.encdec import init_encdec
    from repro_torch.optim import get_optimizer
    layers, clips, micro = WHISPER_STEP
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              n_layers=layers, n_enc_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(7)
    model = init_encdec(cfg, generator=gen, device=dev)
    opt = get_optimizer("adamw", lr=adamw_hyper()["lr"])
    state = opt[0](dict(model.named_parameters()))
    step = make_train_step(cfg, opt, micro_batches=micro)
    S, F = cfg.whisper.max_target_positions, 2 * cfg.enc_context
    toks = torch.randint(0, cfg.vocab_size, (clips, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "frames": torch.randn((clips, cfg.whisper.n_mels, F),
                                   generator=gen, device=dev).to(cfg.adtype)}
    reset_kernel_launch_counts()
    tracing.clear()
    with tracing.recording():
        _, _, out = step(model, state, 0, batch)
        loss = float(out["loss"])
    plain = sum(r.counts.get("attn.plain_calls", 0)
                for r in tracing.records())
    tracing.clear()
    launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
    n_attn = 3 * layers
    B, H, dh = clips // micro, cfg.n_heads, cfg.head_dim_
    T = cfg.enc_context
    want = {(B, T, T, H, H, dh, 0, 0, 0): 2 * layers * micro,
            (B, S, S, H, H, dh, 1, 0, 0): 2 * layers * micro,
            (B, S, T, H, H, dh, 0, 0, 0): 2 * layers * micro}
    if plain or not math.isfinite(loss) or \
            shapes.get(BLOCKED) != want or \
            launches.get(BLOCKED + "_bwd") != 2 * n_attn * micro:
        raise AssertionError(
            f"whisper step: attn.plain_calls {plain}, loss {loss}, blocked "
            f"launches {shapes.get(BLOCKED)} and "
            f"{launches.get(BLOCKED + '_bwd')} backward, expected 0, a "
            f"finite loss, {want} and {2 * n_attn * micro}")
    del model, state
    return dict(layers=[layers, layers], clips=clips, micro_batches=micro,
                frames=F, tokens=S, loss=loss, plain_calls=plain,
                blocked_launches=launches.get(BLOCKED),
                backward_launches=launches.get(BLOCKED + "_bwd"))


def flash_library(shape) -> bool:
    """One PyTorch call computes this shape's function: no softcap, no
    window."""
    return not shape[8] and not shape[7]


def sdpa_views(q, k, v):
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def measure_flash(gen, dev, shape) -> dict:
    """At the paths' bf16: held against the plain version (the output by
    `must_be_close_bf16`, the log-sum-exp within FLASH_TOL), then timed;
    the library row `F.scaled_dot_product_attention` on (B, H, S, dh)
    views where no softcap or window is asked."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (flash_attention_fwd,
                                                flash_attention_fwd_ref,
                                                launch_flash_attention)
    kw = flash_kw(shape)
    q, k, v = flash_inputs(gen, dev, shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flash_attention_fwd_ref(q, k, v, **kw, **flash_blocks(q, k))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = flash_fwd_check(f"blocked attention {shape}",
                          *flash_attention_fwd(q, k, v, **kw), q, k, v, kw)
    out = torch.empty_like(q)
    lse = torch.empty((shape[0], shape[3], shape[1]), dtype=torch.float32,
                      device=dev)

    def bare():
        launch_flash_attention(q, k, v, out, lse, *kw.values())
    ms = time_ms(bare, 10)
    lib = dict(library_ms=None,
               library="none: no PyTorch call computes a softcap or window")
    if flash_library(shape):
        views = sdpa_views(q, k, v)
        lib = dict(library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            *views, is_causal=kw["causal"], enable_gqa=True), 10),
            library="F.scaled_dot_product_attention, bf16, (B, H, S, dh) "
                    "views")
    return dict(
        max_abs_err=err, tolerance=f"bf16 output: {BF16_OUT_RTOL} relative "
        f"plus {BF16_OUT_ATOL} of the plain float32 answer; lse {FLASH_TOL}",
        ms=ms, **device_time(bare),
        wrapper_ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), 10),
        plain_ms=plain_ms, **lib,
        bound_fp32_ms=flash_flops(shape, 2) / ALU_OPS_PER_S * 1e3,
        achieved_TFLOPs=flash_flops(shape, 2) / ms / 1e9)


def measure_flash_bwd(gen, dev, shape) -> dict:
    """At the paths' bf16: held against the plain version within
    FLASH_BWD_TOL_BF16 of each gradient's largest |value| and bit for bit
    repeatable, then both launches timed; the library row the autograd
    backward of one `F.scaled_dot_product_attention` call where no softcap
    or window is asked."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (
        flash_attention_bwd, flash_attention_bwd_ref,
        launch_flash_attention_bwd_dkdv, launch_flash_attention_bwd_dq)
    kw = flash_kw(shape)
    q, k, v = flash_inputs(gen, dev, shape)
    err, args = flash_bwd_run(f"blocked attention backward {shape}", q, k, v,
                              kw, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flash_attention_bwd_ref(*args, **kw, **flash_blocks(q, k))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    _, _, _, out, lse, dout = args
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def bare():
        launch_flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq,
                                      *kw.values())
        launch_flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, dk, dv,
                                        *kw.values())
    ms = time_ms(bare, 10)
    lib = dict(library_ms=None,
               library="none: no PyTorch call computes a softcap or window")
    if flash_library(shape):
        views = [t.detach().requires_grad_(True) for t in sdpa_views(q, k, v)]
        o = F.scaled_dot_product_attention(*views, is_causal=kw["causal"],
                                           enable_gqa=True)
        g = dout.transpose(1, 2)
        lib = dict(library_ms=time_ms(lambda: torch.autograd.grad(
            o, views, g, retain_graph=True), 10),
            library="the autograd backward of one "
                    "F.scaled_dot_product_attention call, bf16")
    return dict(
        max_abs_err=err, tolerance=f"{FLASH_BWD_TOL_BF16} x each gradient's "
                                   "max |value| (bf16)",
        bitwise_repeatable=True, launches_a_call=2, ms=ms,
        **device_time(bare),
        wrapper_ms=time_ms(lambda: flash_attention_bwd(*args, **kw), 10),
        plain_ms=plain_ms, **lib,
        bound_fp32_ms=flash_flops(shape, 5) / ALU_OPS_PER_S * 1e3,
        achieved_TFLOPs=flash_flops(shape, 5) / ms / 1e9)


def adamw_hyper() -> dict:
    """AdamW's settings in the training cell's configuration (`TRAIN_CELL`),
    in `adamw_update_ref`'s order."""
    o = train_cell(0, None).config["job"]["optimizer"]
    return {k: o[k] for k in ("lr", "b1", "b2", "eps", "weight_decay")}


def adamw_cost(shape):
    """(leaves, elements, parameter bytes, master): per element the
    gradient read and the parameter written, m and v read and written,
    the master read and written (without one, the parameter read in its
    place); 16 float32 operations."""
    _, n, pb, master = shape
    return n * (2 * pb + 16 + (8 if master else pb)), 16 * n


def adamw_leaves(gen, dev, sizes, bf16: bool, master: bool, offset=0):
    """Leaves of one instance, one a size in `sizes`; with `offset` each
    tensor is a view that many elements into a buffer of its own."""
    dt = torch.bfloat16 if bf16 else torch.float32

    def put(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        buf[offset:].copy_(x)
        return buf[offset:]
    leaves = []
    for n in sizes:
        w = torch.randn(n, generator=gen, device=dev) * 0.05
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-5
        leaves.append((put(w.to(dt)), put(g.to(dt)), put(m), put(v),
                       put(w) if master else None))
    return leaves


def adamw_bc(dev, step: int):
    """The bias corrections as the optimizer makes them at `step`."""
    from repro_torch.optim.adamw import f32_step
    t = f32_step(step, dev)
    hyper = adamw_hyper()
    return 1.0 - hyper["b1"] ** t, 1.0 - hyper["b2"] ** t


def adamw_must_equal(name: str, leaves, bc1, bc2) -> int:
    """One update by the wrapper against the plain loop on copies of the
    leaves: every parameter, m, v and master equal bit for bit."""
    from repro_torch.kernels.adamw import adamw_update, adamw_update_ref
    copies = [tuple(None if t is None else t.clone() for t in leaf)
              for leaf in leaves]
    hyper = adamw_hyper()
    adamw_update(leaves, bc1, bc2, **hyper)
    adamw_update_ref(copies, bc1, bc2, *hyper.values())
    for i, (got, want) in enumerate(zip(leaves, copies)):
        for part, x, y in zip(("param", "grad", "m", "v", "master"), got,
                              want):
            if x is not None and not torch.equal(x, y):
                raise AssertionError(
                    f"kernel check {name!r}: leaf {i}'s {part} differs "
                    "from its plain version (tolerance 0: bit for bit)")
    return 0


def edge_adamw(gen, dev) -> int:
    """Ragged lengths around the 8-element vector and the 2,048-element
    chunk, empty leaves, float32 parameters with and without masters, bf16
    without, views off 16-byte boundaries, more leaves than one launch's
    table: two steps each."""
    cases = 0
    for sizes, bf16, master, offset in (
            ((1, 7, 8, 9, 2047, 2049, 0, 3 * 2048 + 5), True, True, 0),
            ((1, 7, 2049, 0), False, True, 0),
            ((5, 2049, 0, 8), False, False, 0),
            ((5, 2049, 8), True, False, 0),
            ((1, 7, 2049, 4096), True, True, 1),
            ((3, 2049), False, False, 1),
            ((17,) * 90, True, True, 0)):
        leaves = adamw_leaves(gen, dev, sizes, bf16, master, offset)
        for step in range(2):
            adamw_must_equal(f"adamw {len(sizes)} leaves bf16={bf16} "
                             f"master={master} off={offset} step={step}",
                             leaves, *adamw_bc(dev, step))
            cases += 1
    return cases


def adamw_registers() -> dict:
    """ptxas' registers and spill bytes of each AdamW instance."""
    out = {}
    for entry, n in REGISTERS.items():
        m = re.search(r"adamw_kernelI(\w+?)Lb([01])E", entry)
        if m:
            key = (f"{'bf16' if 'bfloat16' in m.group(1) else 'float32'},"
                   f"{'master' if m.group(2) == '1' else 'no master'}")
            out[key] = dict(registers=n, spill_bytes=SPILLS.get(entry, 0))
    return out


def measure_adamw(gen, dev, shape) -> dict:
    """A group of (leaves, elements, parameter bytes, master) as a training
    path launched it, the elements split evenly over the leaves; the
    library row is torch's fused AdamW over float32 weights and gradients
    (28 B a parameter too), timed after the group is freed."""
    from repro_torch.kernels.adamw import (adamw_update, adamw_update_ref,
                                           launch_adamw)
    k, n, pb, master = shape
    leaves = adamw_leaves(gen, dev, [n // k + (i < n % k) for i in range(k)],
                          pb == 2, bool(master))
    bc1, bc2 = adamw_bc(dev, 2)
    err = adamw_must_equal(f"adamw {shape}", leaves, bc1, bc2)
    hyper = adamw_hyper()

    def bare():
        launch_adamw(leaves, bc1, bc2, *hyper.values())
    out = dict(max_abs_err=err, bitwise_equal=True,
               registers=adamw_registers(), ms=time_ms(bare, 20),
               **device_time(bare),
               wrapper_ms=time_ms(lambda: adamw_update(
                   leaves, bc1, bc2, **hyper), 20),
               plain_ms=time_ms(lambda: adamw_update_ref(
                   leaves, bc1, bc2, *hyper.values()), 3))
    weights = [torch.nn.Parameter(w if master else p.float())
               for p, _, _, _, w in leaves]
    del leaves
    for w in weights:
        w.grad = torch.randn(w.shape, generator=gen, device=dev) * 1e-2
    lib = torch.optim.AdamW(weights, lr=hyper["lr"],
                            betas=(hyper["b1"], hyper["b2"]),
                            eps=hyper["eps"],
                            weight_decay=hyper["weight_decay"],
                            fused=True)
    out.update(library_ms=time_ms(lib.step, 10),
               library="torch.optim.AdamW(fused=True), float32 weights and "
                       "gradients (yardstick only)")
    return out


# The causal conv: shapes are the wrapper's launch shape (B, T, D, K); the
# paths launch it in bf16 with x the in-projection's first half.

def conv_cost(shape):
    """(B, T, D, K) in bf16: x read and y written (4 B an element), w and
    b read; K multiply-adds, the bias and the SiLU's exponential, add and
    divide an element."""
    B, T, D, K = shape
    return 4 * B * T * D + 2 * (K + 1) * D, B * T * D * (2 * K + 4)


def conv_bwd_cost(shape):
    """(B, T, D, K) in bf16: x and gy read and dx written (6 B an
    element), w and b read and dw and db written (the tiles' float32
    partial sums are the kernel's own scratch); an element's pre again
    (2 K), silu' (7), gp (1), dx (2 K) and dw and db (2 K + 1)."""
    B, T, D, K = shape
    return 6 * B * T * D + 4 * (K + 1) * D, B * T * D * (6 * K + 9)


CONV_EDGES = ((1, 1, 1), (2, 3, 100), (1, 5, 264), (3, 67, 8),
              (1, 4097, 257), (2, 64, 4101))
CONV_LAYOUTS = ("strided", "contiguous", "offset")
CONV_SCALE_TOL = 1e-5     # of each result's largest |value|


def conv_inputs(gen, dev, shape, dtype=torch.bfloat16, layout="strided"):
    """x (the first half of a (B, T, 2 D) buffer, a contiguous copy or
    a view one element into it), w, b and an upstream gradient gy."""
    B, T, D, K = shape
    full = torch.randn((B, T, 2 * D), generator=gen, device=dev)
    full = full.to(dtype)
    x = {"strided": full[..., :D], "contiguous": full[..., :D].contiguous(),
         "offset": full[..., 1:D + 1]}[layout]
    w = (torch.randn((K, D), generator=gen, device=dev) * K ** -0.5)
    b = torch.randn((D,), generator=gen, device=dev) * 0.1
    gy = torch.randn((B, T, D), generator=gen, device=dev)
    return x, w.to(dtype), b.to(dtype), gy.to(dtype)


def conv_check(name, got, want) -> float:
    """`got` (the kernel's type) against the float32 plain result rounded
    to that type: within 2**-7 of the value in bf16 (1e-5 in float32) plus
    CONV_SCALE_TOL of the largest |value|; returns the largest absolute
    difference from the float32 result."""
    want = want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    rtol = 2**-7 if got.dtype == torch.bfloat16 else 1e-5
    atol = CONV_SCALE_TOL * float(want.abs().max()) + 1e-7
    g, w = got.float(), want.to(got.dtype).float()
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(
            f"kernel check {name!r}: differs from its plain version (max "
            f"abs err {float((g - w).abs().max())}, tolerance {rtol} "
            f"relative plus {atol})")
    return float((g - want).abs().max())


def conv_both_check(name, x, w, b, gy) -> float:
    """The forward and the backward against the float32 plain versions on
    the same operands, the backward twice and bit for bit the same."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu,
                                                 causal_conv_silu_bwd,
                                                 causal_conv_silu_bwd_ref,
                                                 causal_conv_silu_ref)
    f32 = [t.float() for t in (x, w, b)]
    err = conv_check(f"{name} forward", causal_conv_silu(x, w, b),
                     causal_conv_silu_ref(*f32))
    got = causal_conv_silu_bwd(x, w, b, gy)
    for part, g, want, again in zip(
            ("dx", "dw", "db"), got,
            causal_conv_silu_bwd_ref(*f32, gy.float()),
            causal_conv_silu_bwd(x, w, b, gy)):
        err = max(err, conv_check(f"{name} {part}", g, want))
        if not torch.equal(g, again):
            raise AssertionError(f"kernel check {name!r}: two identical "
                                 f"calls gave different bits in {part}")
    return err


def edge_conv(gen, dev) -> int:
    """Ragged T and D, one step, one channel, each layout of x, bf16 and
    float32: forward and backward."""
    cases = 0
    for B, T, D in CONV_EDGES:
        for layout in CONV_LAYOUTS:
            for dtype in (torch.bfloat16, torch.float32):
                args = conv_inputs(gen, dev, (B, T, D, 4), dtype, layout)
                conv_both_check(f"causal conv {(B, T, D)} {layout} {dtype}",
                                *args)
                cases += 1
    return cases


def conv_registers() -> dict:
    """ptxas' registers and spill bytes of each causal-conv instance, and
    the occupancy API's resident blocks an SM of the forward's and the
    backward's tile kernels."""
    import ctypes
    from repro_torch.kernels import build
    out = {}
    for entry, n in REGISTERS.items():
        m = re.search(r"causal_conv_(fwd|bwd|reduce)_kernelI(\w+?)Li(\d+)E",
                      entry)
        if m:
            key = (f"{m.group(1)},"
                   f"{'bf16' if 'bfloat16' in m.group(2) else 'float32'},"
                   f"K={m.group(3)}")
            out[key] = dict(registers=n, spill_bytes=SPILLS.get(entry, 0))
    for bwd in (0, 1):
        for bf16 in (1, 0):
            blocks = ctypes.c_int(0)
            build.check(build.entry("causal_conv_occupancy")(
                bwd, bf16, ctypes.byref(blocks)), "causal_conv_occupancy")
            key = (f"{'bwd' if bwd else 'fwd'},"
                   f"{'bf16' if bf16 else 'float32'},K=4")
            out.setdefault(key, {})["blocks_per_sm"] = blocks.value
    return out


def measure_conv(gen, dev, shape) -> dict:
    """At a path's shape, x the in-projection's strided half in bf16; the
    plain row is the bf16 chain the kernel replaced."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu,
                                                 causal_conv_silu_ref,
                                                 launch_causal_conv)
    x, w, b, gy = conv_inputs(gen, dev, shape)
    err = conv_both_check(f"causal conv {shape}", x, w, b, gy)
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    return dict(max_abs_err=err, tolerance=f"2**-7 relative (bf16) plus "
                                           f"{CONV_SCALE_TOL} x max |value|",
                registers=conv_registers(),
                ms=time_ms(lambda: launch_causal_conv(x, w, b, y), 20),
                **device_time(lambda: launch_causal_conv(x, w, b, y)),
                wrapper_ms=time_ms(lambda: causal_conv_silu(x, w, b), 20),
                plain_ms=time_ms(lambda: causal_conv_silu_ref(x, w, b), 5),
                library_ms=None)


def measure_conv_bwd(gen, dev, shape) -> dict:
    """As `measure_conv`; the bare launches (both) into allocated outputs
    and partials, and the plain row the autograd backward of the bf16
    chain."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu_bwd,
                                                 causal_conv_silu_ref,
                                                 launch_causal_conv_bwd)
    from repro_torch.kernels.causal_conv.ops import _bwd_partials
    B, T, D, K = shape
    x, w, b, gy = conv_inputs(gen, dev, shape)
    err = conv_both_check(f"causal conv backward {shape}", x, w, b, gy)
    outs = (torch.empty(x.shape, dtype=x.dtype, device=dev),
            _bwd_partials(B, T, D, K, dev), torch.empty_like(w),
            torch.empty_like(b))
    leaves = tuple(t.detach().requires_grad_() for t in (x, w, b))
    y = causal_conv_silu_ref(*leaves)
    return dict(max_abs_err=err, tolerance=f"2**-7 relative (bf16) plus "
                                           f"{CONV_SCALE_TOL} x max |value|",
                bitwise_repeatable=True, registers=conv_registers(),
                partial_bytes=outs[1].numel() * 4,
                ms=time_ms(lambda: launch_causal_conv_bwd(x, w, b, gy,
                                                          *outs), 20),
                **device_time(lambda: launch_causal_conv_bwd(x, w, b, gy,
                                                             *outs)),
                wrapper_ms=time_ms(lambda: causal_conv_silu_bwd(x, w, b, gy),
                                   20),
                plain_ms=time_ms(lambda: torch.autograd.grad(
                    y, leaves, gy, retain_graph=True), 5),
                library_ms=None)


# kernel name -> (cost of one launch at a shape, measurement at a shape)
KERNELS = {
    "scan_exact": (scan_cost, lambda g, d, s: measure_scan(g, d, s, False)),
    "scan_exact_join": (scan_cost,
                        lambda g, d, s: measure_scan(g, d, s, True)),
    "scan_exact_sharded": (
        lambda s: scan_sharded_cost(s, False),
        lambda g, d, s: measure_scan_sharded(g, d, s, False)),
    "scan_exact_join_sharded": (
        lambda s: scan_sharded_cost(s, True),
        lambda g, d, s: measure_scan_sharded(g, d, s, True)),
    "hash_probe": (probe_cost, measure_probe),
    "merge_runs": (merge_cost, measure_merge),
    "bitonic_sort": (sort_cost, measure_sort),
    "bitonic_merge_rows": (merge_rows_cost, measure_merge_rows),
    "bitonic_apply": (apply_cost, measure_apply),
    "snapshot_copy": (snapshot_cost, measure_snapshot),
    "scan_exact_group": (lambda s: group_cost(s, "flat"),
                         lambda g, d, s: measure_group(g, d, s, "flat")),
    "scan_exact_group_sharded": (
        lambda s: group_cost(s, "sharded"),
        lambda g, d, s: measure_group(g, d, s, "sharded")),
    "scan_exact_join_group": (lambda s: group_cost(s, "join"),
                              lambda g, d, s: measure_group(g, d, s, "join")),
    "scan_exact_join_group_sharded": (
        lambda s: group_cost(s, "join_sharded"),
        lambda g, d, s: measure_group(g, d, s, "join_sharded")),
    "scan_values_delta": (values_cost, measure_values_delta),
    "scan_exact_mesh": (lambda s: scan_mesh_cost(s, False),
                        lambda g, d, s: measure_scan_mesh(g, d, s, False)),
    "scan_exact_join_mesh": (
        lambda s: scan_mesh_cost(s, True),
        lambda g, d, s: measure_scan_mesh(g, d, s, True)),
    "scan_float": (float_scan_cost, measure_float_scan),
    "decode_attn": (decode_cost, measure_decode),
    "selective_scan": (ssm_cost, measure_ssm),
    "selective_scan_bwd": (ssm_bwd_cost, measure_ssm_bwd),
    "flash_attention": (flash_cost, measure_flash),
    "flash_attention_bwd": (flash_bwd_cost, measure_flash_bwd),
    "adamw": (adamw_cost, measure_adamw),
    "causal_conv": (conv_cost, measure_conv),
    "causal_conv_bwd": (conv_bwd_cost, measure_conv_bwd),
}
DECODE_32K = (4, 32768, 16, 8, 256, 32768)    # gemma2's heads at decode_32k
DECODE_32K_D112 = (4, 32768, 64, 8, 112, 32768)   # kimi-k2's heads


def flash_bwd_bound_s(shape, sms: int, sm_clock_hz: float):
    """A backward call's least time and which bound binds: the call is
    timed whole, its two launches (the dQ pass, the dK/dV pass), so twice
    the benchmark's least time of one launch (`flash_bound_s` counts a
    launch as half its call)."""
    seconds, by = flash_bound_s(shape, True, sms, sm_clock_hz)
    return 2 * seconds, by


# the kernels whose least time the benchmark reckons with the SFUs: name ->
# least(shape, SMs, highest SM clock) -> (seconds, which bound binds)
SFU_BOUNDS = {
    "selective_scan": lambda s, *card: ssm_bound_s(s, False, *card),
    "selective_scan_bwd": lambda s, *card: ssm_bound_s(s, True, *card),
    "flash_attention": lambda s, *card: flash_bound_s(s, False, *card),
    "flash_attention_bwd": flash_bwd_bound_s,
}


def card_sfu() -> tuple[int, float]:
    """(SMs, highest SM clock in Hz) of the first card: what the SFU
    bounds need. Raises where `nvidia-smi` gives no clock."""
    hz = max_sm_clock_hz()
    if hz is None:
        raise AssertionError("nvidia-smi gave no clocks.max.sm: the SFU "
                             "bounds cannot be reckoned")
    return torch.cuda.get_device_properties(0).multi_processor_count, hz


def roofline_ms(cost: tuple) -> tuple[float, str]:
    """(bytes, operations) -> the larger of the bytes at HBM_BYTES_PER_S
    and the operations at ALU_OPS_PER_S, in ms, and which binds."""
    by_bytes, by_ops = cost[0] / HBM_BYTES_PER_S, cost[1] / ALU_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def least_ms(name: str, shape, card: tuple[int, float]) -> tuple[float, str]:
    """The least milliseconds of one launch of `name` at `shape` (of one
    call where a call is timed) and which bound binds: the benchmark's
    where it reckons the kernel (`SFU_BOUNDS` on the card `card_sfu`
    read; the exact scans' `roofline_ms` of `bench.yardstick.scan_cost`,
    which is its `scan_bound_s`), else the `roofline_ms` of the kernel's
    own cost (`KERNELS`)."""
    if name in SFU_BOUNDS:
        seconds, by = SFU_BOUNDS[name](shape, *card)
        return seconds * 1e3, by
    return roofline_ms(KERNELS[name][0](shape))


def with_bound(m: dict, shape, launches: int, bound: tuple[float, str]
               ) -> dict:
    return dict(m, shape=list(shape), launches_at_shape=launches,
                bound_ms=bound[0], bound_by=bound[1])


def most_launched(seen: dict, cost):
    """The shape launched most (ties: the costlier)."""
    return max(seen, key=lambda s: (seen[s], cost(s)))


def phase_kernels(shapes: dict, path_shapes: dict) -> dict:
    """`shapes`: per kernel, the launches each shape got on its paths;
    `path_shapes`: per kernel with more than one path, the same per path.
    Returns per kernel the measurement at the shape launched most (ties:
    the costlier), with the costliest shape's under ``largest`` where that
    is another, and under ``at_paths`` each path's most launched shape
    where that is neither."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = card_sfu()
    cases = (edge_scan(gen, dev) + edge_scan_sharded(gen, dev)
             + edge_join_lane(gen, dev)
             + edge_scan_mesh(gen, dev) + edge_probe(gen, dev) + edge_merge(gen, dev)
             + edge_bitonic(gen, dev) + edge_snapshot(gen, dev)
             + edge_delta(gen, dev) + edge_float_scan(gen, dev)
             + edge_decode(gen, dev) + edge_ssm(gen, dev)
             + edge_ssm_bwd(gen, dev) + edge_ssm_gated(gen, dev)
             + edge_flash(gen, dev)
             + edge_flash_whisper(gen, dev) + edge_adamw(gen, dev)
             + edge_conv(gen, dev))
    whisper_step = whisper_step_check(dev)
    cases += 1
    torch.cuda.empty_cache()
    measured = {}
    for name, (cost, measure) in KERNELS.items():
        seen = shapes[name]

        def at(shape, launches):
            return with_bound(measure(gen, dev, shape), shape, launches,
                              least_ms(name, shape, card))
        most = most_launched(seen, cost)
        largest = max(seen, key=cost)
        measured[name] = at(most, seen[most])
        cases += 1
        if largest != most:
            measured[name]["largest"] = at(largest, seen[largest])
            cases += 1
        for path, on_path in path_shapes.get(name, {}).items():
            shape = most_launched(on_path, cost)
            if shape not in (most, largest):
                measured[name].setdefault("at_paths", {})[path] = at(
                    shape, on_path[shape])
                cases += 1
        if name in SHARDED_SCANS:
            # the islands runs' other island counts, at the shape each
            # launched most: an even split and an uneven one differ
            by_count = {}
            for shape, n in seen.items():
                best = by_count.get(shape[0])
                if best is None or (n, cost(shape)) > (seen[best],
                                                       cost(best)):
                    by_count[shape[0]] = shape
            measured[name]["at_islands"] = {
                str(count): at(shape, seen[shape])
                for count, shape in sorted(by_count.items())
                if count != most[0]}
            cases += len(by_count) - 1
        if name in MESH_SCANS and not mesh_stack_rows(name, most):
            # the delta plane's launches, the correction slice riding them
            carried = {sh: c for sh, c in seen.items()
                       if mesh_stack_rows(name, sh)}
            if carried:
                shape = max(carried, key=lambda sh: (carried[sh], cost(sh)))
                measured[name]["with_correction"] = at(shape, carried[shape])
                cases += 1
        if name == "merge_runs" and most != SHIP_MERGE:
            measured[name]["at_ship"] = at(SHIP_MERGE,
                                           seen.get(SHIP_MERGE, 0))
            cases += 1
        if name in ("flash_attention", "flash_attention_bwd"):
            # every other shape the paths ran (whisper's causal and
            # bidirectional forms, gemma2's local and global layers)
            done = {most, largest, *(tuple(m["shape"]) for m in
                                     measured[name].get("at_paths",
                                                        {}).values())}
            measured[name]["at_shapes"] = {
                "/".join(map(str, shape)): at(shape, seen[shape])
                for shape in sorted(seen) if shape not in done}
            cases += len(measured[name]["at_shapes"])
        if name == "decode_attn":
            # each other head layout (H, Hkv, d) the serving path ran, at
            # the shape it launched most
            by_heads = {}
            for shape, n in seen.items():
                best = by_heads.get(shape[2:5])
                if best is None or (n, cost(shape)) > (seen[best],
                                                       cost(best)):
                    by_heads[shape[2:5]] = shape
            measured[name]["at_heads"] = {
                "/".join(map(str, heads)): at(shape, seen[shape])
                for heads, shape in sorted(by_heads.items())
                if heads != most[2:5]}
            cases += len(by_heads) - 1
            for key, shape in (("at_decode_32k", DECODE_32K),
                               ("at_decode_32k_d112", DECODE_32K_D112)):
                measured[name][key] = at(shape, 0)
                cases += 1
    torch.cuda.synchronize()
    emit("kernels", cases=cases,
         tolerance="0 (integers); float32: decode_attn 2e-5 (bf16 output: "
                   f"{BF16_OUT_RTOL} relative plus {BF16_OUT_ATOL}), "
                   f"selective_scan 3e-5, selective_scan_bwd {SSM_BWD_TOL} "
                   f"x each gradient's max |value|, scan_float: "
                   f"{FLOAT_SCAN_TOL}; flash_attention float32 {FLASH_TOL} "
                   "(bf16 output as decode_attn's), flash_attention_bwd "
                   f"{FLASH_BWD_TOL} (bf16: {FLASH_BWD_TOL_BF16}) x each "
                   "gradient's max |value|; adamw 0 (bit for bit); "
                   "causal_conv and causal_conv_bwd one rounding (2**-7 "
                   "relative in bf16, 1e-5 in float32) plus "
                   f"{CONV_SCALE_TOL} x each result's max |value|; the "
                   "gated scan: y and y_pre 3e-5 (y's scaled by |silu(z)|) "
                   "plus a bf16 ulp of the float32 chain, its "
                   f"backward {SSM_BWD_TOL} x each gradient's max |value| "
                   "(gz 1e-6) plus a bf16 ulp",
         whisper_step=whisper_step,
         kernels=[dict(name=k, ok=True, **m) for k, m in measured.items()])
    return measured


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--cols", type=int, default=8)
    ap.add_argument("--txns", type=int, default=400_000)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--islands", default="4,3",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the islands phase, in order")
    ap.add_argument("--delta-islands", default="1,4",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the delta phase, in order")
    ap.add_argument("--delta-capacity", type=int, default=4096,
                    help="appended entries per column between compactions")
    ap.add_argument("--mesh-islands", default="4,1",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the mesh phase with the islands "
                         "on one card, in order (the first also runs the "
                         "delta store)")
    ap.add_argument("--lm-models",
                    default="gemma2-9b,falcon-mamba-7b,"
                            "llama4-scout-17b-a16e,kimi-k2-1t-a32b,"
                            "whisper-base",
                    type=lambda s: [m for m in s.split(",") if m],
                    help="models of the lm_serve phase, in order (full "
                         "width; depth cut as LM_DEPTH says)")
    ap.add_argument("--lm-batch", type=int, default=4,
                    help="requests served at once")
    ap.add_argument("--lm-prompt", type=int, default=256,
                    help="prompt tokens per request, fed one at a time")
    ap.add_argument("--lm-gen", type=int, default=32,
                    help="generated tokens per request (at least 2)")
    ap.add_argument("--lm-prefill", type=int, default=2048,
                    help="prompt length of the Mamba model's prefill calls")
    args = ap.parse_args(argv)
    if args.lm_gen < 2 or (args.lm_prompt + args.lm_gen - 1
                           + LM_PROFILE_STEPS > LM_MAX_LEN):
        ap.error(f"--lm-gen must be at least 2 and the prompt plus the "
                 f"generated tokens must fit {LM_MAX_LEN} cache slots")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device - this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here if the package is missing)
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "repro" \
                or mod.startswith("repro."):
            raise AssertionError(f"{mod} was imported")

    card = phase_env()
    phase_build()
    wl = make_workload(args)
    runs = {}
    main_launches, main_shapes, answers, cols, seconds, main_result = \
        phase_main_path(args, wl)
    runs["main_path"] = (main_launches, main_shapes)
    runs["islands"] = phase_islands(args, wl, main_launches, answers, cols)
    runs["delta"] = phase_delta(args, wl, answers, cols, seconds)
    runs["mesh"] = phase_mesh(args, wl, main_launches, answers, cols)
    runs["elastic"] = phase_elastic(args, wl, answers, cols)
    runs["ana_only"] = phase_ana_only(args, wl)
    runs["float_scan"] = phase_float_scan(args, wl, cols)
    del cols
    runs.update(phase_mixed_traffic(args, wl))
    runs["si_baselines"] = phase_si_baselines(args, wl, answers, main_result)
    torch.cuda.empty_cache()
    runs["lm_serve"] = phase_lm_serve(args)
    torch.cuda.empty_cache()
    runs["lm_train"] = phase_lm_train(args)
    torch.cuda.empty_cache()
    runs["encdec_train"] = phase_encdec_train(args)
    # every kernel's launches and shapes from the paths that run it
    missing = [k for k in REPLACES if k not in NO_CALLER_SHAPE
               and any(k not in runs[p][0] for p in paths_of(k))]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{missing}")
    folded = {(k, p): r[0][k] for k in NEVER_ON_PATH for p, r in runs.items()
              if r[0].get(k, 0)}
    if folded:
        raise AssertionError(f"kernels folded into other launches launched "
                             f"on their own: {folded}")
    launches = {k: sum(runs[p][0].get(k, 0) for p in paths_of(k))
                for k in REPLACES}
    shapes, path_shapes = {}, {}
    for k in REPLACES:
        if k not in NO_CALLER_SHAPE:
            shapes[k] = {}
            for p in paths_of(k):
                for sh, n in runs[p][1][k].items():
                    shapes[k][sh] = shapes[k].get(sh, 0) + n
            if len(paths_of(k)) > 1:
                path_shapes[k] = {p: runs[p][1][k] for p in paths_of(k)}
    by_path = {k: {p: runs[p][0][k] for p in paths_of(k)} for k in REPLACES
               if len(paths_of(k)) > 1}
    for k, shape in NO_CALLER_SHAPE.items():
        # the shapes any path launched it at, else the made-up one
        by_path[k] = {p: r[0].get(k, 0) for p, r in runs.items()}
        seen = {}
        for r in runs.values():
            for sh, c in r[1].get(k, {}).items():
                seen[sh] = seen.get(sh, 0) + c
        shapes[k] = seen or {shape: 0}
    measured = phase_kernels(shapes, path_shapes)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
             launches=launches[k], **m,
             **({"launches_by_path": by_path[k]} if k in by_path else {}))
        for k, m in measured.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
