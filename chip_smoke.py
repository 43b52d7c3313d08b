#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # what the checks run
    python3 chip_smoke.py --profile    # plus one profiled run of each path

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch_kernels/``), holds each kernel against its plain
PyTorch version on the card (bit-exact for the integer kernels), drives the
paths a user calls, and
prints one JSON line per phase:

  1. card      — device name, and the ``nvidia-smi`` name / power limit line
                 (printed again just before the kernels line);
  2. build     — seconds the build took, ptxas register / spill counts;
  3. kernels   — ``chacha20_xor`` and ``vpc_datapath`` against their plain
                 versions at many shapes (``torch.equal``: bit-exact), the
                 datapath also on N around its 256- and 512-packet tiles,
                 R = 1,025 and six rule tables at its packed key's edges
                 (``serving.vpc.make_edge_case``);
  4. main path — ``Platform(ComputeBackend())``, two tenants (weights 2:1)
                 each deploying firewall >> nat >> chacha20 with 300 rules,
                 ~1.0 M packets per run; checks outputs against the plain
                 version, decryption, launch counts, traces and the fair
                 interleave; prints Mpkt/s, wire Gbit/s and kernel ms,
                 and the CUDA kernels and memory operations of one run
                 with the fused kernel's rule table, key, nonce and NAT
                 address rebuilt on every dispatch and kept per deployment
                 (``device_ops_per_run``, from ``torch.profiler``); then
                 new rules and a new NAT address swapped into both
                 deployments' params: one more run equal to the plain
                 version on the new params, and the next with the same
                 kernels and memory operations (``swapped_params``);
  5. encrypt   — ``bytes_to_blocks`` -> ``encrypt`` -> ``blocks_to_bytes``
                 round trip of a 64 MiB buffer;
  5b. the streaming datapath and the fleet, on the main path's traffic
                 held in host memory (as packets arrive from a host):
     stream        — ``ComputeBackend(stream=True, ring_depth=4)`` in turns
                 with the batch runtime, 5 runs each: outputs ``torch.equal``
                 to the batch path's (itself held against the plain version),
                 no batch in flight after a run, ``vpc_datapath`` launches
                 equal to the dispatch groups, ring slots flat after the
                 warm-up run, and the same bits with ``ring_depth=1,
                 max_inflight=1`` (every acquire waits); prints both modes'
                 Mpkt/s and wire Gbit/s, ``ring.stats()`` and the kernel's
                 ms a run (with ``--profile``, each mode's device idle
                 share);
     inject_stream — a generator of the same batches through
                 ``inject_stream`` in epochs of the ring's depth under
                 credits of one WDRR quantum: served equals injected, the
                 outputs equal the batch path's;
     fleet         — ``ShardedBackend`` of two streaming compute shards on
                 ``cuda:0`` (the chain's ChaCha counter in stream mode, a
                 0-d base a dispatch), 4 epochs of ~1.0 M packets, a
                 checkpoint directory under a temporary directory, without
                 and with ``FaultPlan(seed=3).crash(shard=0, epoch=2)``: one
                 failover, nothing lost, journal replayed, the crash run's
                 outputs equal the crash-free run's; prints both runs'
                 Mpkt/s and the failover's wall ms;
     mixed_fleet   — ``Platform([SimBackend(name="edge"),
                 ComputeBackend(name="gpu0")])``: tenants a (2) and b (1)
                 deploy firewall >> nat on the simulated sNIC, each fed a
                 Poisson source of 1,000-byte packets at 300 Gbit/s for
                 2 ms (3x its port), and a also deploys the fused chain on
                 the card with the main path's tenant-A traffic injected:
                 the sim bytes a : b within 10 % of 2, every injected
                 packet served with the main path's bits, one
                 ``vpc_datapath`` launch a dispatch group; prints the global
                 epochs, each tenant's simulated Gbit/s and mean latency,
                 the card's Mpkt/s and the kernel's ms;
     trace         — ``TraceDriver`` replays the portability trace of
                 ``benchmarks/bench_scenarios.py`` on the sim, sharded-sim,
                 compute, compute-stream and sharded-compute platforms:
                 schedule fingerprint ``f1a89120f28456dc``
                 (``BENCH_scenarios.json``), every packet served, the same
                 bits on the three compute platforms;
     sim_resilience — host only: the kill-1-of-4 scenario of
                 ``benchmarks/bench_resilience.py`` (a copy here) at full
                 size on four ``SimBackend`` shards, twice: no deployment
                 lost, recovery within 8 epochs, the last chunk's share
                 error within 0.05 and delivered ratio at least 0.95, both
                 fingerprints the JAX package's; prints them and the wall
                 seconds;
  6. serve phases — ``Platform(ServeBackend(cfg, ...))`` five times, each
                 model's weights random f32 from a seeded
                 ``torch.Generator`` and freed before the next phase:
                 ``serve`` (qwen3-8b, 36 layers, 12 prompts), ``serve_hybrid``
                 (jamba-v0.1-52b at full width cut to one period of 8 layers:
                 7 Mamba, 1 attention, 4 MoE; 8 prompts), ``serve_moe``
                 (granite-moe-1b-a400m whole, 24 attention + MoE layers;
                 8 prompts), ``serve_rwkv`` (rwkv6-3b whole, 32 RWKV-6
                 layers; 8 prompts) and ``serve_stablelm`` (stablelm-12b
                 whole, 40 LayerNorm attention layers of head dim 160;
                 8 prompts; with the flash kernel's ms at its prefill
                 shape beside SDPA's and the bound,
                 ``flash_attention_at_prefill``).  Two tenants (gold 2 :
                 free 1) deploy cache >> prefill >> decode; prompts of
                 256-1,536 tokens with 16 new tokens each, then one prompt
                 again (a cache hit).  Checks
                 the exact launches of each kernel (per prefill group: one
                 ``flash_attention`` per attention layer, three ``moe_gmm``
                 per MoE layer, one ``mamba_ssm`` per Mamba layer, one
                 ``rwkv6_wkv`` per RWKV layer; per decode step the last
                 three again), the outputs, every launch of one
                 prefill group against its plain version on the path's own
                 activations, and that group's logits against a prefill with
                 every kernel replaced by its plain version (attention
                 rounding as the JAX package's XLA fallback does) that takes
                 the same experts, within 3e-2 of their scale (RWKV's with
                 the model computing in f32, where a scan all in bf16 and
                 one without the bonus term must fail; its bf16 logits
                 within twice the spread of a plain prefill with an f64
                 scan); the
                 tokens whose experts differ when the plain prefill routes
                 on its own are counted, with that prefill's logits.  Prints
                 tokens/s, time to first token, completions, cache hits,
                 peak memory, launches and the layer cut (``reduced``),
                 and per kernel of the path its device ms a run: each
                 (B, S) it was launched at, times its raw-launch ms there;
  7. train — ``Trainer(cfg, compress="int8")`` on qwen3-8b at full width
                 cut to 8 layers (``reduced``), weights random f32 from a
                 seeded generator, batch 1 x 4,096, lr 3e-4, 5 steps.
                 ``train_gates`` first, on their own weights: one step's
                 loss and whole gradient in f32 compute with the kernels
                 against every kernel replaced by its plain version (1e-5
                 relative, 1e-4 relative L2), where the LSE handed to the
                 backward shifted by log 2 must fail; in bf16 compute the
                 gradient within twice the spread of two plain routes that
                 differ only in rounding.  ``train_step1``: every flash
                 launch of one forward (out and LSE) against its plain
                 version, every quantize and dequantize launch of the
                 Trainer's step 1 bit for bit, and the params, moments and
                 EF after it equal to the same step with plain compression
                 on the same gradients.  Then the run: exact launches per
                 step (91 quantize, 91 dequantize, 16 flash attention),
                 finite losses and gradient norms, the median step seconds
                 of steps 2-5, tokens/s, model FLOP and MFU, the
                 compression's device ms and share, peak memory; a small
                 crash/restart on the card (head_dim 64,
                 ``compress="none"``); and the quantize kernel's device ms
                 a step (its launches at each (R, D) times the raw-launch
                 ms there) and share;
  7b. the family train phases (``TRAIN_FAMILIES``), each at full width,
                 batch 1 x 4,096, lr 3e-4, 5 steps, weights random f32
                 from a seeded generator: ``train_moe`` (granite whole,
                 int8 compression), ``train_hybrid`` (jamba cut to its
                 first two layers, Mamba + MLP and Mamba + 16-expert MoE,
                 grad_accum 1), ``train_rwkv`` (rwkv6-3b cut to 2
                 layers), ``train_stablelm`` (stablelm-12b cut to 4
                 layers, head dim 160, int8 compression, grad_accum 1),
                 ``train_audio`` (musicgen-medium whole, 48 layers, 24
                 heads of 64, int8) and ``train_vlm`` (qwen2-vl-2b whole,
                 28 layers, 12 / 2 heads of 128, int8), both from their
                 embeddings frontend, qwen2-vl's batches with M-RoPE
                 positions of a 16 x 16 patch grid then text
                 (``mrope_grid``), and step 1's quantize launches held bit
                 for bit against plain and their round trip within the
                 reference's bound (``round_trip_quantize``).
                 Each first emits ``<phase>_gates``, on their own
                 weights: one step's loss and whole gradient in f32
                 compute with the kernels against every kernel replaced by
                 its plain version (1e-5 relative, 1e-4 relative L2; the
                 plain route takes the kernels' experts), where a scan
                 backward recomputing every segment from a zero state, a
                 loss without the router's aux term and the attention
                 kernel's LSE shifted by log 2 must fail (a phase
                 whose depth lets f32 rounding alone exceed 1e-4 gates at
                 a depth where it does not, and its own depth within
                 twice the spread of a plain route whose scans run in
                 f64; no phase needs it now).  Then the
                 Trainer's run: exact launches a step (``moe_gmm`` 6 a MoE
                 layer, the forward and the remat recompute; ``mamba_ssm``
                 and ``rwkv6_wkv`` 128 a layer, 64 segments twice;
                 ``flash_attention`` 2 an attention layer; the quantize
                 pair once a parameter tensor with int8), finite losses
                 and gradient norms, median step seconds, tokens/s, MFU
                 (the experts a token visits), peak memory, ``reduced``;
                 each kernel's device ms a step (launches at each shape
                 times the raw-launch ms there), the compression's ms, and
                 one layer's plain scan backward (wall ms and, from
                 ``torch.profiler``, its device ms);
  7b'. prefill_embeds — musicgen-medium and qwen2-vl-2b whole, random f32
                 weights, bf16 compute: 2 x 1,024 prompt embeddings (qwen2-vl
                 with the patch-grid positions) through ``apply_prefill``,
                 then 8 ``apply_decode`` steps of (2, 1, d) embeddings:
                 exactly one flash launch a layer in the prefill (48, 28)
                 and none in decode, every call's logits within 3e-2 of
                 their scale against the same calls with the kernel's plain
                 version, the kernel against plain on its first inputs;
  7c. the mesh (``launch/mesh.py``, ``parallel/``, ``Trainer(mesh=...)``):
     mesh_train    — a NCCL process group of one rank (a ``FileStore`` in a
                 temporary directory; no fallback when NCCL cannot start)
                 and ``parse_mesh("1x1")`` on cuda:0; the sharded
                 ``Trainer(cfg, mesh=mesh, compress="int8")`` on qwen3-8b
                 at full width cut to 4 layers (``reduced``), 1 x 4,096,
                 lr 3e-4, 5 steps, params and moments DTensors; then, its
                 weights freed, the same 5 steps from the same seed without
                 a mesh: losses and gradient norms within 1e-5 relative
                 (``bit_equal`` says whether they are), exact launches a
                 step in both (flash 2 a layer, the quantize pair once a
                 parameter tensor); the NCCL kernels of one more meshed step
                 (``torch.profiler``), both runs' median step seconds,
                 tokens/s and peak memory;
     compressed_psum — ``compressed_psum_int8`` on the one-rank group at an
                 MLP weight's shape (14,336 x 4,096 f32) through the
                 quantize kernels, bit-equal to the plain route, one launch
                 of each; then the process group is destroyed;
  7d. tensor parallelism (``parallel/ctx.py``'s collectives, the TP forms
     of ``models/``): two ranks, one process each (this script with
     ``--tp-worker``), on a 1 x 2 mesh over gloo carrying CUDA tensors (NCCL
     takes one rank a device), sharing cuda:0; each rank's records carry
     its launches, and the kernels line counts both ranks':
     tp_train      — qwen2.5-32b at full width cut to 2 layers, grad_accum
                 1, no compression, 1 x 4,096, lr 3e-4, 5 steps: the
                 config's one-process run, then ``Trainer(mesh=...)`` on
                 the two ranks (each its 20 q heads and 4 KV heads, G 5,
                 half of every projection, the vocab-parallel loss):
                 losses within ``TP_LOSS_RTOL`` and gradient norms within
                 ``TP_GNORM_RTOL`` relative, the ranks' equal; exact flash
                 launches on each; the flash kernel against its plain
                 version on the rank's first inputs;
     tp_prefill    — grok-1-314b (2 layers) and jamba-v0.1-52b (8 layers),
                 bf16 weights: 2 prompts of 512 tokens through the
                 one-process prefill (experts recorded), then on the two
                 ranks (each placed by the prefill rule table, drawn one
                 rank at a time) with the routing pinned to those experts:
                 logits within 3e-2 of their scale, the same argmax but
                 near-ties; then ``make_prefill_step(cfg, mesh)`` routing
                 on its own (flips and next tokens reported); exact
                 launches of both (flash at H 24 / Kv 4 and H 16 / Kv 4,
                 ``moe_gmm`` at f 16,384 and at 8 local experts,
                 ``mamba_ssm`` at 4,096 channels), each kernel against its
                 plain version on the first inputs the pinned run gave it;
     tp_decode     — qwen2.5-32b (2 layers), jamba-v0.1-52b (8 layers; in
                 f32 compute for its gate, then in bf16 reported) and
                 rwkv6-3b (2 layers), bf16 weights: a one-process prefill
                 of 2 x 1,024 tokens into a cache of 1,032 positions and
                 8 greedy decode steps (tokens and experts recorded), then
                 the cache placed by ``steps.shard_cache`` on the two
                 ranks (half of each KV sequence, of the conv and SSM
                 channels, of the WKV heads) and the 8 steps on the decode
                 rule table's weights with the one-process tokens and
                 experts: each step's logits within 3e-2 of their scale,
                 the same argmax but near-ties; exact launches per rank
                 (``moe_gmm`` on 8 local experts, ``mamba_ssm`` on 4,096
                 channels, ``rwkv6_wkv`` on 20 heads), peak memory beside
                 the one process's, each kernel against its plain version
                 on the rank's first inputs;
     sp_prefill    — yi-6b, granite-moe-1b-a400m and rwkv6-3b (2 layers
                 each), bf16 weights replicated, 2 x 2,048 tokens with the
                 sequence over the two ranks: the logits of every rank and
                 the caches (KV concatenated over the ranks' positions,
                 the RWKV states) within 3e-2 of their scale of the
                 one-process prefill; flash launches per rank and layer
                 (rank 0 one causal, rank 1 one causal and one full over
                 rank 0's keys), ``rwkv6_wkv`` once a layer on each rank,
                 each kernel against its plain version on the rank's
                 first inputs;
     dryrun        — host only: ``python -m repro_torch.launch.dryrun --mesh
                 both`` for qwen3-8b train_4k, jamba-v0.1-52b prefill_32k,
                 grok-1-314b decode_32k and rwkv6-3b long_500k, one
                 subprocess a cell, all at once, each to exit 0; then
                 ``python -m repro_torch.roofline.analysis`` on qwen3-8b
                 train_4k; prints each record's per-device argument and
                 peak GB, FLOP, bytes accessed, collective GB and counts,
                 the roofline terms and the wall seconds;
  7e. examples     — the seven walkthroughs of ``examples/torch/``, each run
                 as a user runs it (no arguments: cuda:0) in a process of
                 its own (this script with ``--example``), all started
                 together beside the dry run: each to exit 0 with its own
                 assertions, having launched exactly its kernels
                 (``EXAMPLE_KERNELS``; ``vpc_chain`` 6 fused datapath
                 launches and 1 ChaCha20, printing its bit-exact line);
                 their wall seconds, launches and output (also in
                 ``chiprun_out/examples/``);
  8. the ``{"kernels": [...]}`` line: per kernel (all eight) its launches
     on each path that ran it, each counted from 0 just before the path's
     run (``launches_by_path``; ``launches`` their sum), time, plain time,
     bound and, where one PyTorch call computes the same function, that
     call's time; the train phases' per-launch ms, bound and library ms at
     their own shapes (``train_paths``), and serve_stablelm's for the
     flash kernel at head dim 160 (``serve_paths``);
and last ``{"ok": true, "device": {...}}``.  Phase 3 also holds the
flash-attention kernel against its plain version over causal and not,
G in {1, 2, 3, 4, 5, 6, 8}, hd in {64, 128, 160}, S in {1, 7, 63, 65,
128, 129, 1000, 1237, 2051}, B in {1, 4}, bf16 and f32 (the reference's
tolerances: 3e-2 and 2e-5), 1,512 cases; the grouped matmul over E in {1, 16, 32}, M in {1,
2, 7, 63, 64, 65, 200, 448, 800}, six (d, f) widths and its three dtype
routes (same tolerances), 432 cases; and the selective
scan over B in {1, 4}, S in {1, 7, 31, 32, 33, 128, 1000}, di in {64, 100,
8192, 8196}, from a zero and a carried state (1e-4), 112 cases; and the
WKV scan over B in {1, 4}, S in {1, 7, 15, 16, 17, 64, 1000, 1421}, H in
{4, 40, 70}, hd in {16, 32, 64}, from a zero and a carried state (1e-4 of
the plain version's largest value plus 1e-4), 288 cases and one with rows off
16-byte alignment; both scans again in place, bit-equal to out of place; the
flash kernel's LSE beside its output; and the quantize pair bit for bit
(NaN equal to NaN) over R in {1, 3, 256}, D in {1, 127, 4,097,
1,048,576}, f32 and bf16 in and out, one 622,329,856-element row, an
all-zero row, one 1e30 among 1e-30s, rows of randn scaled from 1e-40 to
1e38 (denormals, a scale beyond the kernel's fast reciprocal, infs),
views at an odd element offset, and the quantize kernel's edges: D on
each side of one block's shared-memory hold and of the whole grid's,
more rows than resident blocks, 70,000 rows and D = 0.  With
``--profile`` the main-path and serve records also carry a
``torch.profiler`` breakdown of one more run (device busy time against wall
time; full tables in ``chiprun_out/chip_smoke_profile*.txt``), the train
phase's of one more step.  Any
mismatch raises, so the script exits non-zero; without a CUDA device it
exits non-zero at once.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM HBM3 rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate and float32 rate outside the tensor
#: cores (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
#: 32-bit integer operations an SM can issue per clock: 4 warp schedulers,
#: each issuing at most one 32-thread instruction per clock (NVIDIA Hopper
#: architecture white paper).  The INT32 pipe alone has 64 lanes per SM, but
#: the compiler also runs integer adds and multiplies on the FMA pipe
#: (IMAD), and a first run measured the ChaCha20 kernel faster than the
#: 64-lane figure allows; the issue rate is the ceiling no mix can pass.
INT_OPS_PER_SM_CLOCK = 128
#: integer operations one ChaCha20 block needs: 80 quarter rounds of 12
#: (4 add, 4 xor, 4 rotate), the 16-word feed-forward add and the 16-word XOR
CHACHA_OPS_PER_BLOCK = 80 * 12 + 16 + 16
#: per rule per packet in the firewall: one three-input logic op
#: t = (dst & mask) ^ prefix, a compare t == 0 and a predicated unsigned
#: max into the packet's best key, once each rule is packed as {prefix,
#: mask, key} with its mask length, index and verdict in the key (as
#: ``csrc/vpc_datapath.cu`` stages it; the first count, 5, kept the length
#: and the verdict apart: and, two compares, two selects)
FW_OPS_PER_RULE = 3
#: NAT flow hash and port: 2 multiplies, 1 shift left, 4 xors, shift, and
NAT_OPS = 9
#: the chip-smoke workload (module level so a CPU rehearsal can shrink it)
RULES = 300
BATCHES = 8
ROWS_A, ROWS_B = 65536, 61440
TIMED_RUNS = 5
WIRE_BYTES_PER_PKT = (5 + 16) * 4
#: the streaming phases: the tenants' weights, the dispatch ring's depth,
#: and the fleet's epochs with the epoch its shard c0 crashes at
TENANT_WEIGHTS = {"A": 2.0, "B": 1.0}
STREAM_RING_DEPTH = 4
FLEET_EPOCHS = 4
FLEET_CRASH_EPOCH = 2
#: the portability trace's schedule fingerprint (BENCH_scenarios.json)
TRACE_FINGERPRINT = "f1a89120f28456dc"
#: the main path's params swapped after its timed runs: the rule table's
#: seed and the NAT address both deployments read from then on
SWAP_RULES_SEED = 9
SWAP_NAT_IP = 0x0B000002
#: profiled runs a device-operation count takes the largest of
DEVICE_OPS_READS = 3
#: the mixed fleet: each sim tenant's Poisson source (3x the sNIC's 100
#: Gbit/s port between the two) and the window, and the band its 2 : 1
#: served-byte ratio must land in
MIXED_SOURCE_GBPS = 300.0
MIXED_PKT_BYTES = 1000
MIXED_MS = 2.0
MIXED_RATIO_REL = 0.10
#: the kill-1-of-4 resilience scenario at its full size (the JAX package's
#: ``benchmarks/bench_resilience.py``): four sim shards, tenants 2:2:1:1,
#: shard 2 crashes at global epoch 13 of 24 chunks x 2 epochs, seed 42;
#: clients offer 0.98x the healthy capacity in 1,500-byte packets
RES_WEIGHTS = {"t0": 2.0, "t1": 2.0, "t2": 1.0, "t3": 1.0}
RES_SHARDS = 4
RES_DEAD_SHARD = 2
RES_SHARD_GBPS = 100.0
RES_EPOCHS_PER_CHUNK = 2
RES_PKT_BYTES = 1500
RES_LOAD_FACTOR = 0.98
RES_CHUNKS, RES_CRASH_EPOCH, RES_SEED = 24, 13, 42
#: the normalized report's fingerprint at that size: what the JAX package's
#: ``bench_resilience._run_once(24, 13, 42)`` gives (the sim is host Python
#: on seeded streams, so the port's must be the same)
RES_FINGERPRINT = "2ff27f240aabca7f"
#: its acceptance: share error and delivered ratio of the last chunk, and
#: the global epochs from the failover to the first chunk back within both
RES_SHARE_ERR_BOUND = 0.05
RES_DELIVERED_BOUND = 0.95
RES_RECOVERY_EPOCH_BOUND = 8
#: special-function-unit results (exp2, the core of expf) an SM returns per
#: clock on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instruction throughput)
SFU_PER_SM_CLOCK = 16
#: the serve phases: phase -> (arch, layers kept or None for all, requests);
#: each serves the same kind of traffic, two tenants (gold 2 : free 1)
SERVE_PHASES = {
    "serve": ("qwen3-8b", None, 12),
    "serve_hybrid": ("jamba-v0.1-52b", 8, 8),
    "serve_moe": ("granite-moe-1b-a400m", None, 8),
    "serve_rwkv": ("rwkv6-3b", None, 8),
    "serve_stablelm": ("stablelm-12b", None, 8),
}
SERVE_PROMPT = (256, 1536)          # prompt lengths, inclusive
SERVE_MAX_NEW = 16
SERVE_MAX_LEN = 2048
SERVE_SEED = 8
#: datapath sweep of phase 3: N 255, 257, 511, 512, 513, 2,049 and
#: (1 << 20) + 3 around the kernel's 256-packet tiles (two packets a
#: thread), R 1,025 one rule into the second 1,024-rule chunk; and the N of
#: each edge-case rule table (``serving.vpc.make_edge_case``)
VPC_SWEEP = dict(N=(1, 255, 257, 511, 512, 513, 2049, (1 << 20) + 3),
                 R=(1, 32, 300, 1025, 5000))
VPC_EDGE_N = (1, 513, 4099)
#: flash-attention sweep of phase 3, and the reference's tolerances
#: (tests/test_kernels.py: assert_allclose atol = rtol)
#: (S 63, 65 and 129 straddle the bf16 body's 64-key tiles and, at G 4 and
#: 8, its 32- and 16-query tiles; 1,237 is serve's prefill group; G 3, 5
#: and 6 leave 126, 125 and 126 of a block's 128 (query, head) rows live,
#: and are the local groups of tensor parallelism: qwen2.5-32b's 40 / 8 and
#: grok-1's 48 / 8 at 2 ranks, qwen2.5-32b's 3 heads of a rank at 16)
FA_SWEEP = dict(causal=(True, False), G=(1, 2, 3, 4, 5, 6, 8),
                hd=(64, 128, 160),
                S=(1, 7, 63, 65, 128, 129, 1000, 1237, 2048 + 3), B=(1, 4),
                dtype=("bfloat16", "float32"))
FA_KV = 2
FA_TOL = {"torch.bfloat16": 3e-2, "torch.float32": 2e-5}
#: grouped-matmul sweep of phase 3: expert counts, row counts, (d, f) widths
#: (Granite's and Jamba's expert FFNs among them) and the wrapper's routes
#: (x dtype, w dtype); E = 32 runs only at widths up to GMM_WIDE_LIMIT
#: elements a matrix, which keeps the sweep in seconds.  The edges of the
#: tensor-core tiling: M 63, 64 and 65 on each side of the decode
#: configuration's 64 rows, 448 (serve_hybrid's prefill, two tiles of 224);
#: d 72 (fewer K tiles than the ring has stages, ragged 32-deep tile),
#: d 100 (not a multiple of 8: x rows gathered element by element), f 264
#: (a ragged 128-column tile) and f 1,030 (not a multiple of 4: weight rows
#: gathered)
GMM_SWEEP = dict(E=(1, 16, 32), M=(1, 2, 7, 63, 64, 65, 200, 448, 800),
                 df=((64, 100), (1024, 512), (4096, 14336), (14336, 4096),
                     (72, 264), (100, 1030)),
                 route=(("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                        ("float32", "float32")))
#: the kernel's dtype codes of the three routes, for the card line
GMM_ROUTE_CODES = (("bf16 x bf16", 1, 1), ("bf16 x f32", 1, 0),
                   ("f32 x f32", 0, 0))
GMM_WIDE_LIMIT = 1024 * 512
#: selective-scan sweep of phase 3, and the reference's tolerance for it
#: (tests/test_kernels.py test_mamba_scan: 1e-4); S 31, 32 and 33 straddle
#: the kernel's 32-step staging chunk, di 100 (not a multiple of 4) takes
#: its 4-byte copies and di 8,196 ends in a partly filled 64-channel block
SCAN_SWEEP = dict(B=(1, 4), S=(1, 7, 31, 32, 33, 128, 1000),
                  di=(64, 100, 8192, 8196), h0=(False, True))
SCAN_DS = 16
SCAN_TOL = 1e-4
#: WKV sweep of phase 3 (``state``: from a zero or a carried state); S 15,
#: 16 and 17 straddle the kernel's 16-step staging chunk, and B x H runs
#: from 4 to 280 pairs, on both sides of the card's 132 SMs: at hd 64 a
#: pair's columns span 8, 4 (B x H = 160) or 2 (280) blocks
WKV_SWEEP = dict(B=(1, 4), S=(1, 7, 15, 16, 17, 64, 1000, 1421),
                 H=(4, 40, 70), hd=(16, 32, 64), state=(False, True))
#: quantize sweep of phase 3 (every case in f32 and bf16 out), and the two
#: rows the compression chain quantizes most: qwen3-8b's embedding (151,936
#: x 4,096) and an MLP weight (4,096 x 12,288), each tensor one row
QUANT_SWEEP = dict(R=(1, 3, 256), D=(1, 127, 4097, 1 << 20),
                   x=("float32", "bfloat16"))
EMBED_ELEMENTS = 151936 * 4096
MLP_ELEMENTS = 4096 * 12288
#: the rows the kernels line times: those two and the attention
#: projections (q and o 4,096 x 4,096; k and v 4,096 x 1,024)
QUANT_ROWS = {"embedding": EMBED_ELEMENTS, "mlp": MLP_ELEMENTS,
              "attn_qo": 4096 * 4096, "attn_kv": 4096 * 1024}
#: scales of the magnitude sweep: denormal, tiny, moderate, large, a scale
#: above the kernel's fast reciprocal (x / s itself) and one near f32's
#: largest, where some of randn's draws overflow to inf (a scale of inf)
QUANT_MAGNITUDES = (1e-40, 1e-30, 1e-3, 1e20, 1e35, 1e38)
#: the train phase: qwen3-8b at full width cut to 8 layers (five f32 copies
#: of its 2.79 B parameters, 55.8 GB, fit the card; all 36 layers would
#: need 164 GB), batch 1 x 4,096 tokens (the reference's train_4k
#: sequence), int8 compression
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS = 8
TRAIN_B, TRAIN_S = 1, 4096
TRAIN_STEPS = 5
TRAIN_LR = 3e-4
TRAIN_SEED = 16
#: the family train phases: phase -> (arch, layers kept or None for all,
#: gradient compression), each at full width, batch TRAIN_B x TRAIN_S,
#: TRAIN_STEPS steps at TRAIN_LR, random f32 weights from TRAIN_SEED.
#: Granite whole with int8 (1.38 B parameters, five f32 copies ~28 GB);
#: Jamba's first two layers (Mamba + MLP, Mamba + 16-expert MoE: 3.74 B,
#: 2.82 B of them the MoE; f32 masters, bf16 copies and gradients, f32
#: moments ~60 GB; int8's f32 gradients and EF would need ~75 GB), its
#: grad_accum 4 -> 1; RWKV-6 cut to 2 of 32 layers (0.51 B) for time:
#: its backward recomputes 4,096 plain scan steps a layer on the host, and
#: through 2 random layers f32 rounding of the scan moves the gradient by
#: 3.6e-6 relative L2 (a plain route with the scan in f64 against the f32
#: one), under the gate's 1e-4 (through 8: 8.3e-4, PERF.md section 6);
#: StableLM (head dim 160, LayerNorm) cut to 4 of 40 layers with int8
#: (2.14 B, five f32 copies ~43 GB; all 40 would need ~240 GB), its
#: grad_accum 2 -> 1 (a batch of one sequence).  The last field is the
#: depth of the f32 gate where it is not the phase's (None: the phase's
#: own), the phase's depth then held within twice the spread of a plain
#: route whose scans run in f64.  The two embeddings-frontend
#: configs run whole with int8: musicgen-medium (48 LayerNorm + GELU
#: layers, 24 heads of 64, 1.36 B parameters in 485 tensors) and
#: qwen2-vl-2b (28 layers, 12 / 2 heads of 128 with M-RoPE, an untied
#: 151,936 x 1,536 head: 1.54 B in 255 tensors); five f32 copies ~27 and
#: ~31 GB
TRAIN_FAMILIES = {
    "train_moe": ("granite-moe-1b-a400m", None, "int8", None),
    "train_hybrid": ("jamba-v0.1-52b", 2, "none", None),
    "train_rwkv": ("rwkv6-3b", 2, "none", None),
    "train_stablelm": ("stablelm-12b", 4, "int8", None),
    "train_audio": ("musicgen-medium", None, "int8", None),
    "train_vlm": ("qwen2-vl-2b", None, "int8", None),
}
#: the family phases whose Trainer run holds step 1's quantize launches
#: (one a parameter tensor) bit for bit against the plain version and
#: their int8 round trip within the reference's bound
#: (``tests/test_kernels.py::test_quantize_property``: |dequant(quant(x))
#: - x| <= max|row| / 254 * 1.05 + 1e-5)
ROUND_TRIP_PHASES = ("train_audio", "train_vlm")
#: an M-RoPE config's batches (train and prefill): each row an image then
#: text, as Qwen2-VL numbers them; the first 16 x 16 positions a patch
#: grid (t constant, h the row, w the column), the text then from the
#: grid's largest index + 1 on all three
MROPE_GRID = (16, 16)
#: the embeddings-frontend serve path: each config of PREFILL_EMBEDS whole,
#: random f32 weights from PE_SEED, bf16 compute; PE_B x PE_S prompt
#: embeddings through ``apply_prefill`` into a cache of PE_S + PE_STEPS
#: positions, then PE_STEPS ``apply_decode`` steps of (PE_B, 1, d)
#: embeddings (M-RoPE: all three indices the cache position, the JAX
#: package's decode convention): every step's logits within
#: TP_LOGITS_TOL of their scale against the same calls with every
#: kernel's plain version
PREFILL_EMBEDS = ("musicgen-medium", "qwen2-vl-2b")
PE_B, PE_S, PE_STEPS, PE_SEED = 2, 1024, 8, 27
#: the walkthroughs, each run on cuda:0 as a user runs it, in a process
#: of its own (this script with ``--example``), all at once and beside the
#: host-only dry run; their launches counted from 0 in each process
EXAMPLES = ("quickstart", "vpc_chain", "multi_tenant", "sharded_rack",
            "fault_tolerance", "disaggregated_kv", "serve_e2e")
EXAMPLE_TIMEOUT_S = 600
#: the mesh phases: the sharded Trainer on a NCCL group of one rank and a
#: 1 x 1 mesh, qwen3-8b at full width cut to MESH_LAYERS layers, int8,
#: TRAIN_B x TRAIN_S, TRAIN_STEPS steps, against the same run without a
#: mesh (the train gates' 1e-5 relative on losses and gradient norms: the
#: embedding's backward on the card accumulates with atomics, so two runs
#: need not be bit-equal); compressed_psum at an MLP weight's shape
MESH_LAYERS = 4
MESH_RTOL = 1e-5
PSUM_SHAPE = (14336, 4096)
#: tensor parallelism on the card: the ranks of a 1 x 2 mesh ("data" 1,
#: "model" 2), one process each (this script with ``--tp-worker``), share
#: the one H100 over gloo carrying CUDA tensors (NCCL takes one rank a
#: device; gloo runs every collective of the TP steps on CUDA tensors
#: itself, none staged through host memory by the port).  tp_train:
#: TP_TRAIN's config at full width, cut to its layers, grad_accum 1, no
#: compression, TRAIN_B x TRAIN_S, TRAIN_STEPS steps, against the same
#: config's one-process run: losses within TP_LOSS_RTOL and gradient norms
#: within TP_GNORM_RTOL relative at every step (bf16 compute; the
#: tolerances' reason is in PERF.md §6, PR 25).  tp_prefill: TP_PREFILL_B
#: prompts of TP_PREFILL_S tokens through each (arch, layers) of
#: TP_PREFILL with bf16 weights and compute, against the one-process
#: prefill, the routing pinned to its experts: logits within TP_LOGITS_TOL
#: of their scale and the same argmax except near-ties (a reference gap
#: within that tolerance); then once routed on their own (flips counted)
TP_MESH = (1, 2)
TP_TRAIN = ("qwen2.5-32b", 2)
TP_LOSS_RTOL, TP_GNORM_RTOL = 1e-3, 1e-2
TP_PREFILL = (("grok-1-314b", 2), ("jamba-v0.1-52b", 8))
TP_PREFILL_B, TP_PREFILL_S, TP_SEED = 2, 512, 25
TP_LOGITS_TOL = 3e-2
TP_TIMEOUT_S = 600
#: the split serve path on the same two ranks.  tp_decode: each (arch,
#: layers, compute dtype, gated) of TP_DECODE, bf16 weights (held in f32
#: for f32 compute), a one-process prefill of TP_DECODE_B x
#: TP_DECODE_PROMPT tokens into a cache of TP_DECODE_MAX positions, placed
#: by ``steps.shard_cache`` (each rank half of every KV sequence and of the
#: scans' state features), then TP_DECODE_STEPS decode steps on the decode
#: rule table's tensor-parallel weights, on the one-process run's greedy
#: tokens with its experts pinned: every step's logits within
#: TP_LOGITS_TOL of their scale, the same argmax but near-ties.  Jamba's
#: random-weight 8 layers turn the ranks' other bf16 summation order into
#: 2-3 % of the logits' scale, so its gate runs in f32 compute and its
#: bf16 run is reported beside it, not gated.  sp_prefill: each (arch, layers) of SP_PREFILL (fsdp_only:
#: replicated weights), SP_PREFILL_B x SP_PREFILL_S tokens, the sequence
#: over the two ranks: the logits and the caches gathered within
#: TP_LOGITS_TOL of their scale of the one-process prefill (the reasons in
#: PERF.md §6)
TP_DECODE = (("qwen2.5-32b", 2, "bfloat16", True),
             ("jamba-v0.1-52b", 8, "float32", True),
             ("jamba-v0.1-52b", 8, "bfloat16", False),
             ("rwkv6-3b", 2, "bfloat16", True))
TP_DECODE_B, TP_DECODE_PROMPT, TP_DECODE_STEPS = 2, 1024, 8
TP_DECODE_MAX = TP_DECODE_PROMPT + TP_DECODE_STEPS
SP_PREFILL = (("yi-6b", 2), ("granite-moe-1b-a400m", 2), ("rwkv6-3b", 2))
SP_PREFILL_B, SP_PREFILL_S = 2, 2048
#: the dry run's cells on the card's host (both production meshes each,
#: one subprocess a cell, all at once), and the cell under the roofline
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
                ("grok-1-314b", "decode_32k"), ("rwkv6-3b", "long_500k"))
ROOFLINE_CELL = ("qwen3-8b", "train_4k")
DRYRUN_TIMEOUT_S = 400
#: the card's restart check: relative loss difference after the restore
#: (the embedding's backward accumulates with atomics)
RESTART_RTOL = 1e-3
#: the WKV tolerance: |got - want| <= WKV_TOL * max|want| + WKV_TOL.  The
#: reference's absolute 1e-4 holds only at its small inputs: at a served
#: prefill (S ~ 1,400, r/k/v ~ N(0, 1), decay ~ 0.9975) |y| reaches
#: hundreds, and tens of thousands on left-padded rows, where two f32
#: summation orders differ by ~1e-7 of it
WKV_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` from CUDA events, after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def raw_launch(lib: str, entry: str, ptrs: list, keep):
    """A closure around one C entry point with fixed arguments (``keep``
    holds the output tensors alive).  Timing it measures the kernel on the
    device without the wrapper's checks and allocations between launches,
    so the GPU, not the host, is the bottleneck."""
    from repro_torch.kernels import _build
    fn = getattr(_build.library(lib), entry)

    def launch():
        _build.check(fn(*ptrs), entry)
    launch.keep = keep
    return launch


def raw_vpc(a):
    import torch

    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    outs = vpc_datapath_cuda(**a)
    return raw_launch("vpc_datapath", "vpc_datapath_launch", [
        a["headers"].data_ptr(), a["payload"].data_ptr(), a["ctr"].data_ptr(),
        a["rule_table"].data_ptr(), a["key"].data_ptr(), a["nonce"].data_ptr(),
        a["nat_ip"].data_ptr(), a["salt"], outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), a["headers"].shape[0],
        a["rule_table"].shape[0], torch.cuda.current_stream().cuda_stream],
        outs)


def raw_chacha(data, key, nonce, counter0: int):
    import torch
    out = torch.empty_like(data)
    return raw_launch("chacha20", "chacha20_xor_launch", [
        data.data_ptr(), out.data_ptr(), key.data_ptr(), nonce.data_ptr(),
        counter0, data.shape[0], torch.cuda.current_stream().cuda_stream],
        out)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def u32(rng, shape):
    import torch
    return torch.from_numpy(rng.integers(0, 2 ** 32, shape, dtype=np.uint32))


class Card:
    """Peak rates of the card this run is on."""

    def __init__(self):
        import torch
        props = torch.cuda.get_device_properties(0)
        self.name = torch.cuda.get_device_name(0)
        self.sms = props.multi_processor_count
        self.smi = nvidia_smi("name,power.limit")
        self.clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.int_ops_per_s = self.sms * INT_OPS_PER_SM_CLOCK * \
            self.clock_mhz * 1e6
        self.sfu_per_s = self.sms * SFU_PER_SM_CLOCK * self.clock_mhz * 1e6

    def bound(self, nbytes: float, ops: float,
              ops_per_s: float | None = None) -> tuple[float, str]:
        """Least ms for ``nbytes`` moved and ``ops`` done at ``ops_per_s``
        (default: the integer issue rate), and which of the two binds."""
        return self.bound_of(nbytes, [(ops, ops_per_s or self.int_ops_per_s)])

    @staticmethod
    def bound_of(nbytes: float, work: list) -> tuple[float, str]:
        """Least ms for ``nbytes`` moved and each (ops, ops per second) of
        ``work`` done, the kinds of operation on units that run at once,
        and which binds."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(ops / rate * 1e3 for ops, rate in work)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ 3. kernels ----
RFC_KEY = [0x03020100, 0x07060504, 0x0b0a0908, 0x0f0e0d0c,
           0x13121110, 0x17161514, 0x1b1a1918, 0x1f1e1d1c]
RFC_NONCE = [0x09000000, 0x4a000000, 0x00000000]
RFC_BLOCK1 = [0xe4e7f110, 0x15593bd1, 0x1fdd0f50, 0xc47120a3,
              0xc7f4d1c7, 0x0368c033, 0x9aaa2204, 0x4e6cd4c3,
              0x466482d2, 0x09aa9f07, 0x05d7c214, 0xa2028bd9,
              0xd19c12b5, 0xb94e16de, 0xe883d0cb, 0x4e3c50a2]


def check_chacha(dev) -> list:
    import torch

    from repro_torch.kernels.chacha20 import ref
    from repro_torch.kernels.chacha20.kernel import (chacha20_xor_cuda,
                                                     chacha20_xor_plain)
    cases = []
    rng = np.random.default_rng(11)
    for n in (1, 511, 513, 1 << 20):
        for c0 in (1, 2 ** 32 - 300):          # the second one wraps
            data = u32(rng, (n, 16)).to(dev)
            key, nonce = u32(rng, (8,)).to(dev), u32(rng, (3,)).to(dev)
            got = chacha20_xor_cuda(data, key, nonce, c0)
            torch.cuda.synchronize()
            expect(torch.equal(got, chacha20_xor_plain(data, key, nonce, c0)),
                   f"chacha20_xor N={n} counter0={c0} differs from plain")
            cases.append([n, c0])
    key = torch.tensor(RFC_KEY, dtype=torch.int64).to(torch.uint32).to(dev)
    nonce = torch.tensor(RFC_NONCE, dtype=torch.int64).to(torch.uint32).to(dev)
    zero = torch.zeros((1, 16), dtype=torch.uint32, device=dev)
    got = chacha20_xor_cuda(zero, key, nonce, 1).cpu().numpy()[0]
    expect(got.tolist() == RFC_BLOCK1, "RFC 8439 2.3.2 keystream block")
    data = rng.integers(0, 2 ** 32, (64, 16), dtype=np.uint32)
    k, nc = (rng.integers(0, 2 ** 32, s, dtype=np.uint32) for s in (8, 3))
    got = chacha20_xor_cuda(torch.from_numpy(data).to(dev),
                            torch.from_numpy(k).to(dev),
                            torch.from_numpy(nc).to(dev), 7).cpu().numpy()
    expect(np.array_equal(got, ref.chacha20_xor_ref(data, k, nc, 7)),
           "chacha20_xor N=64 differs from the numpy RFC 8439 oracle")
    return cases


def vpc_inputs(rng, n, r, dev):
    import torch

    from repro_torch._u32 import arange32, narrow
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    from repro_torch.serving.vpc import make_packets, make_rules
    h, p = make_packets(n, seed=int(rng.integers(1 << 30)), device=dev)
    rules = make_rules(r, seed=int(rng.integers(1 << 30)), device=dev)
    return dict(headers=h, payload=p, ctr=narrow(arange32(1, n, dev)),
                rule_table=rule_table(rules, dev),
                key=u32(rng, (8,)).to(dev), nonce=u32(rng, (3,)).to(dev),
                nat_ip=torch.tensor([0x0A000001], dtype=torch.int64)
                .to(torch.uint32).to(dev), salt=0x9e3779b9)


def same_values(a, b) -> bool:
    """``torch.equal`` with a NaN equal to a NaN in the same place: a row
    holding an inf or a NaN has a NaN or inf scale, and its dequantized
    values are NaN (0 x inf), in the kernel and the plain version alike."""
    import torch
    nan_a = a.isnan() if a.is_floating_point() else torch.zeros_like(
        a, dtype=torch.bool)
    nan_b = b.isnan() if b.is_floating_point() else torch.zeros_like(
        b, dtype=torch.bool)
    return a.dtype == b.dtype and torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0), b.masked_fill(nan_b, 0))


def same_triple(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_vpc(dev) -> list:
    import torch

    from repro_torch.kernels.vpc_datapath import vpc_datapath
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    from repro_torch.serving.vpc import EDGE_CASES, make_edge_case
    cases = []
    rng = np.random.default_rng(12)
    for n in VPC_SWEEP["N"]:
        for r in VPC_SWEEP["R"]:
            args = vpc_inputs(rng, n, r, dev)
            for ctr_kind in ("default", "explicit"):
                if ctr_kind == "explicit":
                    args["ctr"] = u32(rng, (n,)).to(dev)
                got = vpc_datapath_cuda(**args)
                torch.cuda.synchronize()
                expect(same_triple(got, vpc_datapath_plain(**args)),
                       f"vpc_datapath N={n} R={r} ctr={ctr_kind} differs "
                       "from plain")
                cases.append([n, r, ctr_kind])
    # the packed key's edges: a /0 deny last, /32 rules, equal lengths at
    # index 0 and R - 1, all-deny and all-allow tables, the second chunk
    for kind in EDGE_CASES:
        for n in VPC_EDGE_N:
            h, p, rules = make_edge_case(kind, n, seed=n, device=dev)
            args = vpc_inputs(rng, n, 1, dev)
            args.update(headers=h, payload=p, rule_table=rule_table(rules,
                                                                    dev))
            got = vpc_datapath_cuda(**args)
            torch.cuda.synchronize()
            expect(same_triple(got, vpc_datapath_plain(**args)),
                   f"vpc_datapath {kind} N={n} differs from plain")
            cases.append([kind, n, int(got[0].sum())])
    # overlapping prefixes: /16 deny beats /8 allow; equal /16s: first wins
    t = lambda v: torch.tensor(v, dtype=torch.int64).to(torch.uint32).to(dev)
    rules = (t([0x0A000000, 0x0A010000, 0x0A010000]),
             t([0xFF000000, 0xFFFF0000, 0xFFFF0000]),
             torch.tensor([True, False, True], device=dev))
    h = t([[1, 0x0A010203, 2, 3, 4], [1, 0x0A220203, 2, 3, 4],
           [1, 0x0B000000, 2, 3, 4]])
    p = torch.zeros((3, 16), dtype=torch.uint32, device=dev)
    allow, _, _ = vpc_datapath(h, p, rules, t(list(range(8))), t([1, 2, 3]))
    expect(allow.cpu().tolist() == [False, True, True], "LPM tie-break")
    expect(rule_table(rules, dev).shape == (3, 4), "rule table shape")
    cases.append("tie-break")
    return cases


def fa_inputs(rng, B, S, H, Kv, hd, dtype, dev):
    import torch
    td = getattr(torch, dtype.split(".")[-1])
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, td) for shape in ((B, S, H, hd), (B, S, Kv, hd),
                                       (B, S, Kv, hd))]


def close(got, want, what: str, tol: float | None = None) -> float:
    """Max abs error of ``got`` against the plain ``want``; raises unless
    every element is within the reference's tolerance (|a - b| <= tol +
    tol * |b|, tol by dtype unless given)."""
    tol = FA_TOL[str(want.dtype)] if tol is None else tol
    a, b = got.float(), want.float()
    err = (a - b).abs()
    expect(bool((err <= tol + tol * b.abs()).all()),
           f"{what} differs from plain beyond {tol}: max abs error "
           f"{float(err.max())}")
    return float(err.max())


def check_flash(dev) -> dict:
    """The flash-attention kernel against its plain version over the sweep,
    the output and the rows' log-sum-exp, and the output the same with and
    without the LSE; returns the case count and the largest errors per
    dtype."""
    import itertools

    import torch

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    rng = np.random.default_rng(13)
    worst = {d: 0.0 for d in FA_SWEEP["dtype"]}
    worst_lse = dict(worst)
    n = 0
    for causal, G, hd, S, B, dtype in itertools.product(
            *(FA_SWEEP[k] for k in ("causal", "G", "hd", "S", "B",
                                    "dtype"))):
        q, k, v = fa_inputs(rng, B, S, FA_KV * G, FA_KV, hd, dtype, dev)
        got, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = attention_ref(q, k, v, causal, return_lse=True)
        what = f"flash_attention causal={causal} G={G} hd={hd} S={S} B={B}"
        err = close(got, want, what)
        expect(torch.equal(got, flash_attention_cuda(q, k, v, causal)),
               what + ": the output differs with and without the LSE")
        worst[dtype] = max(worst[dtype], err)
        worst_lse[dtype] = max(worst_lse[dtype], close(
            lse, want_lse, what + " lse", FA_TOL[str(q.dtype)]))
        n += 1
    return {"cases": n, "kv_heads": FA_KV, "sweep": FA_SWEEP,
            "max_abs_err": worst, "lse_max_abs_err": worst_lse}


def check_moe_gmm(dev) -> dict:
    """The grouped-matmul kernel against its plain version over the sweep
    (weights scaled by d^-0.5 as the reference's test and the model draw
    them); returns the case count and the largest error per route."""
    import itertools

    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_ref
    gen = torch.Generator(device=dev).manual_seed(14)
    worst: dict[str, float] = {}
    n = 0
    for E, (d, f), (xd, wd) in itertools.product(
            GMM_SWEEP["E"], GMM_SWEEP["df"], GMM_SWEEP["route"]):
        if E == max(GMM_SWEEP["E"]) and d * f > GMM_WIDE_LIMIT:
            continue
        w = (torch.randn((E, d, f), generator=gen, device=dev)
             * d ** -0.5).to(getattr(torch, wd))
        route = f"x {xd}, w {wd}"
        for M in GMM_SWEEP["M"]:
            x = torch.randn((E, M, d), generator=gen, device=dev).to(
                getattr(torch, xd))
            got = moe_gmm_cuda(x, w)
            torch.cuda.synchronize()
            err = close(got, moe_gmm_ref(x, w),
                        f"moe_gmm E={E} M={M} d={d} f={f} {route}")
            worst[route] = max(worst.get(route, 0.0), err)
            n += 1
        del w
    return {"cases": n, "sweep": GMM_SWEEP, "wide_limit": GMM_WIDE_LIMIT,
            "max_abs_err": worst}


def scan_inputs(gen, B, S, di, dev, h0: bool):
    """The reference test's distributions: x, B, C, D normal, dt =
    softplus(N - 1), A = -exp(N / 2); h0 normal or none."""
    import torch
    import torch.nn.functional as F

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return dict(x=n(B, S, di), dt=F.softplus(n(B, S, di) - 1.0),
                Bmat=n(B, S, SCAN_DS), Cmat=n(B, S, SCAN_DS),
                A=-torch.exp(n(di, SCAN_DS) * 0.5), D=n(di),
                h0=n(B, di, SCAN_DS) if h0 else None)


def check_mamba(dev) -> dict:
    """The selective-scan kernel against its plain version over the sweep,
    y and the final state, and once more with the state updated in place
    (h0 passed as the output too, as the decode does)."""
    import itertools

    import torch

    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda, mamba_ssm_ref
    gen = torch.Generator(device=dev).manual_seed(15)
    worst = 0.0
    n = 0
    for B, S, di, h0 in itertools.product(
            *(SCAN_SWEEP[k] for k in ("B", "S", "di", "h0"))):
        a = scan_inputs(gen, B, S, di, dev, h0)
        y, h = mamba_ssm_cuda(**a)
        want_y, want_h = mamba_ssm_ref(**a)
        torch.cuda.synchronize()
        what = f"mamba_ssm B={B} S={S} di={di} h0={h0}"
        worst = max(worst, close(y, want_y, what + " y", SCAN_TOL),
                    close(h, want_h, what + " h_final", SCAN_TOL))
        if h0:
            state = a["h0"].clone()
            y2, h2 = mamba_ssm_cuda(**{**a, "h0": state}, h_out=state)
            torch.cuda.synchronize()
            expect(h2 is state and torch.equal(y2, y) and
                   torch.equal(state, h), what + " in place differs")
        n += 1
    return {"cases": n, "sweep": SCAN_SWEEP, "d_state": SCAN_DS,
            "max_abs_err": worst}


def wkv_inputs(gen, B, S, H, hd, dev, state: bool):
    """r, k halved and v normal, as the reference's test; decays w =
    exp(-exp(U(-6, 0))) from 0.37 to the slow 0.9975 of the model's init
    (w0 = -6); u normal / 10; the state normal or none."""
    import torch

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    lw = torch.rand((B, S, H, hd), generator=gen, device=dev) * 6.0 - 6.0
    return dict(r=n(B, S, H, hd) * 0.5, k=n(B, S, H, hd) * 0.5,
                v=n(B, S, H, hd), w=torch.exp(-torch.exp(lw)),
                u=n(H, hd) * 0.1, state0=n(B, H, hd, hd) if state else None)


def wkv_close(y, st, want_y, want_st, what: str) -> float:
    """Largest abs error of a WKV result, y (B, S, H, hd) and the final
    state (B, H, hd, hd), against the plain one; raises unless every
    element is within WKV_TOL of its own (batch, head)'s largest |plain|
    plus WKV_TOL (a left-padded row's |y| may be 100x its neighbour's)."""
    worst = 0.0
    for got, want, dims, name in ((y, want_y, (1, 3), "y"),
                                  (st, want_st, (2, 3), "state")):
        err = (got - want).abs()
        bound = WKV_TOL * want.abs().amax(dims, keepdim=True) + WKV_TOL
        ratio = float((err / bound).max())
        expect(ratio <= 1.0, f"{what} {name} differs from plain by "
               f"{ratio} x its (batch, head)'s bound")
        worst = max(worst, float(err.max()))
    return worst


def check_rwkv(dev) -> dict:
    """The WKV kernel against its plain version over the sweep, y and the
    final state, and once more with the state updated in place (the state
    passed as the output too, as the decode does)."""
    import itertools

    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = 0.0
    n = 0
    for B, S, H, hd, state in itertools.product(
            *(WKV_SWEEP[k] for k in ("B", "S", "H", "hd", "state"))):
        a = wkv_inputs(gen, B, S, H, hd, dev, state)
        y, st = rwkv6_wkv_cuda(**a)
        want_y, want_st = rwkv6_wkv_ref(*(a[k] for k in "rkvwu"),
                                        a["state0"])
        torch.cuda.synchronize()
        what = f"rwkv6_wkv B={B} S={S} H={H} hd={hd} state={state}"
        worst = max(worst, wkv_close(y, st, want_y, want_st, what))
        if state:
            buf = a["state0"].clone()
            y2, st2 = rwkv6_wkv_cuda(**{**a, "state0": buf}, state_out=buf)
            torch.cuda.synchronize()
            expect(st2 is buf and torch.equal(y2, y) and
                   torch.equal(buf, st), what + " in place differs")
        n += 1
    # r, k, v, w one element into their storage: rows off 16-byte
    # alignment take the kernel's 4-byte copies
    a = wkv_inputs(gen, 2, 33, 4, 64, dev, True)
    odd = {k: torch.empty(v.numel() + 1, device=dev)[1:].view(v.shape)
           .copy_(v) if k in ("r", "k", "v", "w") else v
           for k, v in a.items()}
    y, st = rwkv6_wkv_cuda(**odd)
    want_y, want_st = rwkv6_wkv_ref(*(a[k] for k in "rkvwu"), a["state0"])
    torch.cuda.synchronize()
    worst = max(worst, wkv_close(y, st, want_y, want_st,
                                 "rwkv6_wkv unaligned rows"))
    return {"cases": n + 1, "sweep": WKV_SWEEP, "unaligned_case": True,
            "tol": "1e-4 * max|plain| + 1e-4", "max_abs_err": worst}


# ---------------------------------------------------------- 4. main path ----
def fair_groups(log, rows_of):
    """Replay the runtime's coalescing on a dispatch log: consecutive
    entries of one tenant merge; returns [(tenant, rows), ...]."""
    groups = []
    for tenant, cost in log:
        rows = rows_of(cost)
        if groups and groups[-1][0] == tenant:
            groups[-1][1] += rows
        else:
            groups.append([tenant, rows])
    return [tuple(g) for g in groups]


def main_path(dev, card: Card | None, profile: bool = False):
    """Drive the port's main path (on the CPU too, for a rehearsal with the
    module constants shrunk and ``card=None``); returns the phase record,
    the inputs of the most frequent dispatch (for the kernels line) and the
    kernel's launches in the timed runs."""
    rules_n, batches, timed_runs = RULES, BATCHES, TIMED_RUNS
    import torch

    from repro_torch._u32 import arange32, narrow, where32
    from repro_torch.api.compute_backend import bucket_size
    from repro_torch.kernels.chacha20.kernel import chacha20_xor
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    from repro_torch.kernels.vpc_datapath.ops import rule_table

    params, traffic, rng = datapath_setup(dev, host=False)
    plat, deps = vpc_platform(dev, params)
    backend = plat.backend
    tenants = TENANT_WEIGHTS

    def one_run():
        for name in tenants:
            for h, p in traffic[name]:
                deps[name].inject(headers=h, payload=p)
        plat.run()
        return list(backend.dispatch_log)

    def launches():
        return vpc_datapath_cuda.launches

    logs = [one_run()]                      # warm-up (builds nothing new)
    plat.backend.reset_window()
    launches_before, fused_before = launches(), backend.stats["fused_dispatches"]
    for _ in range(timed_runs):
        backend.dispatch_log.clear()
        logs.append(one_run())
    launches_path = launches() - launches_before
    fused = backend.stats["fused_dispatches"] - fused_before
    rep = plat.report()

    # ---- checks
    if dev.type == "cuda":
        expect(fused > 0 and fused == launches_path,
               f"fused dispatches {fused} != kernel launches {launches_path}")
    rows_of = lambda cost: int(cost) // WIRE_BYTES_PER_PKT   # noqa: E731
    buckets = {name: set() for name in tenants}
    for log in logs:
        for tenant, rows in fair_groups(log, rows_of):
            buckets[tenant].add(bucket_size(rows))
    expect(backend.stats["traces"] == sum(map(len, buckets.values())),
           f"traces {backend.stats['traces']} != distinct buckets {buckets}")
    last = logs[-1]
    a_left = [t for t, _ in last].count("A")
    n_a = n_b = 0
    for tenant, _ in last:                  # while A is backlogged: 2:1
        if n_a == a_left:
            break
        n_a += tenant == "A"
        n_b += tenant == "B"
        expect(abs(n_a - 2 * n_b) <= 2,
               f"dispatch log does not interleave by weight: {last}")
    table = rule_table(params["firewall"]["rules"], dev)
    ch = params["chacha20"]
    nat = params["nat"]["nat_ip"].reshape(1)
    for name in tenants:
        outs = rep[name].outputs
        expect(len(outs) == batches * timed_runs, f"{name}: output count")
        for b, (h, p) in enumerate(traffic[name]):
            want = vpc_datapath_plain(h, p, narrow(arange32(1, h.shape[0],
                                                            dev)),
                                      table, ch["key"], ch["nonce"], nat,
                                      0x9e3779b9)
            for run in range(timed_runs):
                out = outs[run * batches + b]
                expect(same_triple((out["allow"], out["headers"],
                                    out["payload"]), want),
                       f"{name} batch {b} run {run} differs from plain")
            dec = chacha20_xor(out["payload"], ch["key"], ch["nonce"],
                               counter0=1)
            keep = out["allow"][:, None]
            expect(torch.equal(where32(keep, dec, 0), where32(keep, p, 0)),
                   f"{name} batch {b}: allowed payload does not decrypt")

    secs = rep.duration_ns / 1e9
    pkts = sum(rep[n].pkts_done for n in tenants)
    wire = sum(rep[n].bytes_done for n in tenants)
    shape_counts = launch_shapes(last)
    record = {
        "phase": "main_path", "rules": rules_n,
        "packets_per_run": pkts // timed_runs, "timed_runs": timed_runs,
        "seconds": secs, "mpkt_per_s": pkts / secs / 1e6,
        "wire_gbit_per_s": wire * 8 / secs / 1e9,
        "launches": launches_path, "fused_dispatches": fused,
        "traces": backend.stats["traces"],
        "dispatch_order": "".join(t for t, _ in last),
        "buckets_per_run": {str(k): v for k, v in sorted(shape_counts.items())},
        "gbps_by_tenant": {n: rep[n].gbps for n in tenants},
    }
    if card is not None:
        # kernel time per launch at each bucket shape of one run, on the
        # same rules and keys (the bucket contents are the packets padded
        # with zero rows, as the runtime fills them)
        kernel_ms, call_ms = {}, {}
        for bucket in sorted(shape_counts):
            args = bucket_args(rng, bucket, table, ch, nat, dev)
            kernel_ms[str(bucket)] = cuda_ms(raw_vpc(args), 100)
            call_ms[str(bucket)] = cuda_ms(
                lambda: vpc_datapath_cuda(**args), 50)
        record["kernel_ms_per_launch"] = kernel_ms
        record["call_ms_per_launch"] = call_ms
        record["kernel_ms_per_run"] = sum(
            kernel_ms[str(b)] * c for b, c in shape_counts.items())
        record["kernel_share_of_run"] = \
            record["kernel_ms_per_run"] / (secs / timed_runs * 1e3)
    if dev.type == "cuda":
        record["device_ops_per_run"] = rebuilt_and_cached(backend, one_run)
    if profile:
        record["profile"] = profile_run(one_run)
    a_outputs = list(rep["A"].outputs[:batches])     # first timed run's
    record["swapped_params"] = swapped_params_run(
        dev, plat, params, traffic, one_run,
        record.get("device_ops_per_run", {}).get("kept"))
    common = max(shape_counts, key=lambda b: (shape_counts[b], b))
    return record, bucket_args(rng, common, table, ch, nat, dev), \
        launches_path, a_outputs


def swapped_params_run(dev, plat, params, traffic, one_run, kept) -> dict:
    """New rules (``make_rules(RULES, seed=SWAP_RULES_SEED)``) and a new NAT
    address in the params both deployments share, after runs on the old
    ones: every param is read at dispatch, so one more run equals the plain
    version on the *new* params (and differs from it on the old), and the
    run after it puts the same CUDA kernels and memory operations on the
    card as a run with unchanged params (``kept``)."""
    from repro_torch._u32 import arange32, narrow
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_plain
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    from repro_torch.serving.vpc import make_rules
    old = (rule_table(params["firewall"]["rules"], dev),
           params["nat"]["nat_ip"].reshape(1))
    new = params_from_numpy({
        "firewall": {"rules": tuple(x.numpy() for x in make_rules(
            RULES, seed=SWAP_RULES_SEED, device="cpu"))},
        "nat": {"nat_ip": SWAP_NAT_IP}}, dev)
    params["firewall"]["rules"] = new["firewall"]["rules"]
    params["nat"]["nat_ip"] = new["nat"]["nat_ip"]
    plat.backend.reset_window()
    one_run()
    rep = plat.report()
    table = rule_table(params["firewall"]["rules"], dev)
    nat = params["nat"]["nat_ip"].reshape(1)
    ch = params["chacha20"]
    allowed = packets = 0
    for name in TENANT_WEIGHTS:
        outs = rep[name].outputs
        expect(len(outs) == BATCHES, f"{name}: {len(outs)} outputs")
        for b, (h, p) in enumerate(traffic[name]):
            ctr = narrow(arange32(1, h.shape[0], dev))
            got = (outs[b]["allow"], outs[b]["headers"], outs[b]["payload"])
            expect(same_triple(got, vpc_datapath_plain(
                h, p, ctr, table, ch["key"], ch["nonce"], nat, 0x9e3779b9)),
                f"{name} batch {b}: differs from plain on the new params")
            if b == 0:
                expect(not same_triple(got, vpc_datapath_plain(
                    h, p, ctr, old[0], ch["key"], ch["nonce"], old[1],
                    0x9e3779b9)), f"{name}: the swap changed no output")
            allowed += int(got[0].sum())
            packets += h.shape[0]
    record = {"rules_seed": SWAP_RULES_SEED, "nat_ip": hex(SWAP_NAT_IP),
              "packets": packets, "allowed": allowed,
              "bit_equal_to_plain_on_new_params": True}
    if dev.type == "cuda":
        ops = device_ops(one_run)
        expect(ops == kept, f"after the swap a run puts {ops} on the card, "
               f"with unchanged params {kept}")
        record["device_ops_per_run"] = ops
    return record


# ------------------------------------ 4b. streaming, the fleet, the trace ----
def datapath_setup(dev, host: bool, stream_ctr: bool = False):
    """The main path's parameters (RULES rules, key and nonce from the same
    seeds) on ``dev``, and its traffic: tenant -> BATCHES (headers,
    payload) batches of ROWS_A / ROWS_B packets, and the generator that drew
    the key and nonce.  ``host`` keeps the packets in host memory, as
    packets arrive from a host; ``stream_ctr`` runs the ChaCha counter per
    deployment across batches, its base a 0-d tensor a dispatch
    (``"stream": True, "scalar_ctr": True``)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.vpc import make_packets, make_rules
    rng = np.random.default_rng(2024)
    rules = make_rules(RULES, seed=3, device="cpu")
    params = params_from_numpy({
        "firewall": {"rules": tuple(x.numpy() for x in rules)},
        "nat": {"nat_ip": 0x0A000001},
        "chacha20": {"key": rng.integers(0, 2 ** 32, 8, dtype=np.uint32),
                     "nonce": rng.integers(0, 2 ** 32, 3, dtype=np.uint32)},
    }, dev)
    if stream_ctr:
        params["chacha20"].update(stream=True, scalar_ctr=True)
    where = "cpu" if host else dev
    traffic = {name: [make_packets(rows, seed=100 * i + b, device=where)
                      for b in range(BATCHES)]
               for i, (name, rows) in enumerate((("A", ROWS_A),
                                                 ("B", ROWS_B)))}
    return params, traffic, rng


def on_device(dev) -> dict:
    """ComputeBackend keywords: the card is the default device; a CPU
    rehearsal names its device and asks for the fused path, which is the
    default only on CUDA."""
    return {} if dev.type == "cuda" else {"device": dev, "use_fused": True}


def vpc_platform(dev, params, **kw):
    """Tenants A and B (weights 2 : 1) each deploying the fused chain."""
    from repro_torch.api import ComputeBackend, Platform, VPC_SPECS, nt
    backend = ComputeBackend(quantum_bytes=ROWS_A * WIRE_BYTES_PER_PKT,
                             **on_device(dev), **kw)
    plat = Platform(backend, specs=VPC_SPECS)
    vpc = nt("firewall") >> nt("nat") >> nt("chacha20")
    deps = {name: plat.tenant(name, weight=w).deploy(vpc, params=params)
            for name, w in TENANT_WEIGHTS.items()}
    return plat, deps


def same_outputs(a: list, b: list) -> bool:
    """Two output lists with equal allow, headers and payload, bit for
    bit."""
    import torch
    return len(a) == len(b) and all(
        torch.equal(x[k], y[k]) for x, y in zip(a, b)
        for k in ("allow", "headers", "payload"))


def outputs_by_tenant(plat) -> dict:
    rep = plat.report()
    return {name: list(rep[name].outputs) for name in TENANT_WEIGHTS}


def launch_shapes(log) -> dict[int, int]:
    """Kernel launches of one run at each bucket, from its dispatch log."""
    from repro_torch.api.compute_backend import bucket_size
    counts: dict[int, int] = {}
    for _, rows in fair_groups(log, lambda c: int(c) // WIRE_BYTES_PER_PKT):
        counts[bucket_size(rows)] = counts.get(bucket_size(rows), 0) + 1
    return counts


def stream_path(dev, card: Card | None, profile: bool = False):
    """``ComputeBackend(stream=True)`` against the batch runtime on the
    main path's traffic held in host memory, in turns in one process.
    Returns the record, the batch runtime's first-run outputs (the
    reference of the later phases) and the stream runs' launches."""
    from repro_torch._u32 import arange32, narrow
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    params, traffic, _ = datapath_setup(dev, host=True)
    plats = {"batch": vpc_platform(dev, params),
             "stream": vpc_platform(dev, params, stream=True,
                                    ring_depth=STREAM_RING_DEPTH)}
    wall: dict[str, list] = {"batch": [], "stream": []}

    def one_run(mode):
        plat, deps = plats[mode]
        t0 = time.perf_counter()
        for name, batches in traffic.items():
            for h, p in batches:
                deps[name].inject(headers=h, payload=p)
        plat.run()
        wall[mode].append(time.perf_counter() - t0)
        expect(plat.backend.inflight_batches == 0,
               f"{mode}: {plat.backend.inflight_batches} batches in flight "
               "after run()")

    sbe = plats["stream"][0].backend
    for mode in plats:                       # warm-up (builds nothing new)
        one_run(mode)
    ref = outputs_by_tenant(plats["batch"][0])
    got = outputs_by_tenant(plats["stream"][0])
    table = rule_table(params["firewall"]["rules"], dev)
    ch, nat = params["chacha20"], params["nat"]["nat_ip"].reshape(1)
    for name, batches in traffic.items():
        expect(same_outputs(ref[name], got[name]),
               f"{name}: stream outputs differ from the batch path's")
        for b, (h, p) in enumerate(batches):
            want = vpc_datapath_plain(
                h.to(dev), p.to(dev), narrow(arange32(1, h.shape[0], dev)),
                table,
                ch["key"], ch["nonce"], nat, 0x9e3779b9)
            expect(same_triple((ref[name][b]["allow"], ref[name][b]["headers"],
                                ref[name][b]["payload"]), want),
                   f"{name} batch {b}: batch path differs from plain")
    allocs = sbe.ring.stats()["allocs"]
    for plat, _ in plats.values():
        plat.backend.reset_window()
    for mode in wall:
        wall[mode].clear()
    launches = groups = 0
    for _ in range(TIMED_RUNS):              # in turns: batch, stream
        one_run("batch")
        sbe.dispatch_log.clear()
        vpc_datapath_cuda.launches = 0
        one_run("stream")
        launches += vpc_datapath_cuda.launches
        groups += len(fair_groups(sbe.dispatch_log,
                                  lambda c: int(c) // WIRE_BYTES_PER_PKT))
    outs = {mode: outputs_by_tenant(plat) for mode, (plat, _) in plats.items()}
    for name in traffic:
        expect(same_outputs(outs["batch"][name], outs["stream"][name]),
               f"{name}: timed stream runs differ from the batch path's")
        expect(same_outputs(outs["stream"][name][:BATCHES], ref[name]),
               f"{name}: a stream run differs from the warm-up's outputs")
    ring = sbe.ring.stats()
    expect(ring["allocs"] == allocs,
           f"ring slots grew after warm-up: {allocs} -> {ring['allocs']}")
    if dev.type == "cuda":
        expect(launches == groups,
               f"stream runs launched vpc_datapath {launches}x for "
               f"{groups} dispatch groups")

    # every acquire waits: one slot in flight, a ring of one
    one, one_deps = vpc_platform(dev, params, stream=True, ring_depth=1,
                                 max_inflight=1)
    for name, batches in traffic.items():
        for h, p in batches:
            one_deps[name].inject(headers=h, payload=p)
    one.run()
    one_out = outputs_by_tenant(one)
    for name in traffic:
        expect(same_outputs(one_out[name], ref[name]),
               f"{name}: ring_depth=1, max_inflight=1 differs")
    del one_out

    record = {"phase": "stream", "rules": RULES,
              "packets": "host memory", "timed_runs": TIMED_RUNS,
              "ring_depth": STREAM_RING_DEPTH,
              "max_inflight": sbe.max_inflight, "ring": ring,
              "ring_depth_1": one.backend.ring.stats(),
              "launches": launches, "dispatch_groups": groups,
              "bit_equal_to_batch": True}
    for mode, (plat, _) in plats.items():
        rep = plat.report()
        secs = rep.duration_ns / 1e9
        pkts = sum(rep[n].pkts_done for n in TENANT_WEIGHTS)
        wire = sum(rep[n].bytes_done for n in TENANT_WEIGHTS)
        record[mode] = {
            "packets_per_run": pkts // TIMED_RUNS, "seconds": secs,
            "mpkt_per_s": pkts / secs / 1e6,
            "wire_gbit_per_s": wire * 8 / secs / 1e9,
            "wall_ms_per_run": [t * 1e3 for t in wall[mode]],
            "mpkt_per_s_with_inject": pkts / sum(wall[mode]) / 1e6}
    if card is not None:
        shapes = launch_shapes(sbe.dispatch_log)
        rng = np.random.default_rng(7)
        kernel_ms = {b: cuda_ms(raw_vpc(bucket_args(rng, b, table, ch, nat,
                                                    dev)), 100)
                     for b in shapes}
        record["buckets_per_run"] = {str(b): c for b, c in sorted(
            shapes.items())}
        record["kernel_ms_per_launch"] = {str(b): ms for b, ms in sorted(
            kernel_ms.items())}
        record["kernel_ms_per_run"] = sum(kernel_ms[b] * c
                                          for b, c in shapes.items())
    if profile:
        record["profile"] = {
            mode: profile_run(lambda m=mode: one_run(m),
                              table=f"chip_smoke_profile_{mode}.txt")
            for mode in plats}
    return record, ref, launches


def inject_stream_path(dev, ref: dict):
    """``inject_stream`` over a generator of the same host-resident
    batches, tenants interleaved as they arrive, in epochs of the ring's
    depth under a credit window of one WDRR quantum."""
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    params, traffic, _ = datapath_setup(dev, host=True)
    plat, deps = vpc_platform(dev, params, stream=True,
                              ring_depth=STREAM_RING_DEPTH)
    be = plat.backend
    quantum = ROWS_A * WIRE_BYTES_PER_PKT

    def source():
        for b in range(BATCHES):
            for name in traffic:
                h, p = traffic[name][b]
                yield name, deps[name].uid, {"headers": h, "payload": p}

    injected = BATCHES * len(traffic)
    served = be.inject_stream(source(), epoch_cost=quantum)   # warm-up
    expect(served == injected, f"warm-up served {served} of {injected}")
    be.reset_window()
    epochs0, disp0 = be.stats["stream_epochs"], be.stats["dispatches"]
    vpc_datapath_cuda.launches = 0
    t0 = time.perf_counter()
    served = be.inject_stream(source(), epoch_cost=quantum)
    secs_wall = time.perf_counter() - t0
    launches = vpc_datapath_cuda.launches
    expect(served == injected, f"served {served} of {injected} injected")
    expect(be.inflight_batches == 0 and be.sched.pending() == 0,
           "inject_stream left work in flight or queued")
    got = outputs_by_tenant(plat)
    for name in traffic:
        expect(same_outputs(got[name], ref[name]),
               f"{name}: inject_stream outputs differ from the batch path's")
    dispatches = be.stats["dispatches"] - disp0
    if dev.type == "cuda":
        expect(launches == dispatches,
               f"inject_stream launched {launches}x for {dispatches} "
               "dispatches")
    rep = plat.report()
    secs = rep.duration_ns / 1e9
    pkts = sum(rep[n].pkts_done for n in TENANT_WEIGHTS)
    return {"phase": "inject_stream", "injected": injected,
            "served": served, "epoch_cost_bytes": quantum,
            "epochs": be.stats["stream_epochs"] - epochs0,
            "dispatches": dispatches, "launches": launches,
            "packets": pkts, "seconds": secs, "mpkt_per_s": pkts / secs / 1e6,
            "wire_gbit_per_s": sum(rep[n].bytes_done for n in TENANT_WEIGHTS)
            * 8 / secs / 1e9,
            "mpkt_per_s_with_inject": pkts / secs_wall / 1e6,
            "ring": be.ring.stats(), "bit_equal_to_batch": True}, launches


def fleet_run(dev, params, traffic, crash: bool, ckpt: str):
    """Two streaming shards behind a ShardedBackend (A pinned to c0, B to
    c1), FLEET_EPOCHS epochs of the main path's traffic, with or without a
    crash of c0 at FLEET_CRASH_EPOCH; checkpoints the stream counters
    every epoch."""
    from repro_torch.api import (ComputeBackend, Platform, ShardedBackend,
                                 VPC_SPECS, nt)
    from repro_torch.faults import FaultPlan
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    shards = [ComputeBackend(name=f"c{i}", stream=True,
                             ring_depth=STREAM_RING_DEPTH,
                             quantum_bytes=ROWS_A * WIRE_BYTES_PER_PKT,
                             **on_device(dev)) for i in range(2)]
    plan = FaultPlan(seed=3).crash(shard=0, epoch=FLEET_CRASH_EPOCH) \
        if crash else None
    sb = ShardedBackend(shards, auto_rebalance=False, fault_plan=plan,
                        health_threshold=1, checkpoint=ckpt)
    plat = Platform(sb, specs=VPC_SPECS)
    vpc = nt("firewall") >> nt("nat") >> nt("chacha20")
    deps = {name: plat.tenant(name, weight=w).deploy(vpc, shard=i,
                                                     params=params)
            for i, (name, w) in enumerate(TENANT_WEIGHTS.items())}
    failover_ms = []
    failover = sb._failover

    def timed_failover(i, reason="probe-miss"):
        t0 = time.perf_counter()
        failover(i, reason=reason)
        failover_ms.append((time.perf_counter() - t0) * 1e3)

    sb._failover = timed_failover
    vpc_datapath_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(FLEET_EPOCHS):
        for name, batches in traffic.items():
            for h, p in batches:
                deps[name].inject(headers=h, payload=p)
        plat.run()
    secs = time.perf_counter() - t0
    launches = vpc_datapath_cuda.launches
    for s in sb.shards:
        expect(s.inflight_batches == 0, f"{s.name}: batches left in flight")
    rep = plat.report()
    return rep, secs, launches, failover_ms


def fleet_path(dev):
    """The fleet with stream-mode ChaCha counters: after a warm-up run, a
    crash-free run and a run where c0 crashes; the crash run's outputs must
    equal the crash-free run's bit for bit after failover, checkpoint
    restore and journal replay.  Returns the record and the two timed
    runs' launches."""
    import tempfile
    params, traffic, _ = datapath_setup(dev, host=True,
                                         stream_ctr=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        fleet_run(dev, params, traffic, False, f"{tmp}/warm_up")
        for crash in (False, True):
            runs[crash] = fleet_run(dev, params, traffic, crash,
                                    f"{tmp}/ckpt_{int(crash)}")
    (ref, ref_s, ref_l, _), (rep, secs, launches, fo_ms) = \
        runs[False], runs[True]
    n_pkts = FLEET_EPOCHS * BATCHES * (ROWS_A + ROWS_B)
    for name in TENANT_WEIGHTS:
        expect(same_outputs(ref[name].outputs, rep[name].outputs),
               f"{name}: the crash run's outputs differ from the crash-free "
               "run's")
        expect(len(rep[name].outputs) == FLEET_EPOCHS * BATCHES,
               f"{name}: {len(rep[name].outputs)} outputs")
    fos = rep.extra["failovers"]
    expect(len(fos) == 1 and fos[0]["shard"] == "c0" and fos[0]["lost"] == [],
           f"failovers {fos}")
    expect(rep.extra["replayed"] >= 1 and
           rep.extra["lost"]["deployments"] == 0,
           f"replayed {rep.extra['replayed']}, lost {rep.extra['lost']}")
    expect(not ref.extra["failovers"], "the crash-free run failed over")
    expect(len(fo_ms) == 1, f"{len(fo_ms)} failovers timed")
    return {"phase": "fleet", "shards": 2, "device": str(dev),
            "epochs": FLEET_EPOCHS, "crash_epoch": FLEET_CRASH_EPOCH,
            "packets_per_run": n_pkts, "stream_ctr": "scalar_ctr",
            "crash_free": {"seconds": ref_s,
                           "mpkt_per_s": n_pkts / ref_s / 1e6,
                           "launches": ref_l},
            "crash": {"seconds": secs, "mpkt_per_s": n_pkts / secs / 1e6,
                      "launches": launches},
            "failover_ms": fo_ms[0], "failovers": fos,
            "replayed": rep.extra["replayed"], "lost": rep.extra["lost"],
            "routes": {str(k): v for k, v in rep.extra["routes"].items()},
            "bit_equal_to_crash_free": True}, ref_l + launches


def mixed_fleet_path(dev, card: Card | None, main_a: list):
    """``Platform([SimBackend(name="edge"), ComputeBackend(name="gpu0")])``:
    tenants a (weight 2) and b (weight 1) each deploy firewall >> nat on the
    sim shard, fed by Poisson sources at MIXED_SOURCE_GBPS each (the
    sNIC's port is contended), and a also deploys the fused chain with the
    main path's params on the card, fed the main path's tenant-A traffic
    before the window.  The cross-shard epoch keeps the sim-side bytes
    at 2 : 1 beside the standing compute backlog, the card serves every
    injected packet with the main path's bits, and ``vpc_datapath``
    launches once per dispatch group.  Returns the record and the
    launches."""
    from repro_torch.api import (ComputeBackend, Platform, SimBackend,
                                 VPC_SPECS, nt)
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    params, traffic, rng = datapath_setup(dev, host=False)
    gpu = ComputeBackend(name="gpu0", **on_device(dev))
    plat = Platform([SimBackend(name="edge"), gpu], specs=VPC_SPECS)
    sb = plat.backend
    a = plat.tenant("a", weight=TENANT_WEIGHTS["A"])
    b = plat.tenant("b", weight=TENANT_WEIGHTS["B"])
    sim_deps = {t.name: t.deploy(nt("firewall") >> nt("nat"), shard=0)
                for t in (a, b)}
    d_gpu = a.deploy(nt("firewall") >> nt("nat") >> nt("chacha20"),
                     params=params, shard=1)
    sb.settle()
    for i, dep in enumerate(sim_deps.values()):
        dep.source("poisson", rate_gbps=MIXED_SOURCE_GBPS,
                   mean_bytes=MIXED_PKT_BYTES, seed=i + 1,
                   duration_ms=MIXED_MS)
    for h, p in traffic["A"]:
        d_gpu.inject(headers=h, payload=p)
    injected = sum(h.shape[0] for h, _ in traffic["A"])

    gpu_s = []
    gpu_run = gpu.run

    def timed_gpu_run(*args, **kw):
        t0 = time.perf_counter()
        gpu_run(*args, **kw)             # ends in the run's device sync
        gpu_s.append(time.perf_counter() - t0)

    gpu.run = timed_gpu_run
    vpc_datapath_cuda.launches = 0
    t0 = time.perf_counter()
    plat.run(duration_ms=MIXED_MS)
    wall = time.perf_counter() - t0
    launches = vpc_datapath_cuda.launches
    rep = plat.report()

    edge = {t: rep[t].extra["per_shard"]["edge"] for t in ("a", "b")}
    ratio = edge["a"]["bytes_done"] / edge["b"]["bytes_done"]
    want = TENANT_WEIGHTS["A"] / TENANT_WEIGHTS["B"]
    expect(abs(ratio / want - 1.0) <= MIXED_RATIO_REL,
           f"edge bytes a : b = {ratio}, not {want} within "
           f"{MIXED_RATIO_REL:.0%}")
    served = rep["a"].extra["per_shard"]["gpu0"]["pkts_done"]
    expect(served == injected, f"gpu0 served {served} of {injected}")
    expect(same_outputs(rep["a"].outputs, main_a),
           "gpu0's outputs differ from the batch main path's")
    groups = fair_groups(gpu.dispatch_log,
                         lambda c: int(c) // WIRE_BYTES_PER_PKT)
    if dev.type == "cuda":
        expect(launches == len(groups) > 0,
               f"vpc_datapath launched {launches}x for {len(groups)} "
               "dispatch groups")
    record = {
        "phase": "mixed_fleet", "shards": ["edge: SimBackend",
                                           f"gpu0: ComputeBackend({dev})"],
        "window_ms": MIXED_MS, "global_epochs": sb.global_epochs,
        "sources": {"gbit_per_s_each": MIXED_SOURCE_GBPS,
                    "mean_bytes": MIXED_PKT_BYTES},
        "edge_bytes_ratio_a_to_b": ratio,
        "edge": {t: {k: edge[t][k] for k in ("gbps", "pkts_done", "drops",
                                             "mean_latency_us")}
                 for t in ("a", "b")},
        "gpu0": {"injected": injected, "served": served,
                 "dispatch_groups": len(groups), "launches": launches,
                 "seconds": sum(gpu_s),
                 "mpkt_per_s": served / sum(gpu_s) / 1e6},
        "wall_seconds": wall, "bit_equal_to_main_path": True}
    if card is not None:
        shapes = launch_shapes(gpu.dispatch_log)
        table = rule_table(params["firewall"]["rules"], dev)
        ch, nat = params["chacha20"], params["nat"]["nat_ip"].reshape(1)
        kernel_ms = {bk: cuda_ms(raw_vpc(bucket_args(rng, bk, table, ch, nat,
                                                     dev)), 50)
                     for bk in shapes}
        record["gpu0"]["kernel_ms_per_launch"] = {
            str(bk): ms for bk, ms in sorted(kernel_ms.items())}
        record["gpu0"]["kernel_ms"] = sum(kernel_ms[bk] * c
                                          for bk, c in shapes.items())
    return record, launches


def trace_path(dev):
    """``TraceDriver`` replays ``benchmarks/bench_scenarios.py``'s
    portability trace (smoke size) on the sim, sharded-sim, compute,
    compute-stream and sharded-compute platforms; each gives the recorded
    schedule fingerprint and serves every packet, and the three compute
    platforms give the same bits (the sim carries sizes, not payloads)."""
    from repro_torch.api import ComputeBackend, Platform, SimBackend, VPC_SPECS
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    from repro_torch.workloads import TraceDriver, constant, generate
    trace = generate("portability", seed=5, epochs=6, n_tenants=6,
                     arrival=constant(1.0), churn_frac=0.25)
    kw = on_device(dev)
    platforms = {
        "sim": lambda: Platform(SimBackend(seed=3), specs=VPC_SPECS),
        "sharded": lambda: Platform([SimBackend(name="p0", seed=1),
                                     SimBackend(name="p1", seed=2)],
                                    specs=VPC_SPECS),
        "compute": lambda: Platform(ComputeBackend(**kw), specs=VPC_SPECS),
        "compute_stream": lambda: Platform(ComputeBackend(stream=True, **kw),
                                           specs=VPC_SPECS),
        "sharded_compute": lambda: Platform(
            [ComputeBackend(name="c0", **kw),
             ComputeBackend(name="c1", stream=True, **kw)], specs=VPC_SPECS),
    }
    record, outs, total = {"phase": "trace",
                           "trace_fingerprint": trace.fingerprint(),
                           "offered_pkts": trace.total_pkts}, {}, 0
    for kind, make in platforms.items():
        vpc_datapath_cuda.launches = 0
        t0 = time.perf_counter()
        res = TraceDriver(make()).drive(trace)
        secs = time.perf_counter() - t0
        launches = vpc_datapath_cuda.launches
        total += launches
        expect(res.backend == kind, f"{kind}: driven as {res.backend}")
        expect(res.schedule_fingerprint == TRACE_FINGERPRINT,
               f"{kind}: schedule fingerprint {res.schedule_fingerprint}")
        expect(sum(res.served.values()) == sum(res.injected.values())
               == trace.total_pkts, f"{kind}: served {res.served}")
        outs[kind] = {n: tr.outputs for n, tr in res.report.tenants.items()}
        record[kind] = {"schedule_fingerprint": res.schedule_fingerprint,
                        "served": sum(res.served.values()),
                        "seconds": secs, "launches": launches}
    for kind in ("compute_stream", "sharded_compute"):
        for name, o in outs["compute"].items():
            expect(same_outputs(o, outs[kind][name]),
                   f"{kind}: {name}'s outputs differ from compute's")
    record["bit_equal_across_platforms"] = True
    return record, total


# ------------------------------ 4c. the sim fleet's resilience, host only ----
def _res_share_err(served: dict) -> float:
    shares = [served.get(t, 0.0) / RES_WEIGHTS[t] for t in RES_WEIGHTS]
    mean = sum(shares) / len(shares)
    if mean <= 0:
        return 1.0
    return max(abs(s / mean - 1.0) for s in shares)


def _res_p99_us(lat_ns: list) -> float:
    if not lat_ns:
        return 0.0
    s = sorted(lat_ns)
    return round(s[min(len(s) - 1, int(0.99 * len(s)))] / 1e3, 1)


def _res_window_lats(sb, prev: dict) -> dict:
    """Latency samples that landed since the previous call, merged across
    the fleet (a cursor per FlowStats object: rack peers may share one)."""
    out: dict = {}
    for sh in sb.shards:
        for snic in sh.snics:
            for t, st in snic.stats.items():
                k = id(st)
                n0 = prev.get(k, 0)
                if len(st.latencies_ns) > n0:
                    out.setdefault(t, []).extend(st.latencies_ns[n0:])
                prev[k] = len(st.latencies_ns)
    return out


def resilience_run(n_chunks: int, crash_epoch: int, seed: int) -> dict:
    """The kill-1-of-4 scenario of the JAX package's
    ``benchmarks/bench_resilience.py`` on the port's sim fleet: four
    ``SimBackend`` shards, one deployment per tenant per shard, a seeded
    ``FaultPlan`` crashing shard RES_DEAD_SHARD at ``crash_epoch``, clients
    injecting through the coordinator in chunks of RES_EPOCHS_PER_CHUNK
    global epochs at RES_LOAD_FACTOR x the healthy capacity, spread over
    each tenant's live replicas.  Returns the same normalized (uid-free)
    report, chunk by chunk."""
    from repro_torch.api import (Platform, ShardedBackend, SimBackend,
                                 VPC_SPECS, nt)
    from repro_torch.faults import FaultError, FaultPlan

    plan = FaultPlan(seed=seed).crash(shard=RES_DEAD_SHARD, epoch=crash_epoch)
    sb = ShardedBackend(
        [SimBackend(name=f"sim{i}", seed=100 + i) for i in range(RES_SHARDS)],
        fault_plan=plan, health_threshold=2, auto_rebalance=False)
    plat = Platform(sb, specs=VPC_SPECS)
    chain = nt("firewall") >> nt("nat")
    deps = {t: [plat.tenant(t, weight=w).deploy(chain, shard=s)
                for s in range(RES_SHARDS)]
            for t, w in RES_WEIGHTS.items()}
    sb.settle()

    chunk_ns = RES_EPOCHS_PER_CHUNK * sb.global_epoch_ns
    wsum = sum(RES_WEIGHTS.values())
    cursors: dict = {}
    prev_bytes = {t: 0.0 for t in RES_WEIGHTS}
    chunks, inject_errors = [], 0
    for c in range(n_chunks):
        healthy = sum(sb.healthy)
        cap_bytes = healthy * RES_SHARD_GBPS / 8.0 * chunk_ns
        offered = 0
        for t, w in RES_WEIGHTS.items():
            by_shard: dict = {}
            for d in deps[t]:
                by_shard.setdefault(sb.routes[d.uid], d.uid)
            uids = [by_shard[s] for s in sorted(by_shard)]
            pkts = int(RES_LOAD_FACTOR * cap_bytes * (w / wsum)
                       / RES_PKT_BYTES)
            offered += pkts * RES_PKT_BYTES
            for k in range(pkts):
                try:
                    sb.inject(t, uids[k % len(uids)], RES_PKT_BYTES)
                except FaultError:
                    inject_errors += 1
        plat.run(duration_ms=chunk_ns / 1e6)
        rep = plat.report()
        served = {t: rep[t].bytes_done - prev_bytes[t] for t in RES_WEIGHTS}
        prev_bytes = {t: rep[t].bytes_done for t in RES_WEIGHTS}
        lats = _res_window_lats(sb, cursors)
        chunks.append({
            "chunk": c,
            "end_epoch": (c + 1) * RES_EPOCHS_PER_CHUNK,
            "healthy": healthy,
            "share_err": round(_res_share_err(served), 4),
            "delivered": round(sum(served.values()) / offered, 4),
            "served_mb": {t: round(served[t] / 1e6, 3) for t in RES_WEIGHTS},
            "p99_us": _res_p99_us([x for v in lats.values() for x in v]),
            "failovers": len(rep.extra["failovers"]),
        })

    rep = plat.report()
    failovers = [{"epoch": f["epoch"], "shard": f["shard"],
                  "reason": f["reason"], "moved": len(f["moved"]),
                  "lost": f["lost"], "inflight_pkts": f["inflight_pkts"],
                  "replayed": f["replayed"]}
                 for f in rep.extra["failovers"]]
    fo_chunk = next((c["chunk"] for c in chunks if c["failovers"]), None)
    fo_epoch = failovers[0]["epoch"] if failovers else None
    recovered = next(
        (c for c in chunks
         if fo_chunk is not None and c["chunk"] >= fo_chunk
         and c["share_err"] <= RES_SHARE_ERR_BOUND
         and c["delivered"] >= RES_DELIVERED_BOUND), None)
    victim_win = [c for c in chunks
                  if fo_chunk is not None
                  and fo_chunk <= c["chunk"] <= fo_chunk + 1]
    steady = [c for c in chunks
              if fo_chunk is not None and c["chunk"] == fo_chunk - 1]
    return {
        "chunks": chunks,
        "failovers": failovers,
        "recoveries": len(rep.extra["recoveries"]),
        "lost": dict(rep.extra["lost"]),
        "inject_retries": rep.extra["inject_retries"],
        "inject_errors": inject_errors,
        "fault_plan": rep.extra["faults"]["plan"],
        "failover_epoch": fo_epoch,
        "recovery_epochs": (recovered["end_epoch"] - fo_epoch
                            if recovered and fo_epoch is not None else None),
        "victim_p99_us": max((c["p99_us"] for c in victim_win), default=0.0),
        "steady_p99_us": max((c["p99_us"] for c in steady), default=0.0),
        "per_tenant": {t: {"pkts": rep[t].pkts_done,
                           "mb": round(rep[t].bytes_done / 1e6, 3),
                           "drops": rep[t].drops,
                           "p99_us": round(rep[t].p99_latency_us, 1)}
                       for t in RES_WEIGHTS},
    }


def resilience_fingerprint(run: dict) -> str:
    import hashlib
    return hashlib.sha256(
        json.dumps(run, sort_keys=True).encode()).hexdigest()[:16]


def resilience_acceptance(run1: dict, run2: dict) -> dict:
    """The reference's acceptance of the scenario: no deployment lost,
    recovery within RES_RECOVERY_EPOCH_BOUND epochs, the last chunk's share
    error and delivered ratio within their bounds, and both runs equal."""
    rec = run1["recovery_epochs"]
    last = run1["chunks"][-1]
    det = resilience_fingerprint(run1) == resilience_fingerprint(run2)
    return {"lost_deployments": run1["lost"]["deployments"],
            "recovery_epochs": rec,
            "final_share_err": last["share_err"],
            "final_delivered": last["delivered"],
            "deterministic": det,
            "pass": (run1["lost"]["deployments"] == 0
                     and rec is not None and rec <= RES_RECOVERY_EPOCH_BOUND
                     and last["share_err"] <= RES_SHARE_ERR_BOUND
                     and last["delivered"] >= RES_DELIVERED_BOUND
                     and det)}


def sim_resilience_path() -> dict:
    """The resilience scenario at full size, twice from scratch: host
    Python only (the sim carries no tensors); prints the acceptance
    figures, both fingerprints and each run's wall seconds."""
    runs, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(resilience_run(RES_CHUNKS, RES_CRASH_EPOCH, RES_SEED))
        secs.append(time.perf_counter() - t0)
    acc = resilience_acceptance(*runs)
    expect(acc["pass"], f"resilience acceptance failed: {acc}")
    fps = [resilience_fingerprint(r) for r in runs]
    expect(fps[0] == RES_FINGERPRINT,
           f"resilience fingerprint {fps[0]}, the JAX package's "
           f"{RES_FINGERPRINT}")
    run = runs[0]
    return {"phase": "sim_resilience", "shards": RES_SHARDS,
            "dead_shard": f"sim{RES_DEAD_SHARD}", "chunks": RES_CHUNKS,
            "crash_epoch": RES_CRASH_EPOCH, "seed": RES_SEED,
            "acceptance": acc,
            "fingerprints": fps,
            "failovers": run["failovers"], "lost": run["lost"],
            "victim_p99_us": run["victim_p99_us"],
            "steady_p99_us": run["steady_p99_us"],
            "wall_seconds": secs}


def device_ops_reads(one_run, n: int) -> list:
    """``n`` readings of the CUDA kernels and memory operations (copies,
    fills) one run of a path puts on the card, each from
    ``torch.profiler``'s device events of one more run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reads = []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_run()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mem = sum(1 for e in ev if e.name.startswith(("Memcpy", "Memset")))
        reads.append({"kernels": len(ev) - mem, "memory_ops": mem})
    return reads


def device_ops(one_run) -> dict:
    """The device operations one run of a path puts on the card: each
    count the largest of DEVICE_OPS_READS readings.  The profiler drops a
    run's kernel records now and then (``tools/device_ops_reads.py``), and
    a dropped record only lowers a reading."""
    reads = device_ops_reads(one_run, DEVICE_OPS_READS)
    return {k: max(r[k] for r in reads) for k in reads[0]}


class _Forget(dict):
    """A cache that keeps nothing: every dispatch rebuilds."""

    def __setitem__(self, key, value):
        pass


def rebuilt_and_cached(backend, one_run) -> dict:
    """The device operations of one main-path run with the fused kernel's
    fixed inputs (rule table, key, nonce, NAT address) rebuilt on every
    dispatch, as before they were kept per deployment and device, and as
    they are now."""
    progs = [d.fused for d in backend.deployments.values()]
    kept = [p.prepared for p in progs]
    for p in progs:
        p.prepared = _Forget()
    rebuilt = device_ops(one_run)
    for p, k in zip(progs, kept):
        p.prepared = k
    return {"rebuilt_each_dispatch": rebuilt, "kept": device_ops(one_run)}


def profile_run(one_run, table: str = "chip_smoke_profile.txt") -> dict:
    """One more run of a path under ``torch.profiler``: wall time, device
    busy time (sum of CUDA kernel and memory-op durations), and the top
    device and host entries.  The full tables go to chiprun_out/``table``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy: dict[str, float] = {}
    for e in dev_ev:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    avgs = prof.key_averages()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / table).write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=40) + "\n" +
        avgs.table(sort_by="self_device_time_total", row_limit=40))
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda x: -x[1])[:8]
    total = sum(busy.values())
    return {"wall_ms": wall_ms, "device_busy_ms": total,
            "device_idle_share": 1 - total / wall_ms if dev_ev else None,
            "device_events": len(dev_ev),
            "top_device_ms": sorted(busy.items(), key=lambda x: -x[1])[:10],
            "top_host_self_ms": host}


def bucket_args(rng, n, table, ch, nat, dev):
    from repro_torch._u32 import arange32, narrow
    from repro_torch.serving.vpc import make_packets
    h, p = make_packets(n, seed=int(rng.integers(1 << 30)), device=dev)
    return dict(headers=h, payload=p, ctr=narrow(arange32(1, n, dev)),
                rule_table=table, key=ch["key"], nonce=ch["nonce"],
                nat_ip=nat, salt=0x9e3779b9)


def vpc_bound(card: Card, n: int, r: int, allowed: int):
    """Least ms of the fused datapath over n packets, r rules and this
    run's allowed packets (only those need a keystream): headers, payload
    and counter read and the verdict byte, headers and payload written,
    173 bytes a packet, against FW_OPS_PER_RULE a rule, the NAT hash and a
    ChaCha20 block per allowed packet at the integer issue rate.  Returns
    (ms, which binds, bytes, operations)."""
    nbytes = n * ((5 + 16 + 1) * 4 + 1 + (5 + 16) * 4) + r * 16 + 12 * 4
    ops = n * (FW_OPS_PER_RULE * r + NAT_OPS) + allowed * CHACHA_OPS_PER_BLOCK
    return (*card.bound(nbytes, ops), nbytes, ops)


def vpc_line(card: Card, args, launches: dict) -> dict:
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    n, r = args["headers"].shape[0], args["rule_table"].shape[0]
    out = vpc_datapath_cuda(**args)
    expect(same_triple(out, vpc_datapath_plain(**args)),
           "vpc_datapath differs from plain at the main-path shape")
    allowed = int(out[0].sum())
    bound, by, nbytes, ops = vpc_bound(card, n, r, allowed)
    diff = max_abs_err(out, vpc_datapath_plain(**args))
    return {"name": "vpc_datapath", "route": "cuda",
            "source": "src/repro_torch/csrc/vpc_datapath.cu",
            "replaces": "src/repro/kernels/vpc_datapath/kernel.py:89",
            "path": ", ".join(launches),
            "launches": sum(launches.values()), "launches_by_path": launches,
            "shape": {"N": n, "R": r, "allowed": allowed},
            "bit_exact": diff == 0, "max_abs_err": diff,
            "ms": cuda_ms(raw_vpc(args), 200),
            "call_ms": cuda_ms(lambda: vpc_datapath_cuda(**args), 50),
            "plain_ms": cuda_ms(lambda: vpc_datapath_plain(**args), 3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "int_ops": ops,
            "library_ms": None}


def max_abs_err(a, b) -> int:
    """Largest absolute difference over a tuple of integer tensors."""
    import torch
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


# ------------------------------------------------------------ 5. encrypt ----
def encrypt_path(dev, card: Card, n_bytes: int = 64 << 20):
    import torch

    from repro_torch.kernels.chacha20.kernel import (chacha20_xor_cuda,
                                                     chacha20_xor_plain)
    from repro_torch.kernels.chacha20.ops import (blocks_to_bytes,
                                                  bytes_to_blocks, encrypt)
    rng = np.random.default_rng(5)
    raw = rng.bytes(n_bytes)
    key = u32(rng, (8,)).to(dev)
    nonce = u32(rng, (3,)).to(dev)
    chacha20_xor_cuda.launches = 0           # this path's count starts here
    blocks, n = bytes_to_blocks(raw, device=dev)
    ct = encrypt(blocks, key, nonce)
    ct_bytes = blocks_to_bytes(ct, n)
    back = blocks_to_bytes(encrypt(bytes_to_blocks(ct_bytes, dev)[0], key,
                                   nonce), n)
    launches = chacha20_xor_cuda.launches
    expect(launches == 2, f"encrypt path launched the kernel {launches}x")
    expect(ct_bytes != raw and back == raw, "64 MiB round trip")
    plain = chacha20_xor_plain(blocks, key, nonce, 1)
    diff = max_abs_err((ct,), (plain,))
    expect(diff == 0, "encrypt differs from plain")
    nblk = blocks.shape[0]
    bound, by = card.bound(nblk * 128 + 11 * 4, nblk * CHACHA_OPS_PER_BLOCK)
    ms = cuda_ms(raw_chacha(blocks, key, nonce, 1), 100)
    call_ms = cuda_ms(lambda: chacha20_xor_cuda(blocks, key, nonce, 1), 50)
    record = {"phase": "encrypt", "bytes": n_bytes, "blocks": nblk,
              "round_trip": True, "kernel_ms": ms, "call_ms": call_ms,
              "kernel_gbyte_per_s": n_bytes / ms / 1e6}
    line = {"name": "chacha20_xor", "route": "cuda",
            "source": "src/repro_torch/csrc/chacha20.cu",
            "replaces": "src/repro/kernels/chacha20/kernel.py:43",
            "path": "encrypt", "launches": launches,
            "shape": {"N": nblk}, "bit_exact": True, "max_abs_err": diff,
            "ms": ms, "call_ms": call_ms,
            "plain_ms": cuda_ms(
                lambda: chacha20_xor_plain(blocks, key, nonce, 1), 3),
            "bound_ms": bound, "bound_by": by,
            "bytes": nblk * 128 + 11 * 4,
            "int_ops": nblk * CHACHA_OPS_PER_BLOCK, "library_ms": None}
    return record, line


# -------------------------------------------------------------- 6. serve ----
def layer_counts(cfg) -> dict:
    """Launches of each serving kernel per prefill group and per decode
    step, from the config's layer kinds."""
    kinds = cfg.layer_kinds()
    attn = sum(m == "attn" for m, _ in kinds)
    mamba = sum(m == "mamba" for m, _ in kinds)
    rwkv = sum(m == "rwkv" for m, _ in kinds)
    moe = sum(c == "moe" for _, c in kinds)
    return {"prefill": {"flash_attention": attn, "moe_gmm": 3 * moe,
                        "mamba_ssm": mamba, "rwkv6_wkv": rwkv},
            "decode": {"flash_attention": 0, "moe_gmm": 3 * moe,
                       "mamba_ssm": mamba, "rwkv6_wkv": rwkv}}


def serve_path(dev, card: Card, phase: str, cfg, requests: int,
               reduced: dict, profile: bool = False):
    """Drive ``Platform(ServeBackend(cfg))`` with two tenants and
    ``requests`` prompts.  Returns the phase record and, per serving kernel
    the path launched, its inputs at the path's typical prefill shape (for
    the kernels line)."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.api import SERVE_SPECS, Platform, ServeBackend, nt
    from repro_torch.kernels.chacha20.kernel import chacha20_xor_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    from repro_torch.models import apply_prefill, init_params
    from repro_torch.serving.engine import EngineConfig

    kernels = {"flash_attention": flash_attention_cuda, "moe_gmm": moe_gmm_cuda,
               "mamba_ssm": mamba_ssm_cuda, "rwkv6_wkv": rwkv6_wkv_cuda}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    pages = -(-(SERVE_PROMPT[1] + SERVE_MAX_NEW) // 16)
    ecfg = EngineConfig(batch_sizes=(1, 2, 4), max_len=SERVE_MAX_LEN,
                        mem_pages=requests * pages + 64, epoch_requests=6)
    backend = ServeBackend(cfg, ecfg, params=params, device=dev)
    plat = Platform(backend, specs=SERVE_SPECS)
    chain = nt("cache") >> nt("prefill") >> nt("decode")
    deps = {"gold": plat.tenant("gold", weight=2.0).deploy(chain),
            "free": plat.tenant("free", weight=1.0).deploy(chain)}
    t0 = time.perf_counter()
    backend.prelaunch()
    prelaunch_s = time.perf_counter() - t0

    rng = np.random.default_rng(SERVE_SEED)
    prompts = [rng.integers(2, cfg.vocab_size,
                            int(rng.integers(SERVE_PROMPT[0],
                                             SERVE_PROMPT[1] + 1)),
                            dtype=np.int64).astype(np.int32)
               for _ in range(requests)]
    owner = ["gold" if i % 3 else "free" for i in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    for kernel in (*kernels.values(), vpc_datapath_cuda, chacha20_xor_cuda):
        kernel.launches = 0                  # this path's counts start here
    flash_attention_cuda.shapes.clear()
    moe_gmm_cuda.shapes.clear()
    rwkv6_wkv_cuda.shapes.clear()
    mamba_ssm_cuda.shapes.clear()
    t0 = time.perf_counter()
    reqs = [deps[o].inject(p, max_new=SERVE_MAX_NEW)
            for o, p in zip(owner, prompts)]
    plat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = deps[owner[0]].inject(prompts[0], max_new=SERVE_MAX_NEW)
    plat.run()
    launches = {name: k.launches for name, k in kernels.items()}
    shapes = dict(flash_attention_cuda.shapes)
    gmm_shapes = dict(moe_gmm_cuda.shapes)
    wkv_shapes = dict(rwkv6_wkv_cuda.shapes)
    scan_shapes = dict(mamba_ssm_cuda.shapes)
    other = vpc_datapath_cuda.launches + chacha20_xor_cuda.launches
    rep = plat.report()

    # ---- checks
    for r in reqs:
        expect(len(r.out) == SERVE_MAX_NEW and not r.cached and
               all(0 <= t < cfg.vocab_size for t in r.out),
               f"request {r.rid}: {len(r.out)} tokens {r.out[:4]}...")
    expect(again.cached and again.out == reqs[0].out,
           "the repeated prompt did not hit the cache NT")
    expect(rep.extra["cache_hits"] == 1, "cache hits != 1")
    # the prefill groups, from the requests: one group's members share its
    # first-token time; its prompts are left-padded to the longest
    members: dict[float, list] = {}
    for r in reqs:
        members.setdefault(r.t_first, []).append(r)
    groups = list(members.values())
    steps = len(groups) * (SERVE_MAX_NEW - 1)
    per = layer_counts(cfg)
    for name, n in launches.items():
        want = per["prefill"][name] * len(groups) + per["decode"][name] * steps
        expect(n == want, f"{name} launches {n} != {per['prefill'][name]} x "
               f"{len(groups)} prefill groups + {per['decode'][name]} x "
               f"{steps} decode steps")
    expect(other == 0, f"the serve path launched VPC kernels {other}x")
    # the per-layer prefill kernel's own record of its (B, S): one launch
    # per attention layer (with no attention, per RWKV layer) per group, at
    # each group's longest prompt and a batch size that holds it; RWKV's
    # decode launches are the (B, 1) entries, one per layer per step
    n_attn = per["prefill"]["flash_attention"]
    n_wkv = per["prefill"]["rwkv6_wkv"]
    expect(n_attn or n_wkv, f"{cfg.name}: no prefill kernel records shapes")
    n_per, by_shape = (n_attn, shapes) if n_attn else (
        n_wkv, {bs_s: n for bs_s, n in wkv_shapes.items() if bs_s[1] > 1})
    shape_list = sorted((b, s) for (b, s), n in by_shape.items()
                        for _ in range(n // n_per))
    expect(all(n % n_per == 0 for n in by_shape.values()) and
           sorted(s for _, s in shape_list) ==
           sorted(max(len(r.prompt) for r in g) for g in groups),
           f"kernel shapes {by_shape} do not match the prefill groups")
    if n_wkv:
        decode_launches = sum(n for (_, s), n in wkv_shapes.items() if s == 1)
        expect(decode_launches == per["decode"]["rwkv6_wkv"] * steps,
               f"rwkv6_wkv decode launches {decode_launches} != "
               f"{per['decode']['rwkv6_wkv']} x {steps} decode steps")
    # the largest group once more, from its requests: each launch of each
    # kernel against its plain version on the same inputs (the path's real
    # activations), then the logits against a prefill with every kernel
    # replaced by its plain version (attention rounding as the JAX
    # package's XLA fallback does), and against one with the plain
    # attention (f32 probabilities).  Both take the kernel prefill's expert
    # choices: a token whose top-k probabilities nearly tie takes other
    # experts under another summation order (not a fault, as the reference
    # says), and one such flip moves the logits far more than the kernels'
    # rounding does.  A third all-plain prefill routes on its own; its
    # logits and the tokens whose experts differ are reported beside.
    # Without attention the plain prefill is the all-plain one; RWKV's
    # logits take their own gates (:func:`rwkv_gates`).
    bs, S = max(shape_list)
    group = next(g for g in groups if max(len(r.prompt) for r in g) == S)
    expect(len(group) <= bs, f"a group of {len(group)} in batch {bs}")
    rows = np.zeros((bs, S), np.int32)
    for j, r in enumerate(group):
        rows[j, S - len(r.prompt):] = r.prompt         # left-pad, as served
    tokens = torch.from_numpy(rows).to(dev)
    errs: dict[str, list] = {name: [] for name in kernels}
    typical: dict = {}
    routes: dict[str, dict] = {"kernels": {}, "plain": {}}
    plain_ops = plain_kernels()
    fallback = {**plain_ops, "attention": attention_fallback}
    with torch.inference_mode():
        served, _ = apply_prefill(params, cfg, {"tokens": tokens},
                                  max_len=SERVE_MAX_LEN)
        got = prefill_logits(params, cfg, tokens, {
            **checked_kernels(errs, typical),
            "route": routed(cfg, record=routes["kernels"])})
        pinned = routed(cfg, pinned=routes["kernels"])
        want = prefill_logits(params, cfg, tokens, {**fallback,
                                                    "route": pinned})
        plain = prefill_logits(params, cfg, tokens, {
            **plain_ops, "route": pinned}) if n_attn else want
        free = prefill_logits(params, cfg, tokens, {
            **fallback, "route": routed(cfg, record=routes["plain"])}) \
            if cfg.n_experts else want
    for name, e in errs.items():
        expect(len(e) == per["prefill"][name],
               f"{name} checked {len(e)} launches of one prefill group")
    expect(torch.equal(got, served),
           "the checked prefill differs from apply_prefill")
    expect(bool(torch.isfinite(got).all()), "non-finite logits")

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())
    scale = float(want.float().abs().max())
    flips = sum(int((k.sort(-1).values != routes["plain"][i].sort(-1)
                     .values).any(-1).sum())
                for i, k in routes["kernels"].items())
    logits = {"bs": bs, "S": S, "rows": len(group), "max_abs": scale,
              "max_abs_err": diff(got, want), "rel_err": diff(got, want) /
              scale, "max_abs_err_vs_plain": diff(got, plain),
              "plain_versions_max_abs_err": diff(plain, want),
              "kernel_max_abs_err": {n: max(e) for n, e in errs.items() if e},
              "same_argmax_rows": int((got.argmax(-1) ==
                                       want.argmax(-1)).sum()),
              "routing_flips": flips,
              "routed_tokens": sum(k.shape[0] * k.shape[1]
                                   for k in routes["kernels"].values()),
              "own_routing_max_abs_err": diff(got, free),
              "own_routing_same_argmax_rows": int((got.argmax(-1) ==
                                                   free.argmax(-1)).sum())}
    # element-wise, one bf16 step in one layer grows through the bf16
    # layers past the reference's 3e-2 (two plain versions differ as much),
    # so the logits are held to it relative to their own scale
    held = [("bf16", diff(got, want), FA_TOL["torch.bfloat16"] * scale)]
    if n_wkv:
        held = rwkv_gates(params, cfg, tokens, got, want, logits)
    for what, err, limit in held:
        expect(err <= limit, f"prefill logits ({what}) with the kernels "
               f"differ from the all-plain prefill's (same experts) by "
               f"{err} > {limit}: {logits}")

    ttft = [r.t_first - r.t_submit for r in reqs]
    record = {
        "phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
        "reduced": reduced,
        "d_model": cfg.d_model, "params": n_params,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "init_seconds": init_s, "prelaunch_seconds": prelaunch_s,
        "requests": len(reqs) + 1, "prompt_tokens": sum(map(len, prompts)),
        "seconds": wall,
        "generated_tokens": sum(len(r.out) for r in reqs),
        "tokens_per_s": sum(len(r.out) for r in reqs) / wall,
        "mean_ttft_s": sum(ttft) / len(ttft), "max_ttft_s": max(ttft),
        "completions": {n: t.pkts_done for n, t in rep.tenants.items()},
        "cache_hits_by_tenant": {n: t.extra["cached"]
                                 for n, t in rep.tenants.items()},
        "cache": [rep.extra["cache_hits"], rep.extra["cache_misses"]],
        "compile_log": [[k, b, round(sec, 4)]
                        for k, b, sec in rep.extra["compile_log"]],
        "prefill_groups": [list(g) for g in shape_list],
        "decode_steps": steps,
        "launches": launches, "launches_per_prefill_group": per["prefill"],
        "launches_per_decode_step": per["decode"],
        "logits_vs_plain": logits,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    # the typical prefill shape: the most frequent batch size, then the
    # median prompt length among its groups; the kernels line times the
    # attention kernel there and the others at the checked group's shape
    if n_attn:
        by_bs: dict[int, list] = {}
        for b, s in shape_list:
            by_bs.setdefault(b, []).append(s)
        common = max(by_bs, key=lambda b: (len(by_bs[b]), b))
        s_med = sorted(by_bs[common])[len(by_bs[common]) // 2]
        H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        cdt = "torch." + cfg.compute_dtype
        typical["flash_attention"] = fa_inputs(rng, common, s_med, H, Kv, hd,
                                               cdt, dev)
        per_group = [cuda_ms(raw_flash(*fa_inputs(rng, b, s, H, Kv, hd, cdt,
                                                  dev)), 10)
                     for b, s in shape_list]
        record["flash_attention_ms_per_run"] = n_attn * sum(per_group)
        record["flash_attention_share_of_run"] = \
            record["flash_attention_ms_per_run"] / (wall * 1e3)
    # the scans' device ms a run: launches at each (B, S) of the run times
    # the raw-launch ms there (prefill from a zero state, decode steps from
    # a carried one, as the path launches them; a decode step's raw launch
    # is paced by the host, ~7 us, more than its device time)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    per_run = {
        "rwkv6_wkv": (wkv_shapes, lambda b, s: raw_wkv(wkv_inputs(
            gen, b, s, cfg.rwkv_heads, cfg.rwkv_head_size, dev, s == 1))),
        "mamba_ssm": (scan_shapes, lambda b, s: raw_scan(scan_inputs(
            gen, b, s, cfg.mamba_expand * cfg.d_model, dev, s == 1)))}
    for name, (by_shape, raw) in per_run.items():
        if by_shape:
            ms = {(b, s): cuda_ms(raw(b, s), 50 if s == 1 else 10)
                  for b, s in by_shape}
            record[f"{name}_ms_per_run"] = sum(n * ms[bs_s] for bs_s, n
                                               in by_shape.items())
            record[f"{name}_share_of_run"] = \
                record[f"{name}_ms_per_run"] / (wall * 1e3)
            record[f"{name}_ms_by_shape"] = [[b, s, n, ms[b, s]] for (b, s), n
                                             in sorted(by_shape.items())]
    if gmm_shapes:           # the most frequent launch: a decode step's
        typical["moe_gmm_decode_rows"] = max(gmm_shapes,
                                             key=gmm_shapes.get)[1]
    if profile:
        more = [rng.integers(2, cfg.vocab_size, int(n), dtype=np.int64)
                .astype(np.int32)
                for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, 4)]

        def one_run():
            for p in more:
                deps["gold"].inject(p, max_new=SERVE_MAX_NEW)
            plat.run()
        record["profile"] = profile_run(one_run,
                                        f"chip_smoke_profile_{phase}.txt")
    return record, typical


def checked_kernels(errs: dict, typical: dict) -> dict:
    """The serving kernels as callables for :func:`prefill_logits` that
    launch each kernel, hold its result element-wise against the plain
    version on the same inputs (appending the largest error to ``errs``),
    keep the first launch's inputs in ``typical`` and return the kernel's
    result."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda, mamba_ssm_ref
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref

    def attention(q, k, v):
        out = flash_attention_cuda(q, k, v, True)
        errs["flash_attention"].append(
            close(out, attention_ref(q, k, v, True), "flash_attention"))
        return out

    def gmm(x, w):
        out = moe_gmm_cuda(x, w)
        errs["moe_gmm"].append(close(out, moe_gmm_ref(x, w), "moe_gmm"))
        typical.setdefault("moe_gmm", (x, w))
        return out

    def scan(x, dt, Bmat, Cmat, A, D):
        y, h = mamba_ssm_cuda(x, dt, Bmat, Cmat, A, D)
        want_y, want_h = mamba_ssm_ref(x, dt, Bmat, Cmat, A, D)
        errs["mamba_ssm"].append(max(
            close(y, want_y, "mamba_ssm y", SCAN_TOL),
            close(h, want_h, "mamba_ssm h_final", SCAN_TOL)))
        typical.setdefault("mamba_ssm", dict(x=x, dt=dt, Bmat=Bmat,
                                             Cmat=Cmat, A=A, D=D))
        return y, h

    def wkv(r, k, v, w, u):
        y, st = rwkv6_wkv_cuda(r, k, v, w, u)
        want_y, want_st = rwkv6_wkv_ref(r, k, v, w, u)
        errs["rwkv6_wkv"].append(
            wkv_close(y, st, want_y, want_st, "rwkv6_wkv"))
        typical.setdefault("rwkv6_wkv", dict(r=r, k=k, v=v, w=w, u=u))
        return y, st
    return {"attention": attention, "gmm": gmm, "scan": scan, "wkv": wkv}


def rwkv_gates(params, cfg, tokens, got, want, logits: dict) -> list:
    """The RWKV path's logit gates for the checked group, as (what, error,
    limit).  Through 32 random bf16 RWKV layers the served logits cannot be
    held to 3e-2 of their scale: any two f32 scans a rounding apart flip
    bf16 roundings of the group-norm output in every layer, and every
    token's k v stays in the state (decay ~0.9975 a step) for hundreds of
    tokens.  So the kernel prefill is held to the all-plain one at 3e-2 of
    scale with the model computing in f32, where nothing rounds to bf16,
    and two faulty scans, one all in bf16 (state included) and one without
    the bonus term (u = 0), must fail that gate; the bf16 logits are held
    to twice the spread between the all-plain prefill and one whose scan
    runs in f64.  Adds each reading to ``logits``."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref

    def plain_in(dtype, bonus: bool = True):
        def wkv(r, k, v, w, u):
            u = u if bonus else torch.zeros_like(u)
            y, st = rwkv6_wkv_ref(*(a.to(dtype) for a in (r, k, v, w, u)))
            return y.float(), st.float()
        return wkv

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())
    cfg32 = cfg.replace(compute_dtype="float32")
    with torch.inference_mode():
        f64 = prefill_logits(params, cfg, tokens,
                             {"wkv": plain_in(torch.float64)})
        want32 = prefill_logits(params, cfg32, tokens, {"wkv": rwkv6_wkv_ref})
        got32 = prefill_logits(params, cfg32, tokens, {"wkv": rwkv6_wkv_cuda})
        faulty = {name: prefill_logits(params, cfg32, tokens, {"wkv": fn})
                  for name, fn in (
                      ("bf16_scan", plain_in(torch.bfloat16)),
                      ("no_bonus", plain_in(torch.float32, bonus=False)))}
    scale32 = float(want32.abs().max())
    limit32 = FA_TOL["torch.bfloat16"] * scale32
    spread = diff(f64, want)
    logits["f64_scan_plain_max_abs_err"] = spread
    logits["f64_scan_plain_rel_err"] = spread / logits["max_abs"]
    logits["float32_compute"] = {
        "max_abs": scale32, "max_abs_err": diff(got32, want32),
        "rel_err": diff(got32, want32) / scale32,
        "faulty_scans_rel_err": {n: diff(f, want32) / scale32
                                 for n, f in faulty.items()}}
    for name, f in faulty.items():
        expect(diff(f, want32) > limit32, f"the float32-compute gate passes "
               f"a faulty scan ({name}): {logits['float32_compute']}")
    return [("float32 compute", diff(got32, want32), limit32),
            ("bf16, against twice the f64-scan spread", diff(got, want),
             2.0 * spread)]


def plain_kernels() -> dict:
    """The serving kernels' plain versions as callables for
    :func:`prefill_logits` (attention with f32 probabilities)."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.mamba_scan import mamba_ssm_ref
    from repro_torch.kernels.moe_gmm import moe_gmm_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_ref
    return {"attention": lambda q, k, v: attention_ref(q, k, v, True),
            "gmm": moe_gmm_ref, "scan": mamba_ssm_ref, "wkv": rwkv6_wkv_ref}


def routed(cfg, record: dict | None = None, pinned: dict | None = None):
    """A ``route(layer, p, x) -> (gates, idx)`` for :func:`prefill_logits`:
    the model's ``router_topk``, each MoE layer's expert indices kept in
    ``record``; or, with ``pinned``, layer i routed to ``pinned[i]`` with
    its own router probabilities of those experts as gates, normalised as
    ``router_topk`` does."""
    import torch

    from repro_torch.models.moe import router_topk

    def route(layer: int, p, x):
        if pinned is None:
            gates, idx, _ = router_topk(p, x, cfg)
            record[layer] = idx
            return gates, idx
        idx = pinned[layer]
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        gates = probs.gather(-1, idx)
        return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx
    return route


def prefill_logits(params, cfg, tokens, ops):
    """``apply_prefill``'s logits (no cache kept), composed here from the
    model's own pieces with the kernels passed in ``ops``:
    ``attention(q, k, v)``, ``gmm(x, w)``, ``scan(x, dt, B, C, A, D) -> (y,
    h)``, ``wkv(r, k, v, w, u) -> (y, state)`` and ``route(layer, p, x) ->
    (gates, idx)``.  With the kernels themselves it must equal
    ``apply_prefill`` bit for bit."""
    import torch

    from repro_torch.models import rwkv6 as R
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import linear, mlp, norm_apply
    from repro_torch.models.model import embed_inputs
    x = embed_inputs(params, cfg, {"tokens": tokens})
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    pos = pos.expand(B, S)
    for i, lp in enumerate(params["layers"]):
        h = norm_apply(cfg.norm, lp["norm1"], x)
        mix, ch = cfg.mixer_kind(i), cfg.channel_kind(i)
        if mix == "attn":
            q, k, v = _project_qkv(lp["attn"], h, cfg, pos)
            h = linear(lp["attn"]["wo"],
                       ops["attention"](q, k, v).reshape(B, S, -1))
        elif mix == "mamba":
            h = mamba_prefill(lp["mamba"], h, cfg, ops["scan"])
        else:           # RWKV time mix from a zero state, the scan passed in
            r, k, v, w, u, g = R.timemix_inputs(lp["rwkv_tm"], h, cfg)
            h = R.timemix_out(lp["rwkv_tm"], h, cfg,
                              ops["wkv"](r, k, v, w, u)[0], g)
        x = x + h
        h = norm_apply(cfg.norm, lp["norm2"], x)
        if ch == "mlp":
            x = x + mlp(lp["mlp"], h, cfg.mlp_kind)
        elif ch == "moe":
            x = x + moe_prefill(lp["moe"], h, cfg, ops, i)
        else:
            x = x + R.channelmix_apply(lp["rwkv_cm"], h, cfg)[0]
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    return linear(params["head"], x)[:, 0, :]


def mamba_prefill(p, u, cfg, scan):
    """``models/mamba.py`` ``mamba_apply`` from a zero state, with the
    selective scan passed in."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import linear
    from repro_torch.models.mamba import _causal_conv
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    x, z = torch.chunk(linear(p["in_proj"], u), 2, dim=-1)
    x = F.silu(_causal_conv(p, x)[0])
    dbl = linear(p["x_proj"], x)
    dt = F.softplus(linear(p["dt_proj"], dbl[..., :dtr]).float()
                    + p["dt_bias"])
    y, _ = scan(x.float(), dt, dbl[..., dtr:dtr + ds].float().contiguous(),
                dbl[..., dtr + ds:].float().contiguous(),
                -torch.exp(p["A_log"].float()), p["D"].float())
    return linear(p["out_proj"], y.to(u.dtype) * F.silu(z))


def moe_prefill(p, x, cfg, ops, layer: int):
    """``models/moe.py`` ``moe_apply`` (capacity dispatch), with the
    routing and the three expert matmuls passed in."""
    import torch.nn.functional as F

    from repro_torch.models.moe import (_group_combine, _group_dispatch,
                                        capacity)
    B, S, d = x.shape
    E = cfg.n_experts
    gates, idx = ops["route"](layer, p, x)
    C = capacity(S, cfg)
    x_exp, slot, keep, t_s, g_s = _group_dispatch(x, gates, idx, E, C)
    xe = x_exp.transpose(0, 1).reshape(E, B * C, d)
    gmm = ops["gmm"]
    ye = gmm(F.silu(gmm(xe, p["gate"])) * gmm(xe, p["up"]), p["down"])
    return _group_combine(ye.reshape(E, B, C, d).transpose(0, 1), slot,
                          keep, t_s, g_s, S)


def attention_fallback(q, k, v):
    """Causal attention with the JAX package's XLA fallback math
    (``models/attention.py`` ``_fa_forward``, one query block): f32 scores,
    the unnormalised probabilities rounded to v's dtype for the PV product,
    then divided by their f32 sum."""
    import torch
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (hd ** -0.5)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = o / den.permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, H, hd).to(q.dtype)


def raw_flash(q, k, v, causal: bool = True, lse: bool = False):
    import torch
    out = torch.empty_like(q)
    B, S, H, hd = q.shape
    ls = torch.empty((B, S, H), dtype=torch.float32, device=q.device) \
        if lse else None
    return raw_launch("flash_attention", "flash_attention_launch", [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if ls is None else ls.data_ptr(), B, S, H, k.shape[2], hd,
        1 if q.dtype == torch.bfloat16 else 0, int(causal),
        torch.cuda.current_stream().cuda_stream], (q, k, v, out, ls))


def flash_bound(card: Card, q, k, lse: bool) -> tuple[float, str, float,
                                                       float]:
    """Least ms of causal attention on q's and k's shapes: 4 B H hd
    S (S + 1) / 2 FLOP at the card's peak for the dtype, against q, k, v
    read and o (and the f32 LSE) written once."""
    B, S, H, hd = q.shape
    flops = 4 * B * H * hd * S * (S + 1) / 2
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + \
        (4 * B * S * H if lse else 0)
    bound, by = card.bound(nbytes, flops, PEAK_FLOPS[str(q.dtype)])
    return bound, by, nbytes, flops


def sdpa_ms(q, k, v, reps: int) -> float:
    """Device ms of one causal ``scaled_dot_product_attention`` call on
    (B, H, S, hd) copies of the inputs (GQA by ``enable_gqa``)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)


def flash_line(card: Card, fa, launches: int) -> dict:
    """The flash kernel at serve's typical prefill shape, with and without
    the LSE, and at the train step's shape with the LSE, where it runs 16
    times a step (random inputs)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v = fa
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    got = flash_attention_cuda(q, k, v, True)
    err = close(got, attention_ref(q, k, v, True), "flash_attention")
    bound, by, nbytes, flops = flash_bound(card, q, k, False)
    tq, tk, tv = fa_inputs(np.random.default_rng(17), TRAIN_B, TRAIN_S, H,
                           Kv, hd, str(q.dtype), q.device)
    t_out, t_lse = flash_attention_cuda(tq, tk, tv, True, return_lse=True)
    want, want_lse = attention_ref(tq, tk, tv, True, return_lse=True)
    t_err = close(t_out, want, "flash_attention train shape")
    t_lse_err = close(t_lse, want_lse, "flash_attention train shape lse",
                      FA_TOL[str(q.dtype)])
    del t_out, t_lse, want, want_lse
    t_bound, t_by, t_bytes, t_flops = flash_bound(card, tq, tk, True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
            "path": "serve", "launches": launches,
            "shape": {"B": B, "S": S, "H": H, "Kv": Kv, "hd": hd,
                      "dtype": str(q.dtype), "causal": True},
            "max_abs_err": err,
            "ms": cuda_ms(raw_flash(q, k, v), 20),
            "lse_ms": cuda_ms(raw_flash(q, k, v, lse=True), 20),
            "call_ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), 10),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, True), 3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops,
            "library_ms": sdpa_ms(q, k, v, 20),
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True), (B, H, S, hd)",
            "train": {"shape": {"B": TRAIN_B, "S": TRAIN_S, "H": H,
                                "Kv": Kv, "hd": hd, "lse": True},
                      "max_abs_err": t_err, "lse_max_abs_err": t_lse_err,
                      "ms": cuda_ms(raw_flash(tq, tk, tv, lse=True), 10),
                      "no_lse_ms": cuda_ms(raw_flash(tq, tk, tv), 10),
                      "bound_ms": t_bound, "bound_by": t_by,
                      "bytes": t_bytes, "flops": t_flops,
                      "library_ms": sdpa_ms(tq, tk, tv, 10)}}


def raw_gmm(x, w):
    import torch
    E, M, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, M, f), dtype=x.dtype, device=x.device)
    code = {torch.float32: 0, torch.bfloat16: 1}
    return raw_launch("moe_gmm", "moe_gmm_launch", [
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, d, f,
        code[x.dtype], code[w.dtype],
        torch.cuda.current_stream().cuda_stream], (x, w, out))


def gmm_bound(card: Card, x, w) -> tuple[float, str, int, float]:
    E, M, d = x.shape
    f = w.shape[2]
    flops = 2 * E * M * d * f
    nbytes = (x.numel() + E * M * f) * x.element_size() + \
        w.numel() * w.element_size()
    bound, by = card.bound(nbytes, flops, PEAK_FLOPS[str(x.dtype)])
    return bound, by, nbytes, flops


def gmm_line(card: Card, typical, launches: int, path: str) -> dict:
    """The grouped matmul at the checked prefill group's gate launch (the
    path's own activations and f32 weights) and at a decode launch's rows,
    each beside like-for-like PyTorch calls: the kernel's bf16-weight route
    against ``torch.bmm`` on the same bf16 weights, and its f32-weight route
    against ``w.to(torch.bfloat16)`` then ``torch.bmm`` (two calls, the cast
    inside the timing)."""
    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_ref
    x, w = typical["moe_gmm"]
    E, M, d = x.shape
    f = w.shape[2]
    err = close(moe_gmm_cuda(x, w), moe_gmm_ref(x, w), "moe_gmm")
    wb = w.to(x.dtype)
    xd = torch.randn((E, typical["moe_gmm_decode_rows"], d),
                     device=x.device).to(x.dtype)
    err = max(err, close(moe_gmm_cuda(x, wb), moe_gmm_ref(x, wb),
                         "moe_gmm bf16 weights"),
              close(moe_gmm_cuda(xd, w), moe_gmm_ref(xd, w), "moe_gmm decode"))
    bound, by, nbytes, flops = gmm_bound(card, x, w)

    def yardsticks(rows, reps: int) -> dict:
        """Kernel and PyTorch ms of both weight routes at these rows."""
        f_bound, f_by, _, _ = gmm_bound(card, rows, w)
        b_bound, b_by, _, _ = gmm_bound(card, rows, wb)
        return {"f32_weights": {
                    "ms": cuda_ms(raw_gmm(rows, w), reps),
                    "bound_ms": f_bound, "bound_by": f_by,
                    "two_calls_ms": cuda_ms(
                        lambda: torch.bmm(rows, w.to(torch.bfloat16)), reps),
                    "two_calls": "w.to(torch.bfloat16) then torch.bmm, the "
                                 "cast inside the timing"},
                "bf16_weights": {
                    "ms": cuda_ms(raw_gmm(rows, wb), reps),
                    "bound_ms": b_bound, "bound_by": b_by,
                    "library_ms": cuda_ms(lambda: torch.bmm(rows, wb), reps),
                    "library": "torch.bmm on the same bf16 weights"}}

    prefill = yardsticks(x, 10)
    decode = {"M": xd.shape[1], **yardsticks(xd, 20)}
    return {"name": "moe_gmm", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm/kernel.py:39",
            "path": path, "launches": launches,
            "shape": {"E": E, "M": M, "d": d, "f": f, "x": str(x.dtype),
                      "w": str(w.dtype)},
            "max_abs_err": err,
            "ms": prefill["f32_weights"]["ms"],
            "call_ms": cuda_ms(lambda: moe_gmm_cuda(x, w), 5),
            "plain_ms": cuda_ms(lambda: moe_gmm_ref(x, w), 3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops,
            "library_ms": prefill["bf16_weights"]["library_ms"],
            "library": "torch.bmm(x, w in x's dtype), the weights cast "
                       "once outside the timing; like for like under "
                       "\"prefill\" and \"decode\"",
            "prefill": prefill, "decode": decode}


def raw_scan(a: dict):
    import torch
    B, S, di = a["x"].shape
    y = torch.empty_like(a["x"])
    h = torch.empty((B, di, SCAN_DS), dtype=torch.float32,
                    device=a["x"].device)
    h0 = a.get("h0")
    return raw_launch("mamba_scan", "mamba_ssm_launch", [
        a["x"].data_ptr(), a["dt"].data_ptr(), a["Bmat"].data_ptr(),
        a["Cmat"].data_ptr(), a["A"].data_ptr(), a["D"].data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        B, S, di, SCAN_DS, torch.cuda.current_stream().cuda_stream],
        (a, y, h))


def scan_bound(card: Card, B: int, S: int, di: int, h0: bool):
    """Bytes: x, dt and y (B, S, di), B and C (B, S, ds), A, D, the final
    state and h0 when given, f32 each.  Work: per (b, t, channel) ds
    exponentials on the special-function units, and 6 ds + 3 f32
    operations (dt*A; h*dA + dx*B as two products and a sum; h*C and its
    sum; dt*x, D*x and the last sum) at the f32 rate."""
    nbytes = 4 * (3 * B * S * di + 2 * B * S * SCAN_DS + di * SCAN_DS + di
                  + (2 if h0 else 1) * B * di * SCAN_DS)
    steps = B * S * di
    bound, by = card.bound_of(nbytes, [
        (steps * (6 * SCAN_DS + 3), PEAK_FLOPS["torch.float32"]),
        (steps * SCAN_DS, card.sfu_per_s)])
    return bound, by, nbytes, steps


def scan_line(card: Card, typical, launches: int, path: str) -> dict:
    """The selective scan at the checked prefill group's first Mamba layer
    (the path's own activations, from a zero state) and at a decode step of
    that batch (one step from a carried state)."""
    import torch

    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda, mamba_ssm_ref
    a = typical["mamba_ssm"]
    B, S, di = a["x"].shape
    y, h = mamba_ssm_cuda(**a)
    want_y, want_h = mamba_ssm_ref(**a)
    err = max(close(y, want_y, "mamba_ssm y", SCAN_TOL),
              close(h, want_h, "mamba_ssm h_final", SCAN_TOL))
    bound, by, nbytes, steps = scan_bound(card, B, S, di, False)
    dec = {k: (v[:, -1:].contiguous() if k in ("x", "dt", "Bmat", "Cmat")
               else v) for k, v in a.items()}
    dec["h0"] = torch.randn((B, di, SCAN_DS), device=a["x"].device)
    d_bound, d_by, _, _ = scan_bound(card, B, 1, di, True)
    return {"name": "mamba_ssm", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:57",
            "path": path, "launches": launches,
            "shape": {"B": B, "S": S, "di": di, "d_state": SCAN_DS,
                      "h0": False},
            "max_abs_err": err,
            "ms": cuda_ms(raw_scan(a), 10),
            "call_ms": cuda_ms(lambda: mamba_ssm_cuda(**a), 5),
            "plain_ms": cuda_ms(lambda: mamba_ssm_ref(**a), 1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": steps * (6 * SCAN_DS + 3), "exps": steps * SCAN_DS,
            "library_ms": None,
            "library": "none: no single PyTorch call",
            "decode": {"S": 1, "ms": cuda_ms(raw_scan(dec), 50),
                       "bound_ms": d_bound, "bound_by": d_by}}


def raw_wkv(a: dict):
    import torch
    B, S, H, hd = a["r"].shape
    y = torch.empty_like(a["r"])
    st = torch.empty((B, H, hd, hd), dtype=torch.float32,
                     device=a["r"].device)
    s0 = a.get("state0")
    return raw_launch("rwkv6_scan", "rwkv6_wkv_launch", [
        a["r"].data_ptr(), a["k"].data_ptr(), a["v"].data_ptr(),
        a["w"].data_ptr(), a["u"].data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), st.data_ptr(),
        B, S, H, hd, torch.cuda.current_stream().cuda_stream], (a, y, st))


def wkv_bound(card: Card, B: int, S: int, H: int, hd: int, state0: bool):
    """Bytes: r, k, v, w in and y out (B, S, H, hd), u, the final state and
    state0 when given, f32 each.  Work at the f32 rate: per (b, t, h, i, j)
    5 operations (r^T S: a product and a sum; the update w S + k v: two
    products and a sum), and per (b, t, h) 5 hd more for the bonus term,
    r^T diag(u) k v^T = (sum_i r_i u_i k_i) v_j (two products and a sum
    per i, a product and a sum per j)."""
    nbytes = 4 * (5 * B * S * H * hd + H * hd
                  + (2 if state0 else 1) * B * H * hd * hd)
    flops = 5 * B * S * H * hd * (hd + 1)
    bound, by = card.bound(nbytes, flops, PEAK_FLOPS["torch.float32"])
    return bound, by, nbytes, flops


def wkv_line(card: Card, typical, launches: int, path: str) -> dict:
    """The WKV kernel at the checked prefill group's first RWKV layer (the
    path's own activations, from a zero state) and at a decode step of that
    batch (one step from a carried state)."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref
    a = typical["rwkv6_wkv"]
    B, S, H, hd = a["r"].shape
    y, st = rwkv6_wkv_cuda(**a)
    want_y, want_st = rwkv6_wkv_ref(**a)
    err = wkv_close(y, st, want_y, want_st, "rwkv6_wkv")
    bound, by, nbytes, flops = wkv_bound(card, B, S, H, hd, False)
    dec = {k: (v[:, -1:].contiguous() if k in ("r", "k", "v", "w") else v)
           for k, v in a.items()}
    dec["state0"] = st
    d_bound, d_by, _, _ = wkv_bound(card, B, 1, H, hd, True)
    return {"name": "rwkv6_wkv", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:59",
            "path": path, "launches": launches,
            "shape": {"B": B, "S": S, "H": H, "hd": hd, "state0": False},
            "max_abs_err": err, "max_abs_y": float(want_y.abs().max()),
            "ms": cuda_ms(raw_wkv(a), 10),
            "call_ms": cuda_ms(lambda: rwkv6_wkv_cuda(**a), 5),
            "plain_ms": cuda_ms(lambda: rwkv6_wkv_ref(**a), 1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops, "library_ms": None,
            "library": "none: no single PyTorch call",
            "decode": {"S": 1, "ms": cuda_ms(raw_wkv(dec), 50),
                       "bound_ms": d_bound, "bound_by": d_by}}


# ----------------------------------------------------- quantize kernels ----
def check_quantize(dev) -> dict:
    """The quantize and dequantize kernels against their plain versions,
    bit for bit (q, scale and the dequantized values, ``torch.equal``, a
    NaN equal to a NaN), over the sweep, one whole embedding-sized row, an
    all-zero row, a row with one 1e30 among values near 1e-30, rows at
    QUANT_MAGNITUDES, views at an odd element offset and the quantize
    kernel's edges (its hold per block and per grid, rows across tiles,
    D = 0)."""
    import itertools

    import torch

    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              dequantize_int8_ref,
                                              quantize_int8_cuda,
                                              quantize_int8_ref)
    gen = torch.Generator(device=dev).manual_seed(17)

    def held(x, what: str, outs=(torch.float32, torch.bfloat16)) -> None:
        q, s = quantize_int8_cuda(x)
        qr, sr = quantize_int8_ref(x)
        torch.cuda.synchronize()
        expect(torch.equal(q, qr) and same_values(s, sr),
               f"quantize_int8 {what}: q or scale differs from plain")
        for dt in outs:
            expect(same_values(dequantize_int8_cuda(q, s, dt),
                               dequantize_int8_ref(qr, sr, dt)),
                   f"dequantize_int8 {what} -> {dt} differs from plain")

    n = 0
    for R, D, xd in itertools.product(*(QUANT_SWEEP[k]
                                        for k in ("R", "D", "x"))):
        x = (torch.randn((R, D), generator=gen, device=dev) * 3).to(
            getattr(torch, xd))
        held(x, f"R={R} D={D} x {xd}")
        n += 1
    row = torch.randn((1, EMBED_ELEMENTS), generator=gen, device=dev)
    held(row, f"(1, {EMBED_ELEMENTS}) f32", outs=(torch.float32,))
    del row
    zero = torch.zeros((2, 4097), device=dev)
    zero[1] = torch.randn(4097, generator=gen, device=dev)
    held(zero, "an all-zero row")
    q, s = quantize_int8_cuda(zero)
    expect(float(s[0, 0]) == float(np.float32(1e-12) / np.float32(127.0))
           and not q[0].any(), "the all-zero row's scale or q")
    spike = torch.full((1, 4097), 1e-30, device=dev)
    spike[0, 2000] = 1e30
    held(spike, "one 1e30 among 1e-30s")
    for mag in QUANT_MAGNITUDES:
        for xd in ("float32", "bfloat16"):
            x = (torch.randn((4, 40000), generator=gen, device=dev) *
                 mag).to(getattr(torch, xd))
            held(x, f"randn x {mag:g}, x {xd}")
            n += 1
    for xd in ("float32", "bfloat16"):
        base = (torch.randn((1 << 20) + 1, generator=gen, device=dev) *
                3).to(getattr(torch, xd))
        view = base[1:].view(1, -1)
        expect(view.data_ptr() % 16 != 0, "the odd-offset view is aligned")
        held(view, f"a view at an odd element offset, x {xd}")
    # the design's edges: rows on each side of one block's shared-memory
    # hold, of the whole grid's, and one more block's worth (blocks with
    # tiles to re-read); more rows than resident blocks; rows that tiles
    # cut; more rows than one launch's grid.y once allowed; D = 0
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize.kernel import SLOTS, TILE_BYTES
    lib = _build.library("quantize")
    edges = {}
    for code, xd in ((0, "float32"), (1, "bfloat16")):
        hold = SLOTS * TILE_BYTES // (4 - 2 * code)
        blocks = lib.quantize_int8_grid_blocks(code)
        expect(blocks > 0, f"quantize_int8_grid_blocks({code}) = {blocks}")
        edges[xd] = {"block_hold": hold, "grid_blocks": blocks}
        shapes = [(1, hold - 1), (1, hold), (1, hold + 1),
                  (1, blocks * hold - 1), (1, blocks * hold),
                  (1, blocks * hold + 1), (1, (blocks + 1) * hold + 1),
                  (blocks + 1, 4097), (7, 1000003), (70000, 3), (3, 0)]
        for R, D in shapes:
            x = (torch.randn((R, D), generator=gen, device=dev) * 3).to(
                getattr(torch, xd))
            held(x, f"R={R} D={D} x {xd}")
        edges[xd]["shapes"] = shapes
        n += len(shapes)
    q, s = quantize_int8_cuda(torch.zeros((3, 0), device=dev))
    expect(q.shape == (3, 0) and bool((s == float(
        np.float32(1e-12) / np.float32(127.0))).all()), "D = 0 rows' scale")
    return {"cases": n + 5, "sweep": QUANT_SWEEP, "edges": edges,
            "embedding_row": EMBED_ELEMENTS, "bit_exact": True}


def raw_quantize(x):
    """A closure that zeroes the amax scratch and launches the quantize
    kernels on fixed buffers (the wrapper's work without its checks and
    allocations)."""
    import torch
    R, D = x.shape
    q = torch.empty((R, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    amax = torch.zeros((R,), dtype=torch.int32, device=x.device)
    launch = raw_launch("quantize", "quantize_int8_launch", [
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, q.data_ptr(),
        scale.data_ptr(), amax.data_ptr(), R, D,
        torch.cuda.current_stream().cuda_stream], (x, q, scale, amax))

    def run():
        amax.zero_()
        launch()
    return run


def raw_dequantize(q, scale):
    import torch
    R, D = q.shape
    out = torch.empty((R, D), dtype=torch.float32, device=q.device)
    return raw_launch("quantize", "dequantize_int8_launch", [
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), 0, R, D,
        torch.cuda.current_stream().cuda_stream], (q, scale, out))


def quantize_lines(card: Card, launches: dict) -> list:
    """The kernels line's two quantize entries: each timed at the
    embedding's row (1, 622,329,856), and beside it at an MLP weight's (1,
    50,331,648) and the attention projections' (1, 16,777,216) and (1,
    4,194,304), f32 in and out, against 5 bytes an element (x read once
    and q written once; q read once and the output written once)."""
    import torch

    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              dequantize_int8_ref,
                                              quantize_int8_cuda,
                                              quantize_int8_ref)
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    for name, D in QUANT_ROWS.items():
        x = torch.randn((1, D), generator=gen, device="cuda")
        q, s = quantize_int8_cuda(x)
        qr, sr = quantize_int8_ref(x)
        out = dequantize_int8_cuda(q, s)
        expect(torch.equal(q, qr) and torch.equal(s, sr) and
               torch.equal(out, dequantize_int8_ref(qr, sr)),
               f"quantize at the {name} row differs from plain")
        bound, by = card.bound(5 * D + 4, 0)
        reps = 20 if D == EMBED_ELEMENTS else 100
        rows[name] = {
            "D": D,
            "quantize": {"ms": cuda_ms(raw_quantize(x), reps),
                         "call_ms": cuda_ms(lambda: quantize_int8_cuda(x),
                                            reps),
                         "plain_ms": cuda_ms(lambda: quantize_int8_ref(x),
                                             3),
                         "bound_ms": bound, "bound_by": by},
            "dequantize": {"ms": cuda_ms(raw_dequantize(q, s), reps),
                           "call_ms": cuda_ms(
                               lambda: dequantize_int8_cuda(q, s), reps),
                           "plain_ms": cuda_ms(
                               lambda: dequantize_int8_ref(q, s), 3),
                           "library_ms": cuda_ms(lambda: torch.mul(q, s),
                                                 reps),
                           "bound_ms": bound, "bound_by": by}}
        del x, q, s, qr, sr, out
    lines = []
    for name, at in (("quantize_int8", 34), ("dequantize_int8", 51)):
        kind = name.split("_")[0]
        emb = rows["embedding"][kind]
        lines.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": f"src/repro/kernels/quantize/kernel.py:{at}",
            "path": "train", "launches": launches[name],
            "shape": {"R": 1, "D": EMBED_ELEMENTS, "x": "torch.float32",
                      "out": "torch.float32"},
            "bit_exact": True, "max_abs_err": 0.0,
            "ms": emb["ms"], "call_ms": emb["call_ms"],
            "plain_ms": emb["plain_ms"], "bound_ms": emb["bound_ms"],
            "bound_by": emb["bound_by"], "bytes": 5 * EMBED_ELEMENTS + 4,
            "library_ms": emb.get("library_ms"),
            "library": "torch.mul(q, scale) (int8 x f32 promotes to f32)"
                       if kind == "dequantize" else
                       "none: no single PyTorch call",
            **{row: {"D": D, **rows[row][kind]}
               for row, D in QUANT_ROWS.items() if row != "embedding"}})
    return lines


# ------------------------------------------------------------ 7. train ----
@contextlib.contextmanager
def patched(module, **attrs):
    """Swap module attributes for the duration of a check (the model's
    attention op, the compression's quantize ops) and put them back."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def plain_fallback_attention(q, k, v, causal=True, return_lse=False):
    """The plain attention with the JAX model's XLA-fallback rounding (the
    probabilities rounded to v's dtype for the PV product, as the kernel
    does), with the rows' log-sum-exp."""
    from repro_torch.kernels.flash_attention import attention_ref
    out = attention_fallback(q, k, v)
    if not return_lse:
        return out
    return out, attention_ref(q, k, v, causal, return_lse=True)[1]


def grad_route(params, cfg, batch, attention=None):
    """One step's loss and gradient (the Trainer's compressed step takes
    its gradient of the f32 params so), with the model's attention op
    replaced by ``attention`` when given."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import attention as A
    if attention is None:
        (loss, _), grads = value_and_grad(params, cfg, batch)
    else:
        with patched(A, flash_attention=attention):
            (loss, _), grads = value_and_grad(params, cfg, batch)
    return float(loss), grads


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over all leaves of two gradient trees."""
    import torch

    from repro_torch._tree import leaves
    num = den = 0.0
    for x, y in zip(leaves(a), leaves(b), strict=True):
        num += float(torch.linalg.vector_norm(x - y)) ** 2
        den += float(torch.linalg.vector_norm(y)) ** 2
    return (num / den) ** 0.5


def train_gates(dev, cfg, batch) -> dict:
    """Gradient gates of one step at the train phase's width and depth, on
    their own weights.  In f32 compute the kernels' loss and gradient
    against every kernel replaced by its plain version (1e-5 relative,
    1e-4 relative L2), and a control that must fail: the kernel's LSE
    handed to the backward shifted by log 2.  In bf16 compute the
    gradient's relative L2 against the all-plain route (the fallback's
    rounding) within twice the spread between that route and one whose
    attention runs in f32 and is rounded at its output.  At most two
    gradient trees are alive at once."""
    import math

    import torch

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.models import init_params

    def shifted(q, k, v, causal=True, return_lse=False):
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        return (out, lse + math.log(2.0)) if return_lse else out

    params = init_params(TRAIN_SEED + 1, cfg, device=dev)
    cfg32 = cfg.replace(compute_dtype="float32")
    loss_p, g_p = grad_route(params, cfg32, batch, attention_ref)
    loss_k, g_k = grad_route(params, cfg32, batch)
    f32 = {"loss_plain": loss_p, "loss_kernels": loss_k,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2": rel_l2(g_k, g_p)}
    del g_k
    loss_c, g_c = grad_route(params, cfg32, batch, shifted)
    f32["control_lse_plus_log2_grad_rel_l2"] = rel_l2(g_c, g_p)
    f32["control_loss_rel_err"] = abs(loss_c - loss_p) / abs(loss_p)
    del g_c, g_p
    expect(f32["loss_rel_err"] <= 1e-5 and f32["grad_rel_l2"] <= 1e-4,
           f"f32 gate: the kernels' step differs from the all-plain one: "
           f"{f32}")
    expect(f32["control_lse_plus_log2_grad_rel_l2"] > 1e-4,
           f"f32 gate passes a control with its LSE shifted by log 2: "
           f"{f32}")
    free_device()
    _, g_b = grad_route(params, cfg, batch, plain_fallback_attention)
    _, g_f = grad_route(params, cfg, batch, attention_ref)
    bf16 = {"plain_spread_rel_l2": rel_l2(g_f, g_b)}
    del g_f
    _, g_k = grad_route(params, cfg, batch)
    bf16["grad_rel_l2"] = rel_l2(g_k, g_b)
    del g_k, g_b, params
    expect(bf16["grad_rel_l2"] <= 2 * bf16["plain_spread_rel_l2"],
           "bf16 gate: the kernels' gradient is further from the "
           f"all-plain one than twice the plain routes' spread: {bf16}")
    free_device()
    return {"float32_compute": f32, "bfloat16_compute": bf16}


def checked_quantize_ops(counts: dict) -> dict:
    """The compression's quantize ops as callables that launch each kernel
    and hold its result bit for bit against the plain version on the same
    input."""
    import torch

    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              dequantize_int8_ref,
                                              quantize_int8_cuda,
                                              quantize_int8_ref)

    def quantize(x):
        q, s = quantize_int8_cuda(x)
        qr, sr = quantize_int8_ref(x)
        expect(torch.equal(q, qr) and torch.equal(s, sr),
               f"quantize_int8 launch {counts['quantize']} of step 1 "
               f"{tuple(x.shape)} differs from plain")
        counts["quantize"] += 1
        return q, s

    def dequantize(q, s, dtype=torch.float32):
        out = dequantize_int8_cuda(q, s, dtype)
        expect(torch.equal(out, dequantize_int8_ref(q, s, dtype)),
               f"dequantize_int8 launch {counts['dequantize']} of step 1 "
               "differs from plain")
        counts["dequantize"] += 1
        return out
    return {"quantize": quantize, "dequantize": dequantize}


def check_train_step_one(dev, cfg, batch) -> dict:
    """Step 1 of the compressed Trainer, checked.  Every flash launch of one
    forward (out and LSE) against the plain version on the path's own q, k,
    v; then the Trainer's own step with every quantize and dequantize
    launch held bit for bit against its plain version, its gradients copied
    to the host as it takes them; then the params, moments and EF after
    the step against the same step with plain compression on those
    gradients (the embedding's backward accumulates with atomics, so the
    gradients are taken once), compared with ``torch.equal``."""
    import torch

    from repro_torch._tree import leaves, unflatten
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.quantize import (dequantize_int8_ref,
                                              quantize_int8_ref)
    from repro_torch.launch import train
    from repro_torch.launch.steps import moment_dtype_for, value_and_grad
    from repro_torch.models import attention as A
    from repro_torch.models import init_params
    from repro_torch.models.model import apply_train
    from repro_torch.optim import adamw
    from repro_torch.optim import compress as C

    tr = train.Trainer(cfg, lr=TRAIN_LR, compress="int8", seed=TRAIN_SEED,
                       device=dev)
    errs = {"out": [], "lse": []}

    def checked_attention(q, k, v, causal=True, return_lse=False):
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        want, want_lse = attention_ref(q, k, v, causal, return_lse=True)
        errs["out"].append(close(out, want, "flash_attention (train)"))
        errs["lse"].append(close(lse, want_lse,
                                 "flash_attention lse (train)",
                                 FA_TOL[str(q.dtype)]))
        return (out, lse) if return_lse else out

    with torch.no_grad(), patched(A, flash_attention=checked_attention):
        apply_train(tr.params, cfg, batch)
    expect(len(errs["out"]) == cfg.n_layers,
           f"one forward checked {len(errs['out'])} flash launches")

    host_grads: list = []

    def capturing(params, cfg_, batch_, *loss_scale):
        out, grads = value_and_grad(params, cfg_, batch_, *loss_scale)
        host_grads.extend(g.cpu() for g in leaves(grads))
        return out, grads

    counts = {"quantize": 0, "dequantize": 0}
    ef = tr.compressor.init(tr.params)
    with patched(train, value_and_grad=capturing), \
            patched(C, **checked_quantize_ops(counts)):
        params, opt, ef, m = tr.step_fn(tr.params, tr.opt, ef, batch)
    n_leaves = len(leaves(params))
    expect(counts == {"quantize": n_leaves, "dequantize": n_leaves},
           f"step 1 quantized {counts} for {n_leaves} tensors")
    metrics = {k: float(v) for k, v in m.items()}
    expect(all(np.isfinite(v) for v in metrics.values()),
           f"step 1 metrics {metrics}")
    kernel_state = {name: [t.cpu() for t in leaves(tree)] for name, tree in
                    (("params", params), ("m", opt.m), ("v", opt.v),
                     ("ef", ef))}
    del tr, params, opt, ef
    free_device()

    # the same step with plain compression on the same gradients, from the
    # same initial weights (drawn again from the Trainer's seed)
    params = init_params(TRAIN_SEED, cfg, device=dev)
    opt = adamw.init(params, moment_dtype_for(cfg))
    comp = C.GradCompressor("int8")
    ef = comp.init(params)
    grads = unflatten(params, (g.to(dev) for g in host_grads))
    del host_grads
    with patched(C, quantize=quantize_int8_ref,
                 dequantize=dequantize_int8_ref):
        sent, ef, _ = comp.compress(grads, ef)
    del grads
    params, opt, om = adamw.update(sent, opt, params, lr=TRAIN_LR)
    del sent
    expect(float(om["grad_norm"]) == metrics["grad_norm"],
           f"plain compression's grad_norm {float(om['grad_norm'])} != "
           f"{metrics['grad_norm']}")
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v),
                       ("ef", ef)):
        for i, (a, b) in enumerate(zip(leaves(tree), kernel_state[name],
                                       strict=True)):
            expect(torch.equal(a, b.to(dev)),
                   f"step 1 {name} leaf {i} differs from plain compression")
    del params, opt, ef, kernel_state
    free_device()
    return {"flash_launches_checked": len(errs["out"]),
            "flash_max_abs_err": max(errs["out"]),
            "flash_lse_max_abs_err": max(errs["lse"]),
            "quantize_launches_checked": counts["quantize"],
            "dequantize_launches_checked": counts["dequantize"],
            "state_equal_to_plain_compression": True,
            "step1_metrics": metrics}


def compress_ms(tr, reps: int = 2) -> float:
    """Device ms of one ``GradCompressor.compress`` over the model's
    gradients (CUDA events; random gradients of the params' shapes, the
    EF buffer carried), with the Trainer's params and moments alive."""
    import torch

    from repro_torch._tree import map_tree
    gen = torch.Generator(device=tr.device).manual_seed(19)
    grads = map_tree(lambda p: torch.randn(p.shape, generator=gen,
                                           device=p.device) * 1e-3,
                     tr.params)
    ef = tr.compressor.init(tr.params)
    ms = cuda_ms(lambda: tr.compressor.compress(grads, ef), reps)
    del grads, ef
    return ms


def restart_on_card(dev, cfg) -> dict:
    """A small crash/restart on the card: a narrow config of the train
    phase's family (head_dim 64), ``compress="none"`` (``make_train_step``
    with bf16 gradients), checkpoints in a temporary directory.  Steps 4-8
    after restoring step 3 are held against an uninterrupted run within
    RESTART_RTOL: the embedding's backward accumulates with atomics, so
    two runs on the card are not bit-identical."""
    import tempfile

    from repro_torch.launch import train
    small = cfg.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=512, vocab_size=4096,
                        attn_block=64, loss_chunk=64)
    quiet = dict(log=lambda *_: None)
    ref = train.Trainer(small, lr=1e-3, seed=3, device=dev).run(8, 2, 256,
                                                                **quiet)
    with tempfile.TemporaryDirectory() as d:
        tr = train.Trainer(small, d, lr=1e-3, seed=3, device=dev)
        try:
            tr.run(8, 2, 256, ckpt_every=3, crash_at=5, **quiet)
            raise AssertionError("chip_smoke: the injected crash did not "
                                 "happen")
        except RuntimeError as e:
            expect("injected failure at step 5" in str(e), str(e))
        tr2 = train.Trainer(small, d, lr=1e-3, seed=3, device=dev)
        expect(tr2.restore_if_any() and tr2.step == 3,
               f"restored step {tr2.step}")
        losses = tr2.run(8, 2, 256, ckpt_every=3, **quiet)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref[3:]))
    expect(len(losses) == 5 and rel <= RESTART_RTOL,
           f"losses after the restart {losses} differ from {ref[3:]} by "
           f"{rel} > {RESTART_RTOL}")
    return {"config": {"d_model": 256, "layers": 2, "head_dim": 64,
                       "vocab": 4096, "batch": 2, "seq": 256},
            "crash_at": 5, "restored": 3, "losses": losses,
            "uninterrupted": ref[3:], "max_rel_diff": rel,
            "rtol": RESTART_RTOL}


def train_path(dev, profile: bool = False):
    """The ``train`` phase: the compressed Trainer at qwen3-8b's full width
    cut to TRAIN_LAYERS layers, batch TRAIN_B x TRAIN_S, TRAIN_STEPS steps,
    after its gates and its checked first step (each emitted as its own
    record).  Returns the record and the main run's launches per kernel."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              quantize_int8_cuda)
    from repro_torch.launch import train

    full = get_config(TRAIN_ARCH)
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    reduced = {"n_layers": f"{full.n_layers} -> {TRAIN_LAYERS}"}
    batch = SyntheticLM(cfg, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                        device=dev).batch(0)
    t0 = time.perf_counter()
    emit({"phase": "train_gates", **train_gates(dev, cfg, batch),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "train_step1", **check_train_step_one(dev, cfg, batch),
          "seconds": time.perf_counter() - t0})
    del batch

    t0 = time.perf_counter()
    tr = train.Trainer(cfg, lr=TRAIN_LR, compress="int8", seed=TRAIN_SEED,
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(tr.params))
    kernels = {"quantize_int8": quantize_int8_cuda,
               "dequantize_int8": dequantize_int8_cuda,
               "flash_attention": flash_attention_cuda}
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0                       # this path's counts start here
    quantize_int8_cuda.shapes.clear()
    ends, lines = [], []

    def log(line: str) -> None:             # after each step's logging sync
        ends.append(time.perf_counter())
        lines.append(line)
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = tr.run(TRAIN_STEPS, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                    log_every=1, log=log)
    launches = {name: k.launches for name, k in kernels.items()}
    quant_shapes = dict(quantize_int8_cuda.shapes)
    peak = torch.cuda.max_memory_allocated()

    n_leaves = len(leaves(tr.params))
    per_step = {"quantize_int8": n_leaves, "dequantize_int8": n_leaves,
                "flash_attention": 2 * cfg.n_layers}
    for name, n in per_step.items():
        expect(launches[name] == n * TRAIN_STEPS,
               f"{name} launched {launches[name]}x in {TRAIN_STEPS} steps, "
               f"expected {n} a step")
    gnorms = [float(ln.split("gnorm ")[1].split()[0]) for ln in lines]
    expect(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and
           all(np.isfinite(gnorms)), f"losses {losses}, gnorms {gnorms}")
    step_s = [b - a for a, b in zip([start] + ends[:-1], ends)]
    median_s = float(np.median(step_s[1:]))
    counts = cfg.param_counts()
    matmul_params = counts["mixer"] + counts["channel"] + counts["head"]
    attn_flop = 3 * 4 * TRAIN_B * cfg.n_heads * cfg.hd * \
        TRAIN_S * (TRAIN_S + 1) / 2 * cfg.n_layers
    flop = 6 * matmul_params * TRAIN_B * TRAIN_S + attn_flop
    comp_ms = compress_ms(tr)
    record = {
        "phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
        "reduced": reduced, "d_model": cfg.d_model, "params": n_params,
        "param_tensors": n_leaves, "param_dtype": cfg.param_dtype,
        "compute_dtype": cfg.compute_dtype, "compress": "int8",
        "batch": TRAIN_B, "seq": TRAIN_S, "lr": TRAIN_LR,
        "steps": TRAIN_STEPS, "init_seconds": init_s,
        "losses": losses, "grad_norms": gnorms,
        "step_seconds": step_s, "median_step_s_2_to_5": median_s,
        "tokens_per_s": TRAIN_B * TRAIN_S / median_s,
        "model_flop_per_step": flop, "matmul_params": matmul_params,
        "attention_flop_per_step": attn_flop,
        "achieved_tflop_per_s": flop / median_s / 1e12,
        "mfu": flop / median_s / PEAK_FLOPS["torch.bfloat16"],
        "compress_ms_per_step": comp_ms,
        "compress_share_of_step": comp_ms / 1e3 / median_s,
        "max_memory_gb": peak / 1e9,
        "launches": launches, "launches_per_step": per_step,
    }
    if profile:
        record["profile"] = profile_run(
            lambda: tr.run(tr.step + 1, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                           log=lambda *_: None),
            "chip_smoke_profile_train.txt")
    del tr
    free_device()
    record["restart"] = restart_on_card(dev, get_config(TRAIN_ARCH))
    free_device()
    record.update(quantize_step(quant_shapes, median_s))
    free_device()
    return record, launches


def quantize_step(shapes: dict, step_s: float) -> dict:
    """The train step's quantize device time: its launches at each (R, D)
    (``quantize_int8_cuda.shapes`` over the run) times the raw-launch ms
    there, on a fresh f32 x of that shape, after the restart check (right
    after the run the warm card timed the largest rows slower), with the
    clocks, temperature and power then."""
    import torch
    expect(sum(shapes.values()) % TRAIN_STEPS == 0,
           f"quantize launches by shape {shapes} are not whole steps")
    gen = torch.Generator(device="cuda").manual_seed(20)
    ms = {}
    for (R, D), count in sorted(shapes.items()):
        x = torch.randn((R, D), generator=gen, device="cuda")
        ms[R, D] = cuda_ms(raw_quantize(x), 10 if R * D > 1 << 27 else 50)
        del x
    per_step = sum(ms[shape] * count / TRAIN_STEPS
                   for shape, count in shapes.items())
    return {"quantize_int8_ms_per_step": per_step,
            "quantize_int8_measured_at": nvidia_smi(
                "clocks.sm,clocks.mem,temperature.gpu,power.draw"),
            "quantize_int8_share_of_step": per_step / 1e3 / step_s,
            "quantize_int8_by_shape": [
                {"R": R, "D": D, "launches_per_step": count / TRAIN_STEPS,
                 "ms": ms[R, D]} for (R, D), count in sorted(shapes.items())]}


# ---------------------------------------------------- 7b. family train ----
def train_kernels() -> dict:
    """The wrappers of the kernels a train step can launch, by name."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              quantize_int8_cuda)
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda
    return {"flash_attention": flash_attention_cuda, "moe_gmm": moe_gmm_cuda,
            "mamba_ssm": mamba_ssm_cuda, "rwkv6_wkv": rwkv6_wkv_cuda,
            "quantize_int8": quantize_int8_cuda,
            "dequantize_int8": dequantize_int8_cuda}


def kinds_of(cfg) -> dict:
    """Layers of each mixer and channel kind."""
    out: dict = {}
    for pair in cfg.layer_kinds():
        for kind in pair:
            out[kind] = out.get(kind, 0) + 1
    return out


def launches_per_step(cfg, n_leaves: int, compress: str) -> dict:
    """Each train kernel's launches in one step: the layer's forward runs
    again in the backward under ``remat="full"``; a MoE layer launches the
    expert matmul three times, a Mamba or RWKV layer its scan once a
    segment (the JAX package's segment rule), an attention layer the flash
    kernel once; the int8 compression quantizes and dequantizes each
    parameter tensor once."""
    from repro_torch.kernels._segments import segment_length
    runs = 2 if cfg.remat == "full" else 1
    k = kinds_of(cfg)
    seg = {chunk: TRAIN_S // segment_length(TRAIN_S, chunk)
           for chunk in (cfg.mamba_chunk, cfg.rwkv_chunk)}
    quant = n_leaves if compress == "int8" else 0
    return {"flash_attention": runs * k.get("attn", 0),
            "moe_gmm": runs * 3 * k.get("moe", 0),
            "mamba_ssm": runs * seg[cfg.mamba_chunk] * k.get("mamba", 0),
            "rwkv6_wkv": runs * seg[cfg.rwkv_chunk] * k.get("rwkv", 0),
            "quantize_int8": quant, "dequantize_int8": quant}


@contextlib.contextmanager
def patched_all(patches: list):
    """:func:`patched` over a list of (module, {name: value})."""
    with contextlib.ExitStack() as stack:
        for module, attrs in patches:
            stack.enter_context(patched(module, **attrs))
        yield


def family_gates(dev, cfg, batch, spread: bool = False) -> dict:
    """Gradient gates of one step at cfg's width and depth, on their own
    weights, in f32 compute: the loss and whole gradient with the kernels
    against every kernel replaced by its plain version (1e-5 relative
    loss, 1e-4 relative L2), and controls that must fail that gate: the
    scans' backward recomputing every segment from a zero state (not from
    the state the segment started from), a loss without the MoE
    router's aux term, and the attention kernel's LSE handed to the
    backward shifted by log 2.  The all-plain route takes the experts the
    kernels' forward chose (routing flips between two summation orders on
    near-ties; ``routing_flips`` counts the (token, layer) pairs whose own
    top k would differ).  With ``spread``, where f32 rounding alone moves
    the gradient by more than 1e-4, the gradient is held instead within
    twice the spread between the plain route and one whose scans run in
    f64, with no controls.  At most two gradient trees are alive at
    once."""
    import math

    import torch

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import mamba_ssm_ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.moe_gmm import moe_gmm_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_ref
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import attention as A
    from repro_torch.models import init_params
    from repro_torch.models import moe as X

    kinds = kinds_of(cfg)
    router_topk = X.router_topk
    chosen: dict = {}               # router weight's address -> its top k
    flips: dict = {}                # the same -> tokens whose own differ

    def recording(p, x, cfg_):
        gates, idx, aux = router_topk(p, x, cfg_)
        chosen.setdefault(p["router"]["w"].data_ptr(), idx)
        return gates, idx, aux

    def pinned(p, x, cfg_):
        _, own, aux = router_topk(p, x, cfg_)
        key = p["router"]["w"].data_ptr()
        idx = chosen[key]
        flips[key] = int((own != idx).any(-1).sum())
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        gates = probs.gather(-1, idx)
        return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx, aux

    def no_aux(p, x, cfg_):
        gates, idx, aux = recording(p, x, cfg_)
        return gates, idx, aux * 0.0

    def shifted_lse(q, k, v, causal=True, return_lse=False):
        out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        return (out, lse + math.log(2.0)) if return_lse else out

    def as_kernel(scan):
        """``scan`` in a kernel wrapper's place: the wrapper's last
        argument, the final state's destination, is None on the train
        path."""
        return lambda *a: scan(*a[:-1])

    def in_f64(ref):
        """The plain scan in f64, its results in f32."""
        def scan(*a):
            y, st = ref(*(None if t is None else t.double() for t in a))
            return y.float(), st.float()
        return scan

    def from_zero(ref):
        """The plain scan from a zero state, the given one kept in the
        graph (times 0) so that its gradient is taken, and is zero."""
        def scan(*a):
            return ref(*a[:-1], None if a[-1] is None else a[-1] * 0.0)
        return scan

    kernels = [(X, {"router_topk": recording})] if "moe" in kinds else []
    rest = [(A, {"flash_attention": attention_ref}),
            (gmm_ops, {"moe_gmm_cuda": moe_gmm_ref})]
    if "moe" in kinds:
        rest.append((X, {"router_topk": pinned}))
    plain = rest + [(scan_ops, {"mamba_ssm_cuda": as_kernel(mamba_ssm_ref)}),
                    (wkv_ops, {"rwkv6_wkv_cuda": as_kernel(rwkv6_wkv_ref)})]
    f64 = rest + [
        (scan_ops, {"mamba_ssm_cuda": as_kernel(in_f64(mamba_ssm_ref)),
                    "mamba_ssm_ref": in_f64(mamba_ssm_ref)}),
        (wkv_ops, {"rwkv6_wkv_cuda": as_kernel(in_f64(rwkv6_wkv_ref)),
                   "rwkv6_wkv_ref": in_f64(rwkv6_wkv_ref)})]
    controls = {}
    if "mamba" in kinds:
        controls["scan_backward_from_zero_state"] = [
            (scan_ops, {"mamba_ssm_ref": from_zero(mamba_ssm_ref)})]
    if "rwkv" in kinds:
        controls["wkv_backward_from_zero_state"] = [
            (wkv_ops, {"rwkv6_wkv_ref": from_zero(rwkv6_wkv_ref)})]
    if "moe" in kinds:
        controls["loss_without_router_aux"] = [(X, {"router_topk": no_aux})]
    if "attn" in kinds:
        controls["attention_lse_plus_log2"] = [(A, {"flash_attention":
                                                    shifted_lse})]

    params = init_params(TRAIN_SEED + 1, cfg, device=dev)
    cfg32 = cfg.replace(compute_dtype="float32")

    def route(patches):
        with patched_all(patches):
            (loss, m), grads = value_and_grad(params, cfg32, batch)
        return float(loss), float(m["aux"]), grads

    loss_k, aux_k, g_k = route(kernels)
    loss_p, aux_p, g_p = route(plain)
    out = {"loss_plain": loss_p, "loss_kernels": loss_k,
           "aux_plain": aux_p, "aux_kernels": aux_k,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2": rel_l2(g_k, g_p), "routing_pinned": "moe" in kinds,
           "routing_flips": sum(flips.values())}
    del g_k
    if spread:
        _, _, g_f = route(f64)
        out["f64_scan_plain_grad_rel_l2"] = rel_l2(g_f, g_p)
        del g_f, g_p, params
        free_device()
        expect(out["loss_rel_err"] <= 1e-5 and out["grad_rel_l2"] <=
               2 * out["f64_scan_plain_grad_rel_l2"], "f32 gate: the "
               "kernels' step is further from the all-plain one than twice "
               f"the f64-scan spread: {out}")
        return out
    expect(out["loss_rel_err"] <= 1e-5 and out["grad_rel_l2"] <= 1e-4,
           f"f32 gate: the kernels' step differs from the all-plain one: "
           f"{out}")
    out["controls"] = {}
    for name, patches in controls.items():
        loss_c, _, g_c = route(kernels + patches)
        c = {"loss_rel_err": abs(loss_c - loss_p) / abs(loss_p),
             "grad_rel_l2": rel_l2(g_c, g_p)}
        del g_c
        out["controls"][name] = c
        expect(c["loss_rel_err"] > 1e-5 or c["grad_rel_l2"] > 1e-4,
               f"f32 gate passes a control ({name}): {c}")
    del g_p, params
    free_device()
    return out


def gmm_at(card: Card, shape, x_dtype, w_dtype, reps: int) -> dict:
    """The grouped matmul at (E, M, d, f) with random inputs: raw-launch
    ms, bound, its error against plain and ``torch.bmm`` on the weights in
    x's dtype (cast outside the timing); and the ms of what
    ``GroupedMatmul.backward`` runs there (dx and dw, two ``torch.bmm``,
    with the weights' cast and dw's cast back)."""
    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_ref
    E, M, d, f = shape
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((E, M, d), generator=gen, device="cuda").to(x_dtype)
    w = (torch.randn((E, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(w_dtype)
    err = close(moe_gmm_cuda(x, w), moe_gmm_ref(x, w), f"moe_gmm {shape}")
    bound, by, _, _ = gmm_bound(card, x, w)
    wx = w.to(x_dtype)
    dy = torch.randn((E, M, f), generator=gen, device="cuda").to(x_dtype)

    def backward():
        torch.bmm(dy, w.to(x_dtype).transpose(1, 2))
        torch.bmm(x.transpose(1, 2), dy).to(w_dtype)
    return {"shape": {"E": E, "M": M, "d": d, "f": f, "x": str(x_dtype),
                      "w": str(w_dtype)},
            "max_abs_err": err, "ms": cuda_ms(raw_gmm(x, w), reps),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.bmm(x, wx), reps),
            "library": "torch.bmm(x, w in x's dtype)",
            "backward_ms": cuda_ms(backward, reps)}


def scan_at(card: Card, B: int, S: int, di: int, reps: int) -> dict:
    """The selective scan at (B, S, di) from a carried state (a training
    segment), random inputs: raw-launch ms, bound, error against plain."""
    import torch

    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda, mamba_ssm_ref
    gen = torch.Generator(device="cuda").manual_seed(22)
    a = scan_inputs(gen, B, S, di, "cuda", h0=True)
    y, h = mamba_ssm_cuda(**a)
    want_y, want_h = mamba_ssm_ref(**a)
    err = max(close(y, want_y, "mamba_ssm y (train)", SCAN_TOL),
              close(h, want_h, "mamba_ssm h_final (train)", SCAN_TOL))
    bound, by, _, _ = scan_bound(card, B, S, di, True)
    return {"shape": {"B": B, "S": S, "di": di, "d_state": SCAN_DS,
                      "h0": True},
            "max_abs_err": err, "ms": cuda_ms(raw_scan(a), reps),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def wkv_at(card: Card, B: int, S: int, H: int, hd: int, reps: int) -> dict:
    """The WKV kernel at (B, S, H, hd) from a carried state (a training
    segment), random inputs: raw-launch ms, bound, error against plain."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda, rwkv6_wkv_ref
    gen = torch.Generator(device="cuda").manual_seed(23)
    a = wkv_inputs(gen, B, S, H, hd, "cuda", state=True)
    y, st = rwkv6_wkv_cuda(**a)
    want_y, want_st = rwkv6_wkv_ref(*(a[n] for n in ("r", "k", "v", "w", "u",
                                                     "state0")))
    err = wkv_close(y, st, want_y, want_st, "rwkv6_wkv (train)")
    bound, by, _, _ = wkv_bound(card, B, S, H, hd, True)
    return {"shape": {"B": B, "S": S, "H": H, "hd": hd, "state0": True},
            "max_abs_err": err, "ms": cuda_ms(raw_wkv(a), reps),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def flash_at(card: Card, cfg, B: int, S: int, reps: int,
             lse: bool = True) -> dict:
    """The flash kernel at (B, S) and cfg's heads in bf16, causal, with its
    LSE as a train step launches it or without as a prefill does (random
    inputs): raw-launch ms, bound, error, and on the same inputs the plain
    version's and SDPA's ms."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v = fa_inputs(np.random.default_rng(24), B, S, cfg.n_heads,
                        cfg.n_kv_heads, cfg.hd, "bfloat16", "cuda")
    out, got_lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    want, want_lse = attention_ref(q, k, v, True, return_lse=True)
    err = close(out, want, f"flash_attention at ({B}, {S})")
    close(got_lse, want_lse, f"flash_attention lse at ({B}, {S})",
          FA_TOL["torch.bfloat16"])
    del out, got_lse, want, want_lse
    bound, by, nbytes, flops = flash_bound(card, q, k, lse)
    return {"shape": {"B": B, "S": S, "H": cfg.n_heads, "Kv": cfg.n_kv_heads,
                      "hd": cfg.hd, "lse": lse},
            "max_abs_err": err, "ms": cuda_ms(raw_flash(q, k, v, lse=lse),
                                             reps),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, True), 3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops, "library_ms": sdpa_ms(q, k, v, reps)}


def kernel_ms_per_step(card: Card, cfg, shapes: dict, w_dtype) -> tuple:
    """Each scan, expert-matmul and attention kernel's device ms a step:
    its launches at each shape over the run (``.shapes``) divided by the
    steps, times the raw-launch ms at that shape (random inputs).  Returns
    those sums and, per kernel, the shape it ran most at with its
    ms, bound and library time there."""
    import torch
    cdt = getattr(torch, cfg.compute_dtype)
    per_step, at = {}, {}
    for name, by_shape in shapes.items():
        if not by_shape:
            continue
        total, rows = 0.0, []
        for key, n in sorted(by_shape.items(), key=lambda kv: -kv[1]):
            if name == "moe_gmm":
                t = gmm_at(card, key, cdt, w_dtype, 10)
            elif name == "mamba_ssm":
                t = scan_at(card, *key, cfg.mamba_expand * cfg.d_model, 20)
            elif name == "rwkv6_wkv":
                t = wkv_at(card, *key, cfg.rwkv_heads, cfg.rwkv_head_size,
                           20)
            else:
                t = flash_at(card, cfg, *key, 10)
            rows.append({**t, "launches_per_step": n / TRAIN_STEPS})
            total += t["ms"] * n / TRAIN_STEPS
            free_device()
        per_step[name] = total
        at[name] = rows[0]
    return per_step, at


def scan_backward_ms(dev, cfg, profiled_segments: int = 4) -> dict:
    """One layer's scan at the train shape under autograd (random inputs,
    f32 as the model hands them over): the wall ms of its backward, the
    plain per-segment recompute, with CUDA events; and the device ms of
    that backward's kernels from ``torch.profiler`` over the first
    ``profiled_segments`` segments' steps, scaled to the layer (every
    segment runs the same kernels; a whole layer's ~180,000 events take
    the profiler minutes to gather)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba_scan import segmented_scan
    from repro_torch.kernels.rwkv6_scan import segmented_wkv
    gen = torch.Generator(device=dev).manual_seed(25)
    if cfg.family == "ssm":
        a = wkv_inputs(gen, TRAIN_B, TRAIN_S, cfg.rwkv_heads,
                       cfg.rwkv_head_size, dev, state=False)
        args = [a[n].requires_grad_() for n in ("r", "k", "v", "w", "u")]
        chunk = cfg.rwkv_chunk

        def scan(*a):
            return segmented_wkv(*a, None, chunk)[0]
    else:
        di = cfg.mamba_expand * cfg.d_model
        a = scan_inputs(gen, TRAIN_B, TRAIN_S, di, dev, h0=False)
        args = [a[n].requires_grad_()
                for n in ("x", "dt", "Bmat", "Cmat", "A", "D")]
        chunk = cfg.mamba_chunk

        def scan(*a):
            return segmented_scan(*a, None, chunk)[0]
    dy = torch.randn((TRAIN_B, TRAIN_S) + tuple(args[0].shape[2:]),
                     generator=gen, device=dev)

    def forward():
        return scan(*args)
    torch.autograd.grad(forward(), args, dy)           # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    y = forward()
    torch.cuda.synchronize()
    start.record()
    torch.autograd.grad(y, args, dy)
    stop.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(stop)
    steps = profiled_segments * chunk
    short = [a[:, :steps].detach().requires_grad_() if a.dim() > 2 else a
             for a in args]
    y = scan(*short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y, short, dy[:, :steps])
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    scale = TRAIN_S / steps
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3 * scale
    return {"per_layer_wall_ms": wall, "per_layer_device_ms": busy,
            "per_layer_device_events": len(dev_ev) * scale,
            "profiled_steps": steps, "device_busy_share": busy / wall}


def mrope_grid(B: int, S: int) -> np.ndarray:
    """(3, B, S) int32 M-RoPE positions of MROPE_GRID's image then text in
    every row: the grid's gh x gw positions (t 0, h the row, w the column),
    then the text from max(gh, gw) on all three."""
    gh, gw = MROPE_GRID
    n = gh * gw
    pos = np.zeros((3, B, S), np.int32)
    pos[1, :, :n] = np.arange(n) // gw
    pos[2, :, :n] = np.arange(n) % gw
    pos[:, :, n:] = max(gh, gw) + np.arange(S - n)
    return pos


def synthetic_lm(cfg):
    """The train phases' data source: ``data.SyntheticLM``, whose batches
    for an M-RoPE config also carry :func:`mrope_grid` positions."""
    from repro_torch.data import SyntheticLM
    if not cfg.mrope_sections:
        return SyntheticLM

    class GridLM(SyntheticLM):
        def host_batch(self, step: int) -> dict:
            return {**super().host_batch(step),
                    "positions": mrope_grid(self.B, self.S)}
    return GridLM


def round_trip_quantize(n_checked: int, seen: dict):
    """``optim.compress``'s quantize for a train run: each of its first
    ``n_checked`` launches (step 1's, one a parameter tensor) held bit for
    bit against the plain version on the same input, and the plain
    dequantize of its q and scale within the reference's bound of that
    input (ROUND_TRIP_PHASES); later launches pass through.  The checks
    launch nothing; ``seen`` collects the launches checked, the largest
    error over its bound and the largest row."""
    import torch

    from repro_torch.kernels.quantize import (dequantize_int8_ref,
                                              quantize_int8_ref)
    from repro_torch.optim import compress as C
    kernel = C.quantize
    seen.update(checked=0, max_err_over_bound=0.0, largest_row=0)

    def quantize(x):
        q, s = kernel(x)
        if seen["checked"] < n_checked:
            qr, sr = quantize_int8_ref(x)
            expect(torch.equal(q, qr) and torch.equal(s, sr),
                   f"quantize_int8 launch {seen['checked']} of step 1 "
                   f"{tuple(x.shape)} differs from plain")
            del qr, sr
            err = (dequantize_int8_ref(q, s) - x).abs_()
            bound = x.abs().amax(-1, keepdim=True) / 254.0 * 1.05 + 1e-5
            ratio = float(err.div_(bound).max())
            expect(ratio <= 1.0, f"int8 round trip of launch "
                   f"{seen['checked']} {tuple(x.shape)} at {ratio} of the "
                   "reference's bound")
            seen.update(checked=seen["checked"] + 1,
                        max_err_over_bound=max(seen["max_err_over_bound"],
                                               ratio),
                        largest_row=max(seen["largest_row"], x.shape[-1]))
        return q, s
    return quantize


def family_train_path(dev, card: Card, phase: str, profile: bool = False):
    """A family train phase (``TRAIN_FAMILIES``): its gates (emitted as
    their own record), then the Trainer at full width with the layer cut,
    batch TRAIN_B x TRAIN_S, TRAIN_STEPS steps, every kernel's launches
    counted from 0 just before the run and held to their exact count a
    step; each kernel's device ms a step; for int8 the compression's ms;
    for the scans the plain backward's ms.  Returns the record, the run's
    launches per kernel and each kernel's per-launch line at its most
    frequent shape."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.optim import compress as C

    arch, n_layers, compress, gate_layers = TRAIN_FAMILIES[phase]
    full = get_config(arch)
    cfg, reduced = full, {}
    if n_layers is not None:
        reduced["n_layers"] = f"{full.n_layers} -> {n_layers}"
        cfg = cfg.replace(n_layers=n_layers)
    if cfg.grad_accum != 1:
        reduced["grad_accum"] = f"{cfg.grad_accum} -> 1"
        cfg = cfg.replace(grad_accum=1)
    data = synthetic_lm(cfg)
    batch = data(cfg, TRAIN_B, TRAIN_S, seed=TRAIN_SEED, device=dev).batch(0)
    t0 = time.perf_counter()
    gates = {"layers": cfg.n_layers}
    if gate_layers is not None:
        gates = {"layers": gate_layers, "at_phase_depth": {
            "layers": cfg.n_layers,
            **family_gates(dev, cfg, batch, spread=True)}}
    gates.update(family_gates(dev, cfg.replace(n_layers=gates["layers"]),
                              batch))
    emit({"phase": f"{phase}_gates", "arch": cfg.name, **gates,
          "seconds": time.perf_counter() - t0})
    del batch

    t0 = time.perf_counter()
    tr = train.Trainer(cfg, lr=TRAIN_LR, compress=compress, seed=TRAIN_SEED,
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(tr.params))
    n_leaves = len(leaves(tr.params))
    kernels = train_kernels()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0                       # this path's counts start here
        if hasattr(k, "shapes"):
            k.shapes.clear()
    ends, lines = [], []

    def log(line: str) -> None:             # after each step's logging sync
        ends.append(time.perf_counter())
        lines.append(line)
    round_trip: dict = {}
    checks = [(train, {"SyntheticLM": data})]
    if phase in ROUND_TRIP_PHASES:
        checks.append((C, {"quantize": round_trip_quantize(n_leaves,
                                                           round_trip)}))
    torch.cuda.synchronize()
    start = time.perf_counter()
    with patched_all(checks):
        losses = tr.run(TRAIN_STEPS, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                        log_every=1, log=log)
    launches = {name: k.launches for name, k in kernels.items()}
    shapes = {name: dict(kernels[name].shapes) for name in
              ("moe_gmm", "mamba_ssm", "rwkv6_wkv", "flash_attention")}
    quant_shapes = dict(kernels["quantize_int8"].shapes)
    peak = torch.cuda.max_memory_allocated()

    per_step = launches_per_step(cfg, n_leaves, compress)
    for name, n in per_step.items():
        expect(launches[name] == n * TRAIN_STEPS,
               f"{phase}: {name} launched {launches[name]}x in "
               f"{TRAIN_STEPS} steps, expected {n} a step")
    gnorms = [float(ln.split("gnorm ")[1].split()[0]) for ln in lines]
    expect(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and
           all(np.isfinite(gnorms)), f"{phase}: losses {losses}, gnorms "
           f"{gnorms}")
    step_s = [b - a for a, b in zip([start] + ends[:-1], ends)]
    median_s = float(np.median(step_s[1:]))
    counts = cfg.param_counts()
    k = kinds_of(cfg)
    idle_experts = k.get("moe", 0) * (cfg.n_experts - cfg.moe_top_k) * \
        3 * cfg.d_model * cfg.d_ff
    matmul_params = counts["mixer"] + counts["channel"] + counts["head"] - \
        idle_experts
    attn_flop = 3 * 4 * TRAIN_B * cfg.n_heads * cfg.hd * \
        TRAIN_S * (TRAIN_S + 1) / 2 * k.get("attn", 0)
    flop = 6 * matmul_params * TRAIN_B * TRAIN_S + attn_flop
    record = {
        "phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
        "layer_kinds": k, "reduced": reduced, "d_model": cfg.d_model,
        "params": n_params, "param_tensors": n_leaves,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "remat": cfg.remat, "compress": compress, "batch": TRAIN_B,
        "seq": TRAIN_S, "lr": TRAIN_LR, "steps": TRAIN_STEPS,
        "init_seconds": init_s, "losses": losses, "grad_norms": gnorms,
        "step_seconds": step_s, "median_step_s_2_to_5": median_s,
        "tokens_per_s": TRAIN_B * TRAIN_S / median_s,
        "model_flop_per_step": flop, "active_matmul_params": matmul_params,
        "attention_flop_per_step": attn_flop,
        "achieved_tflop_per_s": flop / median_s / 1e12,
        "mfu": flop / median_s / PEAK_FLOPS["torch.bfloat16"],
        "max_memory_gb": peak / 1e9,
        "launches": launches, "launches_per_step": per_step}
    if cfg.frontend != "tokens":
        record["frontend"] = cfg.frontend
    if cfg.mrope_sections:
        record["mrope_grid"] = list(MROPE_GRID)
    if round_trip:
        expect(round_trip["checked"] == n_leaves, f"{phase}: step 1 checked "
               f"{round_trip['checked']} quantize launches of {n_leaves}")
        record["step1_quantize_round_trip"] = round_trip
    if compress != "none":
        comp_ms = compress_ms(tr)
        record["compress_ms_per_step"] = comp_ms
        record["compress_share_of_step"] = comp_ms / 1e3 / median_s
    k_scan = k.get("mamba", 0) + k.get("rwkv", 0)
    if profile and not k_scan:
        # a scan phase's step is ~180,000 device events a layer, which the
        # profiler takes minutes to gather: its breakdown is the scan
        # backward's below (one layer, profiled over 256 steps)
        with patched(train, SyntheticLM=data):
            record["profile"] = profile_run(
                lambda: tr.run(tr.step + 1, TRAIN_B, TRAIN_S,
                               seed=TRAIN_SEED, log=lambda *_: None),
                f"chip_smoke_profile_{phase}.txt")
    w_dtype = torch.float32 if compress != "none" else \
        getattr(torch, cfg.compute_dtype)
    del tr
    free_device()
    kernel_ms, at = kernel_ms_per_step(card, cfg, shapes, w_dtype)
    record["kernel_ms_per_step"] = kernel_ms
    record["kernel_share_of_step"] = {n: ms / 1e3 / median_s
                                      for n, ms in kernel_ms.items()}
    if quant_shapes:
        record.update(quantize_step(quant_shapes, median_s))
    if k_scan:
        bwd = scan_backward_ms(dev, cfg)
        bwd["per_step_wall_ms"] = bwd["per_layer_wall_ms"] * k_scan
        bwd["share_of_step"] = bwd["per_step_wall_ms"] / 1e3 / median_s
        record["scan_backward"] = bwd
    free_device()
    return record, launches, at


# ------------------------------------ 7b'. the embeddings frontend -----
def embeds_decode(params, cfg, embeds, steps: list, positions) -> list:
    """``apply_prefill`` of the prompt embeddings (with ``positions`` where
    given) into a cache of S + len(steps) positions, then one
    ``apply_decode`` per (B, 1, d) of ``steps``: each call's logits."""
    from repro_torch.models import model as MD
    batch = {"embeds": embeds}
    if positions is not None:
        batch["positions"] = positions
    S = embeds.shape[1]
    logits, cache = MD.apply_prefill(params, cfg, batch,
                                     max_len=S + len(steps))
    out = [logits]
    for i, x in enumerate(steps):
        logits, cache = MD.apply_decode(params, cfg, cache, {"embeds": x},
                                        S + i)
        out.append(logits)
    return out


def prefill_embeds_path(dev) -> tuple[dict, dict]:
    """The ``prefill_embeds`` phase: each config of PREFILL_EMBEDS whole,
    random f32 weights, bf16 compute, PE_B x PE_S prompt embeddings (and
    for an M-RoPE config :func:`mrope_grid` positions) through
    ``models.model.apply_prefill``, then PE_STEPS ``apply_decode`` steps;
    exactly one flash launch a layer in the prefill and none in decode;
    every call's logits within TP_LOGITS_TOL of their scale against the
    same calls with the attention kernel's plain version; the kernel
    against its plain version on the first inputs the prefill gave it.
    Returns the record and the launches."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    runs, total = [], 0
    for arch in PREFILL_EMBEDS:
        cfg = get_config(arch)
        params = init_params(PE_SEED, cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(PE_SEED)
        embeds = torch.randn((PE_B, PE_S, cfg.d_model), generator=gen,
                             device=dev)
        steps = [torch.randn((PE_B, 1, cfg.d_model), generator=gen,
                             device=dev) for _ in range(PE_STEPS)]
        positions = (torch.from_numpy(mrope_grid(PE_B, PE_S)).to(dev)
                     if cfg.mrope_sections else None)
        seen: dict = {}
        calls: list = []
        flash_attention_cuda.launches = 0    # this run's count starts here
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad(), patched_all(capturing(split_kernels(), seen,
                                                    calls)):
            got = embeds_decode(params, cfg, embeds, steps, positions)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = flash_attention_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        expect(launches == cfg.n_layers and calls == [True] * cfg.n_layers,
               f"prefill_embeds {arch}: {launches} flash launches "
               f"(causal {calls}), expected one a layer, {cfg.n_layers}, "
               "in the prefill and none in decode")
        with torch.no_grad(), patched(fa_ops,
                                      flash_attention_cuda=attention_ref):
            want = embeds_decode(params, cfg, embeds, steps, positions)
        expect(flash_attention_cuda.launches == launches,
               f"prefill_embeds {arch}: the plain route launched the kernel")
        errs = []
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            expect(g.shape == (PE_B, cfg.vocab_size) and
                   bool(torch.isfinite(g).all()),
                   f"prefill_embeds {arch} call {i}: logits {tuple(g.shape)}")
            err, scale = scaled_err(g, w)
            errs.append(err / scale)
            expect(err <= TP_LOGITS_TOL * scale,
                   f"prefill_embeds {arch} call {i} (0 = prefill): logits "
                   f"differ from the plain route by {err} of scale {scale}")
        runs.append({
            "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
            "frontend": cfg.frontend,
            "mrope_grid": list(MROPE_GRID) if cfg.mrope_sections else None,
            "params": sum(x.numel() for x in leaves(params)),
            "batch": PE_B, "prompt": PE_S, "decode_steps": PE_STEPS,
            "compute_dtype": cfg.compute_dtype,
            "flash_launches_per_prefill": launches,
            "logits_rel_err_per_call": errs,
            "max_logits_rel_err": max(errs), "tol": TP_LOGITS_TOL,
            "seconds_prefill_and_decode": seconds,
            "max_memory_gb": peak / 1e9,
            "kernels_vs_plain": kernels_vs_plain(
                split_kernels(), seen, f"prefill_embeds {arch}")})
        total += launches
        del params, embeds, steps, got, want, seen
        free_device()
    return ({"phase": "prefill_embeds", "runs": runs,
             "seconds": time.perf_counter() - t0},
            {"flash_attention": total})


# ------------------------------------------------------- 7c. the mesh -----
def init_nccl_group(tmp: str):
    """A NCCL process group of one rank on cuda:0, its store a file in
    ``tmp``; raises where NCCL cannot start (no fallback)."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(tmp) / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    expect(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")


def mesh_run(dev, cfg, mesh, kernels: dict, compress: str = "int8"
             ) -> tuple[dict, object]:
    """TRAIN_STEPS steps of the Trainer (on ``mesh``, or one card
    without): losses, gradient norms (each step's metric, read once at the
    end), step seconds, peak memory and each kernel's launches, counted
    from 0 just before the run.  Returns the record and the Trainer."""
    import torch

    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    tr = train.Trainer(cfg, mesh=mesh, lr=TRAIN_LR, compress=compress,
                       seed=TRAIN_SEED, device=None if mesh else dev)
    norms, ends = [], []
    inner = tr.step_fn

    def step(*args):
        out = inner(*args)
        norms.append(out[3]["grad_norm"])
        return out
    tr.step_fn = step
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    losses = tr.run(TRAIN_STEPS, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
                    log_every=1, log=lambda _: ends.append(
                        time.perf_counter()))
    launches = {name: k.launches for name, k in kernels.items()}
    step_s = [b - a for a, b in zip([start] + ends[:-1], ends)]
    median_s = float(np.median(step_s[1:]))
    return {"losses": losses,
            "grad_norms": torch.stack(norms).cpu().tolist(),
            "step_seconds": step_s, "median_step_s_2_to_5": median_s,
            "tokens_per_s": TRAIN_B * TRAIN_S / median_s,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}, tr


def nccl_kernels_per_step(tr) -> dict:
    """The NCCL kernels of one more step, by name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(tr.step + 1, TRAIN_B, TRAIN_S, seed=TRAIN_SEED,
               log=lambda *_: None)
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower():
            out[e.name] = out.get(e.name, 0) + 1
    return out


def mesh_train_path(dev, tmp: str):
    """The ``mesh_train`` phase: ``Trainer(cfg, mesh=parse_mesh("1x1"),
    compress="int8")`` over a NCCL group of one rank against the same run
    without a mesh.  Returns the record and the meshed run's launches."""
    import torch

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.parallel.sharding import is_dtensor

    init_nccl_group(tmp)
    mesh = train.parse_mesh("1x1")
    full = get_config(TRAIN_ARCH)
    cfg = full.replace(n_layers=MESH_LAYERS)
    kernels = {k: v for k, v in train_kernels().items()
               if k in ("flash_attention", "quantize_int8",
                        "dequantize_int8")}
    t0 = time.perf_counter()
    meshed, tr = mesh_run(dev, cfg, mesh, kernels)
    expect(all(is_dtensor(x) for x in leaves(tr.params)) and
           all(is_dtensor(x) for x in leaves(tr.opt.m)),
           "the meshed Trainer's params and moments are not DTensors")
    n_leaves = len(leaves(tr.params))
    nccl = nccl_kernels_per_step(tr)
    meshed["seconds"] = time.perf_counter() - t0
    del tr
    free_device()
    t0 = time.perf_counter()
    plain, tr = mesh_run(dev, cfg, None, kernels)
    plain["seconds"] = time.perf_counter() - t0
    del tr
    free_device()
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "quantize_int8": n_leaves, "dequantize_int8": n_leaves}
    for run in (meshed, plain):
        for name, n in per_step.items():
            expect(run["launches"][name] == n * TRAIN_STEPS,
                   f"{name} launched {run['launches'][name]}x in "
                   f"{TRAIN_STEPS} steps, expected {n} a step")
    diff = {}
    for key in ("losses", "grad_norms"):
        a, b = np.array(meshed[key]), np.array(plain[key])
        expect(np.isfinite(a).all() and np.isfinite(b).all(),
               f"{key}: {a} / {b}")
        diff[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        expect(diff[key] <= MESH_RTOL, f"mesh_train {key} differ by "
               f"{diff[key]:.3g} relative: {a} against {b}")
    return {"phase": "mesh_train", "arch": cfg.name, "layers": cfg.n_layers,
            "reduced": {"n_layers": f"{full.n_layers} -> {MESH_LAYERS}"},
            "mesh": "1x1", "backend": "nccl", "compress": "int8",
            "batch": TRAIN_B, "seq": TRAIN_S, "lr": TRAIN_LR,
            "steps": TRAIN_STEPS, "param_tensors": n_leaves,
            "meshed": meshed, "one_card": plain,
            "max_rel_diff": diff,
            "bit_equal": meshed["losses"] == plain["losses"] and
            meshed["grad_norms"] == plain["grad_norms"],
            "launches_per_step": per_step,
            "nccl_kernels_per_step": nccl}, meshed["launches"]


def compressed_psum_path(dev) -> tuple[dict, dict]:
    """The ``compressed_psum`` phase: ``compressed_psum_int8`` on the
    one-rank group at an MLP weight's shape through the quantize kernels,
    bit-equal to the plain route; destroys the process group after."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.quantize import (dequantize_int8_cuda,
                                              dequantize_int8_ref,
                                              quantize_int8_cuda,
                                              quantize_int8_ref)
    from repro_torch.optim.compress import compressed_psum_int8

    gen = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(PSUM_SHAPE, generator=gen, device=dev)
    kernels = {"quantize_int8": quantize_int8_cuda,
               "dequantize_int8": dequantize_int8_cuda}
    for k in kernels.values():
        k.launches = 0
    got = compressed_psum_int8(x)
    launches = {name: k.launches for name, k in kernels.items()}
    q, scale = quantize_int8_ref(x)
    want = dequantize_int8_ref(q, scale)
    expect(launches == {"quantize_int8": 1, "dequantize_int8": 1},
           f"compressed_psum launches {launches}")
    expect(same_values(got, want), "compressed_psum_int8 differs from the "
           "plain route")
    ms = cuda_ms(lambda: compressed_psum_int8(x), 20)
    dist.destroy_process_group()
    return {"phase": "compressed_psum", "shape": list(PSUM_SHAPE),
            "group_size": 1, "bit_equal": True, "launches": launches,
            "ms": ms,
            "max_abs": float(got.abs().max())}, launches


# ------------------------------------------------ 7d. tensor parallelism --
def tp_spawn(job: str, tmp: str) -> list:
    """``job`` ("train" | "prefill") on TP_MESH's ranks, one process each
    (this script with ``--tp-worker``), its rendezvous a file in ``tmp``;
    each to exit 0.  Returns the ranks' records."""
    n = int(np.prod(TP_MESH))
    rdv = str(Path(tmp) / f"tp_{job}_rdv")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-worker", job,
         str(r), rdv, tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        expect(p.returncode == 0, f"tp_{job} rank {r} exit {p.returncode}: "
               f"{logs[r][-3000:]}")
    return [json.loads((Path(tmp) / f"tp_{job}_rank{r}.json").read_text())
            for r in range(n)]


def tp_worker(job: str, rank: int, rdv: str, tmp: str) -> int:
    """One rank of a TP phase: a gloo group over TP_MESH's ranks (its
    store the file ``rdv``), the mesh on cuda:0, the job; writes the
    rank's record into ``tmp``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + rdv, rank=rank,
        world_size=int(np.prod(TP_MESH)),
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    mesh = make_mesh(TP_MESH, device="cuda")
    rec = {"train": tp_train_rank, "prefill": tp_prefill_rank,
           "decode": tp_decode_rank, "sp": sp_prefill_rank}[job](mesh, rank,
                                                                 tmp)
    rec.update(rank=rank, backend=dist.get_backend(),
               mesh="x".join(map(str, TP_MESH)), host_staged_collectives=[])
    (Path(tmp) / f"tp_{job}_rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def tp_train_cfg():
    from repro_torch.configs import get_config
    arch, layers = TP_TRAIN
    full = get_config(arch)
    return full, full.replace(n_layers=layers, grad_accum=1)


def tp_train_rank(mesh, rank: int, tmp: str) -> dict:
    """The sharded Trainer's run on this rank (``mesh_run``), then the
    flash kernel against its plain version on the first inputs the run
    gave it (the rank's local heads)."""
    import torch

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.models import attention as A
    _, cfg = tp_train_cfg()
    seen: dict = {}
    fa = A.flash_attention

    def capture(q, k, v, causal=True, return_lse=False):
        seen.setdefault("qkv", tuple(t.detach().clone() for t in (q, k, v)))
        return fa(q, k, v, causal, return_lse)
    with patched(A, flash_attention=capture):
        run, tr = mesh_run(torch.device("cuda", 0), cfg, mesh,
                           {"flash_attention": flash_attention_cuda},
                           compress="none")
    del tr
    free_device()
    q, k, v = seen["qkv"]
    got, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    want, want_lse = attention_ref(q, k, v, True, return_lse=True)
    run["flash_vs_plain"] = {
        "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
        "max_abs_err": close(got, want, "tp_train flash_attention"),
        "lse_max_abs_err": close(lse, want_lse, "tp_train flash lse",
                                 FA_TOL[str(q.dtype)])}
    return run


def tp_train_path(dev, tmp: str) -> tuple[dict, dict]:
    """The ``tp_train`` phase: the config's one-process run, then its two
    ranks; returns the record and the ranks' launches (summed)."""
    from repro_torch._tree import leaves
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    full, cfg = tp_train_cfg()
    t0 = time.perf_counter()
    one, tr = mesh_run(dev, cfg, None,
                       {"flash_attention": flash_attention_cuda},
                       compress="none")
    n_params = sum(x.numel() for x in leaves(tr.params))
    del tr
    free_device()
    one["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = tp_spawn("train", tmp)
    wall = time.perf_counter() - t0
    per_step = 2 * kinds_of(cfg).get("attn", 0)     # forward and recompute
    for who, run in [("one card", one)] + [(f"rank {r['rank']}", r)
                                           for r in ranks]:
        expect(run["launches"]["flash_attention"] == per_step * TRAIN_STEPS,
               f"tp_train {who}: flash_attention launched "
               f"{run['launches']['flash_attention']}x, expected {per_step}"
               " a step")
    diff = {}
    for key, tol in (("losses", TP_LOSS_RTOL), ("grad_norms", TP_GNORM_RTOL)):
        a, b = np.array(ranks[0][key]), np.array(one[key])
        expect(np.isfinite(a).all() and np.isfinite(b).all(),
               f"tp_train {key}: {a} / {b}")
        expect(all(r[key] == ranks[0][key] for r in ranks),
               f"tp_train: the ranks' {key} differ")
        diff[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        expect(diff[key] <= tol, f"tp_train {key} differ by {diff[key]:.3g}"
               f" relative (tolerance {tol}): {a} against {b}")
    H, Kv = cfg.n_heads, cfg.n_kv_heads
    n = TP_MESH[-1]
    return {"phase": "tp_train", "arch": cfg.name, "layers": cfg.n_layers,
            "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}",
                        "grad_accum": f"{full.grad_accum} -> 1"},
            "params": n_params, "mesh": "x".join(map(str, TP_MESH)),
            "backend": ranks[0]["backend"],
            "host_staged_collectives": ranks[0]["host_staged_collectives"],
            "compress": "none", "batch": TRAIN_B, "seq": TRAIN_S,
            "lr": TRAIN_LR, "steps": TRAIN_STEPS,
            "local_heads": {"q": H // n, "kv": Kv // n, "G": H // Kv},
            "tolerance": {"losses": TP_LOSS_RTOL,
                          "grad_norms": TP_GNORM_RTOL},
            "max_rel_diff": diff, "one_card": one, "ranks": ranks,
            "ranks_wall_s": wall}, {
        "flash_attention": sum(r["launches"]["flash_attention"]
                               for r in ranks)}


def tp_prefill_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config
    full = get_config(arch)
    return full, full.replace(n_layers=layers, param_dtype="bfloat16")


def tp_prompts(cfg, dev):
    import torch
    rng = np.random.default_rng(TP_SEED)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TP_PREFILL_B, TP_PREFILL_S),
        dtype=np.int32)).to(dev)


def tp_routing(record: list, pinned: list | None = None,
               flips: list | None = None, positions: tuple | None = None):
    """``models.moe.router_topk`` in call order: each call's experts
    appended to ``record``; or, with ``pinned``, call i routed to
    ``pinned[i]`` (its ``positions`` (lo, hi) of the sequence, for a rank
    holding that block) with its own probabilities of them as gates
    (normalised as ``router_topk`` does), and in ``flips`` the tokens whose
    own top k differ."""
    import torch

    from repro_torch.models import moe as X
    router_topk = X.router_topk

    def route(p, x, cfg_):
        gates, idx, aux = router_topk(p, x, cfg_)
        i = len(record)
        record.append(idx)
        if pinned is None:
            return gates, idx, aux
        want = pinned[i].to(idx.device)
        if positions is not None:
            want = want[:, positions[0]:positions[1]]
        flips.append(int((want != idx).any(-1).sum()))
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        g = probs.gather(-1, want)
        return g / g.sum(-1, keepdim=True).clamp(min=1e-9), want, aux
    return route


def tp_prefill_kernels() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    return {"flash_attention": flash_attention_cuda,
            "moe_gmm": moe_gmm_cuda, "mamba_ssm": mamba_ssm_cuda}


def tp_prefill_rank(mesh, rank: int, tmp: str) -> dict:
    """Per config of TP_PREFILL: the rule table's prefill placement (one
    rank at a time draws the whole model), the prefill with the routing
    pinned to the one-process run's experts (logits gated), then the
    prefill step routing on its own; each kernel's launches of both, and
    (rank 0) each kernel against its plain version on the first inputs
    the pinned prefill gave it."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import mamba_ssm_ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.moe_gmm import moe_gmm_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    from repro_torch.parallel import ctx as pctx
    dev = torch.device("cuda", 0)
    kernels = tp_prefill_kernels()
    out: dict = {"configs": []}
    for arch, layers in TP_PREFILL:
        _, cfg = tp_prefill_cfg(arch, layers)
        ref = torch.load(Path(tmp) / f"tp_prefill_{arch}.pt")
        for r in range(int(np.prod(TP_MESH))):
            if r == rank:
                params = steps.shard_params(
                    init_params(TP_SEED, cfg, device=dev), cfg, mesh)
                free_device()
            dist.barrier()
        tokens = tp_prompts(cfg, dev)
        seen: dict = {}

        def capture(name, fn):
            def call(*args):
                seen.setdefault(name, tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
                return fn(*args)
            return call
        for k in kernels.values():
            k.launches = 0
            k.shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record: list = []
        flips: list = []
        with patched(X, router_topk=tp_routing(record, ref["experts"],
                                               flips)), \
                patched(fa_ops, flash_attention_cuda=capture(
                    "flash_attention", kernels["flash_attention"])), \
                patched(gmm_ops, moe_gmm_cuda=capture(
                    "moe_gmm", kernels["moe_gmm"])), \
                patched(scan_ops, mamba_ssm_cuda=capture(
                    "mamba_ssm", kernels["mamba_ssm"])), \
                torch.inference_mode(), pctx.policy(mesh):
            logits, _ = MD.apply_prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        pinned_s = time.perf_counter() - t0
        pinned = {k: v.launches for k, v in kernels.items()}
        for k in kernels.values():
            k.launches = 0
        own: list = []
        t0 = time.perf_counter()
        with patched(X, router_topk=tp_routing(own)):
            nxt, _ = steps.make_prefill_step(cfg, mesh)(params,
                                                        {"tokens": tokens})
        torch.cuda.synchronize()
        own_s = time.perf_counter() - t0
        routed = {k: v.launches for k, v in kernels.items()}
        want = ref["logits"].to(dev)
        scale = float(want.float().abs().max())
        err = float((logits.float() - want.float()).abs().max())
        expect(err <= TP_LOGITS_TOL * scale, f"tp_prefill {arch}: logits "
               f"differ by {err} of scale {scale}")
        a, b = logits.float().argmax(-1), want.float().argmax(-1)
        rows = torch.arange(a.shape[0], device=dev)
        gaps = (want.float()[rows, b] - want.float()[rows, a])[a != b]
        expect(bool((gaps <= TP_LOGITS_TOL * scale).all()),
               f"tp_prefill {arch}: argmax differs beyond a near-tie: "
               f"reference gaps {gaps.tolist()} of scale {scale}")
        own_flips = sum(int((x != y.to(x.device)).any(-1).sum())
                        for x, y in zip(own, ref["experts"]))
        rec = {"arch": arch, "layers": cfg.n_layers, "pinned": pinned,
               "routed": routed, "pinned_s": pinned_s, "routed_s": own_s,
               "logits_max_abs_err": err, "logits_scale": scale,
               "argmax_differs": int((a != b).sum()),
               "next_token_agrees": int((nxt.long() == b).sum()),
               "pinned_flips": sum(flips), "routing_flips": own_flips,
               "moe_calls": len(ref["experts"]),
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "shapes": {k: [list(s) + [n] for s, n in v.shapes.items()]
                          for k, v in kernels.items() if v.shapes}}
        if rank == 0:
            checks = {}
            if "flash_attention" in seen:
                q, k, v, causal, lse = seen["flash_attention"]
                checks["flash_attention"] = {
                    "q": list(q.shape), "kv": list(k.shape),
                    "max_abs_err": close(kernels["flash_attention"](
                        q, k, v, causal), attention_ref(q, k, v, causal),
                        f"tp_prefill {arch} flash_attention")}
            if "moe_gmm" in seen:
                x, w = seen["moe_gmm"]
                checks["moe_gmm"] = {
                    "x": list(x.shape), "w": list(w.shape),
                    "max_abs_err": close(kernels["moe_gmm"](x, w),
                                         moe_gmm_ref(x, w),
                                         f"tp_prefill {arch} moe_gmm")}
            if "mamba_ssm" in seen:
                x, dt, Bm, Cm, A_, D, h0 = seen["mamba_ssm"][:7]
                y, h = kernels["mamba_ssm"](x, dt, Bm, Cm, A_, D, h0.clone())
                wy, wh = mamba_ssm_ref(x, dt, Bm, Cm, A_, D, h0)
                checks["mamba_ssm"] = {
                    "x": list(x.shape),
                    "max_abs_err": max(
                        close(y, wy, f"tp_prefill {arch} mamba_ssm y",
                              SCAN_TOL),
                        close(h, wh, f"tp_prefill {arch} mamba_ssm h",
                              SCAN_TOL))}
            rec["kernels_vs_plain"] = checks
        out["configs"].append(rec)
        del params, logits
        free_device()
    return out


def tp_prefill_path(dev, tmp: str) -> tuple[dict, dict]:
    """The ``tp_prefill`` phase: each config's one-process prefill (its
    logits and experts kept in ``tmp``), then the two ranks; returns the
    record and the ranks' launches (summed)."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    ones = []
    for arch, layers in TP_PREFILL:
        full, cfg = tp_prefill_cfg(arch, layers)
        params = init_params(TP_SEED, cfg, device=dev)
        experts: list = []
        t0 = time.perf_counter()
        with patched(X, router_topk=tp_routing(experts)), \
                torch.inference_mode():
            logits, _ = MD.apply_prefill(params, cfg,
                                         {"tokens": tp_prompts(cfg, dev)})
        torch.cuda.synchronize()
        ones.append({"arch": arch, "seconds": time.perf_counter() - t0,
                     "reduced": {"n_layers": f"{full.n_layers} -> {layers}",
                                 "param_dtype": "float32 -> bfloat16"}})
        torch.save({"logits": logits.cpu(),
                    "experts": [e.cpu() for e in experts]},
                   Path(tmp) / f"tp_prefill_{arch}.pt")
        del params, logits, experts
        free_device()
    t0 = time.perf_counter()
    ranks = tp_spawn("prefill", tmp)
    wall = time.perf_counter() - t0
    launches: dict = {}
    for i, (arch, layers) in enumerate(TP_PREFILL):
        _, cfg = tp_prefill_cfg(arch, layers)
        k = kinds_of(cfg)
        per_pass = {"flash_attention": k.get("attn", 0),
                    "moe_gmm": 3 * k.get("moe", 0),
                    "mamba_ssm": k.get("mamba", 0)}
        for r in ranks:
            rec = r["configs"][i]
            for run in ("pinned", "routed"):
                expect(rec[run] == per_pass, f"tp_prefill {arch} rank "
                       f"{r['rank']} {run}: launches {rec[run]}, expected "
                       f"{per_pass}")
                for name, n in rec[run].items():
                    launches[name] = launches.get(name, 0) + n
    return {"phase": "tp_prefill", "mesh": "x".join(map(str, TP_MESH)),
            "backend": ranks[0]["backend"],
            "host_staged_collectives": ranks[0]["host_staged_collectives"],
            "batch": TP_PREFILL_B, "seq": TP_PREFILL_S,
            "tolerance": TP_LOGITS_TOL, "one_card": ones, "ranks": ranks,
            "ranks_wall_s": wall}, {k: v for k, v in launches.items() if v}


def split_cfg(arch: str, layers: int, compute: str | None = None):
    """A split phase's config: full width cut to ``layers``, bf16 weights,
    the config's compute dtype or ``compute``."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    return full, full.replace(n_layers=layers, param_dtype="bfloat16",
                              compute_dtype=compute or full.compute_dtype)


def split_params(cfg, dev, mesh=None):
    """``cfg``'s weights drawn in bf16 from TP_SEED, placed by the decode
    rule table on ``mesh`` when given, and for an f32-compute config held
    in f32 (the same values), cast a leaf at a time so that the bf16 and
    f32 copies of the whole model are never both held."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as SH
    params = init_params(TP_SEED, cfg, device=dev)
    if mesh is not None:
        params = steps.shard_params(params, cfg, mesh, mode="decode")
        free_device()
    if cfg.compute_dtype != "float32":
        return params

    def cast(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, x in list(items):
            if isinstance(x, (dict, list)):
                cast(x)
            elif x.is_floating_point() and x.dtype != torch.float32:
                tree[key] = SH.like(x, SH.local(x).float())
                del x
    cast(params)
    free_device()
    return params


def split_kernels() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_ssm_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_cuda
    return {"flash_attention": flash_attention_cuda, "moe_gmm": moe_gmm_cuda,
            "mamba_ssm": mamba_ssm_cuda, "rwkv6_wkv": rwkv6_wkv_cuda}


def capturing(kernels: dict, seen: dict, flash_calls: list) -> list:
    """Patches of the ops modules' kernel names (for :func:`patched_all`)
    that keep each kernel's first inputs in ``seen`` (the flash kernel's
    first causal and first full call apart) and each flash call's
    ``causal`` flag in ``flash_calls``."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    def keep(key, args):
        seen.setdefault(key, tuple(a.detach().clone() if isinstance(
            a, torch.Tensor) else a for a in args))

    def wrap(name):
        fn = kernels[name]

        def call(*args):
            if name == "flash_attention":
                flash_calls.append(bool(args[3]))
                keep(f"flash_attention causal={bool(args[3])}", args)
            else:
                keep(name, args)
            return fn(*args)
        return call
    return [(fa_ops, {"flash_attention_cuda": wrap("flash_attention")}),
            (gmm_ops, {"moe_gmm_cuda": wrap("moe_gmm")}),
            (scan_ops, {"mamba_ssm_cuda": wrap("mamba_ssm")}),
            (wkv_ops, {"rwkv6_wkv_cuda": wrap("rwkv6_wkv")})]


def kernels_vs_plain(kernels: dict, seen: dict, what: str) -> dict:
    """Each captured kernel call run again on its own inputs, against its
    plain version (the flash kernel's output and LSE within FA_TOL, the
    grouped matmul within FA_TOL, the scans within SCAN_TOL / WKV's
    bound)."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.mamba_scan import mamba_ssm_ref
    from repro_torch.kernels.moe_gmm import moe_gmm_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_ref
    out = {}
    for key, args in seen.items():
        tag = f"{what} {key}"
        if key.startswith("flash_attention"):
            q, k, v, causal = args[:4]
            got, lse = kernels["flash_attention"](q, k, v, causal, True)
            want, want_lse = attention_ref(q, k, v, causal, True)
            out[key] = {"q": list(q.shape), "kv": list(k.shape),
                        "max_abs_err": close(got, want, tag),
                        "lse_max_abs_err": close(lse, want_lse, tag + " lse",
                                                 FA_TOL[str(q.dtype)])}
        elif key == "moe_gmm":
            x, w = args[:2]
            out[key] = {"x": list(x.shape), "w": list(w.shape),
                        "max_abs_err": close(kernels["moe_gmm"](x, w),
                                             moe_gmm_ref(x, w), tag)}
        elif key == "mamba_ssm":
            x, dt, Bm, Cm, A_, D, h0 = args[:7]
            y, h = kernels["mamba_ssm"](x, dt, Bm, Cm, A_, D,
                                        None if h0 is None else h0.clone())
            wy, wh = mamba_ssm_ref(x, dt, Bm, Cm, A_, D, h0)
            out[key] = {"x": list(x.shape), "h0": h0 is not None,
                        "max_abs_err": max(close(y, wy, tag + " y", SCAN_TOL),
                                           close(h, wh, tag + " h",
                                                 SCAN_TOL))}
        else:
            r, k, v, w, u, st = args[:6]
            y, s = kernels["rwkv6_wkv"](r, k, v, w, u,
                                        None if st is None else st.clone())
            wy, ws = rwkv6_wkv_ref(r, k, v, w, u, st)
            out[key] = {"r": list(r.shape), "state0": st is not None,
                        "max_abs_err": wkv_close(y, s, wy, ws, tag)}
    return out


def scaled_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32."""
    a, b = got.float(), want.float()
    return float((a - b).abs().max()), float(b.abs().max())


def same_argmax(got, want, what: str) -> int:
    """Rows whose argmax differs; raises unless each is a near-tie (the
    reference's gap within TP_LOGITS_TOL of its scale)."""
    import torch
    a, b = got.float().argmax(-1), want.float().argmax(-1)
    rows = torch.arange(a.shape[0], device=a.device)
    w = want.float()
    gaps = (w[rows, b] - w[rows, a])[a != b]
    scale = float(w.abs().max())
    expect(bool((gaps <= TP_LOGITS_TOL * scale).all()),
           f"{what}: argmax differs beyond a near-tie: reference gaps "
           f"{gaps.tolist()} of scale {scale}")
    return int((a != b).sum())


def tp_decode_rank(mesh, rank: int, tmp: str) -> dict:
    """Per config of TP_DECODE: the decode rule table's placement of the
    weights (one rank at a time draws the whole model), the one-process
    prefill's cache placed by ``shard_cache`` (this rank's half of each KV
    sequence and of the scans' state features), TP_DECODE_STEPS decode
    steps on the one-process run's tokens with the routing pinned to its
    experts; each step's logits saved for the parent's gate, the kernels'
    launches and this rank's peak memory, and each kernel against its
    plain version on the first inputs the steps gave it."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as SH
    dev = torch.device("cuda", 0)
    kernels = split_kernels()
    out: dict = {"configs": []}
    for arch, layers, compute, _ in TP_DECODE:
        _, cfg = split_cfg(arch, layers, compute)
        tag = f"{arch}_{compute}"
        ref = torch.load(Path(tmp) / f"tp_decode_{tag}.pt")
        for r in range(int(np.prod(TP_MESH))):
            if r == rank:
                params = split_params(cfg, dev, mesh)
            dist.barrier()
        cache = steps.shard_cache([{k: v.to(dev) for k, v in lc.items()}
                                   for lc in ref["cache"]], cfg, mesh,
                                  TP_DECODE_B)
        free_device()
        seen: dict = {}
        flash_calls: list = []
        for k in kernels.values():
            k.launches = 0
            k.shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, flips = [], []
        with patched(X, router_topk=tp_routing([], ref["experts"], flips)), \
                patched_all(capturing(kernels, seen, flash_calls)), \
                torch.inference_mode(), pctx.policy(mesh):
            for t in range(TP_DECODE_STEPS):
                b = {"tokens": ref["tokens"][t].to(dev)[:, None]}
                b = SH.distribute(b, SH.batch_specs(b, mesh), mesh)
                lg, cache = MD.apply_decode(params, cfg, cache, b,
                                            TP_DECODE_PROMPT + t)
                logits.append(lg.float().cpu())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        torch.save(logits, Path(tmp) / f"tp_decode_{tag}_rank{rank}.pt")
        kv = [lc["k"] for lc in cache if "k" in lc]
        rec = {"arch": arch, "compute": compute, "layers": cfg.n_layers,
               "launches": launches,
               "seconds": seconds, "pinned_flips": sum(flips),
               "flash_launches": len(flash_calls),
               "max_memory_gb": peak,
               "kv_positions": [list(SH.local(x).shape) for x in kv[:1]],
               "shapes": {k: [list(s) + [n] for s, n in v.shapes.items()]
                          for k, v in kernels.items() if v.shapes},
               "kernels_vs_plain": kernels_vs_plain(
                   kernels, seen, f"tp_decode {tag} rank {rank}")}
        out["configs"].append(rec)
        del params, cache, seen
        free_device()
    return out


def tp_decode_path(dev, tmp: str) -> tuple[dict, dict]:
    """The ``tp_decode`` phase: each config's one-process prefill of
    TP_DECODE_B x TP_DECODE_PROMPT tokens into a cache of TP_DECODE_MAX
    positions (kept in ``tmp`` before any decode writes it), then
    TP_DECODE_STEPS greedy decode steps (tokens, logits, experts and peak
    memory kept), then the two ranks from that cache; every step's logits
    within TP_LOGITS_TOL of their scale, the same argmax but near-ties.
    Returns the record and the ranks' launches (summed)."""
    import torch

    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    ones, logits_one = [], {}
    for arch, layers, compute, _ in TP_DECODE:
        full, cfg = split_cfg(arch, layers, compute)
        tag = f"{arch}_{compute}"
        params = split_params(cfg, dev)
        rng = np.random.default_rng(TP_SEED)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TP_DECODE_B, TP_DECODE_PROMPT),
            dtype=np.int32)).to(dev)
        with torch.inference_mode():
            lg, cache = MD.apply_prefill(params, cfg, {"tokens": prompt},
                                         max_len=TP_DECODE_MAX)
        kept = [{k: v.cpu() for k, v in lc.items()} for lc in cache]
        experts: list = []
        tokens, logits = [], []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(X, router_topk=tp_routing(experts)), \
                torch.inference_mode():
            for t in range(TP_DECODE_STEPS):
                tok = lg.argmax(-1).to(torch.int32)
                tokens.append(tok.cpu())
                lg, cache = MD.apply_decode(params, cfg, cache,
                                            {"tokens": tok[:, None]},
                                            TP_DECODE_PROMPT + t)
                logits.append(lg.float().cpu())
        torch.cuda.synchronize()
        ones.append({"arch": arch, "compute": compute,
                     "seconds": time.perf_counter() - t0,
                     "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "reduced": {"n_layers": f"{full.n_layers} -> {layers}",
                                 "param_dtype": "float32 -> bfloat16"}})
        logits_one[tag] = logits
        torch.save({"cache": kept, "tokens": tokens,
                    "experts": [e.cpu() for e in experts]},
                   Path(tmp) / f"tp_decode_{tag}.pt")
        del params, cache, kept, lg, experts
        free_device()
    t0 = time.perf_counter()
    ranks = tp_spawn("decode", tmp)
    wall = time.perf_counter() - t0
    launches: dict = {}
    gates = []
    for i, (arch, layers, compute, gated) in enumerate(TP_DECODE):
        _, cfg = split_cfg(arch, layers, compute)
        tag = f"{arch}_{compute}"
        k = kinds_of(cfg)
        per_run = {"flash_attention": 0,
                   "moe_gmm": 3 * k.get("moe", 0) * TP_DECODE_STEPS,
                   "mamba_ssm": k.get("mamba", 0) * TP_DECODE_STEPS,
                   "rwkv6_wkv": k.get("rwkv", 0) * TP_DECODE_STEPS}
        errs, differs = [], 0
        for r in ranks:
            rec = r["configs"][i]
            for name, n in rec["launches"].items():
                launches[name] = launches.get(name, 0) + n
            got = torch.load(Path(tmp) / f"tp_decode_{tag}_rank"
                             f"{r['rank']}.pt")
            errs.append([scaled_err(a, b) for a, b in zip(
                got, logits_one[tag], strict=True)])
            differs += sum(int((a.argmax(-1) != b.argmax(-1)).sum())
                           for a, b in zip(got, logits_one[tag]))
            if gated:
                for t, (a, b) in enumerate(zip(got, logits_one[tag])):
                    same_argmax(a, b, f"tp_decode {tag} rank {r['rank']} "
                                f"step {t}")
        rel = [[e / s for e, s in steps_] for steps_ in errs]
        gates.append({"arch": arch, "compute": compute, "gated": gated,
                      "rel_err_by_rank_and_step": rel,
                      "max_rel_err": max(max(x) for x in rel),
                      "argmax_differs": differs})
        for r in ranks:
            rec = r["configs"][i]
            expect(rec["launches"] == per_run, f"tp_decode {tag} rank "
                   f"{r['rank']}: launches {rec['launches']}, expected "
                   f"{per_run}")
            for t, x in enumerate(rel[r["rank"]] if gated else ()):
                expect(x <= TP_LOGITS_TOL, f"tp_decode {tag} rank "
                       f"{r['rank']} step {t}: logits differ by {x:.4g} of "
                       f"their scale (steps: {rel[r['rank']]})")
    return {"phase": "tp_decode", "mesh": "x".join(map(str, TP_MESH)),
            "backend": ranks[0]["backend"],
            "host_staged_collectives": ranks[0]["host_staged_collectives"],
            "batch": TP_DECODE_B, "prompt": TP_DECODE_PROMPT,
            "max_len": TP_DECODE_MAX, "steps": TP_DECODE_STEPS,
            "tolerance": TP_LOGITS_TOL, "gates": gates, "one_card": ones,
            "ranks": ranks, "ranks_wall_s": wall}, {
        k: v for k, v in launches.items() if v}


def sp_prefill_rank(mesh, rank: int, tmp: str) -> dict:
    """Per config of SP_PREFILL: the fsdp_only prefill's placement (every
    weight replicated), the batch placed with its sequence over the two
    ranks (``batch_specs(seq_over_model=True)``), the prefill with the
    routing pinned to the one-process run's experts; the logits and this
    rank's cache saved for the parent's gates, the flash launches by
    ``causal``, every kernel's launches, this rank's peak memory, and each
    kernel against its plain version on the first inputs it was given."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as SH
    dev = torch.device("cuda", 0)
    kernels = split_kernels()
    out: dict = {"configs": []}
    for arch, layers in SP_PREFILL:
        _, cfg = split_cfg(arch, layers)
        ref = torch.load(Path(tmp) / f"sp_prefill_{arch}.pt")
        for r in range(int(np.prod(TP_MESH))):
            if r == rank:
                params = steps.shard_params(init_params(TP_SEED, cfg,
                                                        device=dev),
                                            cfg, mesh, mode="prefill")
                free_device()
            dist.barrier()
        b = {"tokens": sp_prompts(cfg, dev)}
        b = SH.distribute(b, SH.batch_specs(b, mesh, seq_over_model=True),
                          mesh)
        seen: dict = {}
        flash_calls: list = []
        flips: list = []
        for k in kernels.values():
            k.launches = 0
            k.shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split = SH.seq_split(b["tokens"])
        with patched(X, router_topk=tp_routing([], ref["experts"], flips,
                                               (split.lo, split.hi))), \
                patched_all(capturing(kernels, seen, flash_calls)), \
                torch.inference_mode(), pctx.policy(mesh):
            logits, cache = MD.apply_prefill(params, cfg, b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels.items()}
        torch.save({"logits": logits.float().cpu(), "cache": [
            {k: v.cpu() for k, v in lc.items()} for lc in cache]},
            Path(tmp) / f"sp_prefill_{arch}_rank{rank}.pt")
        rec = {"arch": arch, "layers": cfg.n_layers, "launches": launches,
               "seconds": seconds, "pinned_flips": sum(flips),
               "flash_causal": flash_calls.count(True),
               "flash_full": flash_calls.count(False),
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "positions": [split.lo, split.hi],
               "shapes": {k: [list(s) + [n] for s, n in v.shapes.items()]
                          for k, v in kernels.items() if v.shapes},
               "kernels_vs_plain": kernels_vs_plain(
                   kernels, seen, f"sp_prefill {arch} rank {rank}")}
        out["configs"].append(rec)
        del params, cache, seen
        free_device()
    return out


def sp_prompts(cfg, dev):
    import torch
    rng = np.random.default_rng(TP_SEED)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SP_PREFILL_B, SP_PREFILL_S),
        dtype=np.int32)).to(dev)


def sp_prefill_path(dev, tmp: str) -> tuple[dict, dict]:
    """The ``sp_prefill`` phase: each config's one-process prefill (its
    logits, cache and experts kept in ``tmp``), then the two ranks, each on
    its half of the sequence; the next tokens (the last logits' argmax,
    on every rank) the same but near-ties, and the ranks' caches, KV
    concatenated over the positions, within TP_LOGITS_TOL of their scale
    of the one-process cache.  Launches per rank: the flash kernel once
    causal a layer on each rank and once more full on rank 1 (its keys of
    rank 0's block); the WKV scan once a layer on each rank (with two
    ranks the first rank's zero-start scan is the sequence's and the last
    rank scans once from its carried start; a middle rank, from three
    ranks on, scans twice).  Returns the record and the ranks' launches
    (summed)."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models import model as MD
    from repro_torch.models import moe as X
    ones, want = [], {}
    for arch, layers in SP_PREFILL:
        full, cfg = split_cfg(arch, layers)
        params = init_params(TP_SEED, cfg, device=dev)
        experts: list = []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(X, router_topk=tp_routing(experts)), \
                torch.inference_mode():
            logits, cache = MD.apply_prefill(
                params, cfg, {"tokens": sp_prompts(cfg, dev)})
        torch.cuda.synchronize()
        ones.append({"arch": arch, "seconds": time.perf_counter() - t0,
                     "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "reduced": {"n_layers": f"{full.n_layers} -> {layers}",
                                 "param_dtype": "float32 -> bfloat16"}})
        want[arch] = (logits.float().cpu(),
                      [{k: v.cpu() for k, v in lc.items()} for lc in cache])
        torch.save({"experts": [e.cpu() for e in experts]},
                   Path(tmp) / f"sp_prefill_{arch}.pt")
        del params, cache, logits, experts
        free_device()
    t0 = time.perf_counter()
    ranks = tp_spawn("sp", tmp)
    wall = time.perf_counter() - t0
    launches: dict = {}
    gates = []
    n = int(np.prod(TP_MESH))
    for i, (arch, layers) in enumerate(SP_PREFILL):
        _, cfg = split_cfg(arch, layers)
        k = kinds_of(cfg)
        got = [torch.load(Path(tmp) / f"sp_prefill_{arch}_rank{r}.pt")
               for r in range(n)]
        logits, cache = want[arch]
        for r in ranks:
            rec = r["configs"][i]
            expect(rec["flash_causal"] == k.get("attn", 0)
                   and rec["flash_full"] == k.get("attn", 0) * r["rank"],
                   f"sp_prefill {arch} rank {r['rank']}: flash "
                   f"{rec['flash_causal']} causal, {rec['flash_full']} full")
            per_run = {"flash_attention": k.get("attn", 0) * (1 + r["rank"]),
                       "moe_gmm": 3 * k.get("moe", 0), "mamba_ssm": 0,
                       "rwkv6_wkv": k.get("rwkv", 0)}
            expect(rec["launches"] == per_run, f"sp_prefill {arch} rank "
                   f"{r['rank']}: launches {rec['launches']}, expected "
                   f"{per_run}")
            for name, c in rec["launches"].items():
                launches[name] = launches.get(name, 0) + c
        logit_err = 0.0
        for r in range(n):
            err, scale = scaled_err(got[r]["logits"], logits)
            expect(err <= TP_LOGITS_TOL * scale, f"sp_prefill {arch} rank "
                   f"{r}: logits differ by {err} of scale {scale}")
            logit_err = max(logit_err, err / scale)
        differs = same_argmax(got[-1]["logits"], logits, f"sp_prefill {arch}")
        worst = {}
        for j, lc in enumerate(cache):
            for key, w in lc.items():
                parts = [g["cache"][j][key] for g in got]
                a = torch.cat(parts, 1) if key in ("k", "v") else parts[-1]
                expect(all(torch.equal(p, parts[-1]) for p in parts)
                       or key in ("k", "v"),
                       f"sp_prefill {arch} layer {j} {key}: the ranks' "
                       "states differ")
                err, scale = scaled_err(a, w)
                expect(err <= TP_LOGITS_TOL * scale, f"sp_prefill {arch} "
                       f"layer {j} {key}: differs by {err} of scale {scale}")
                worst[key] = max(worst.get(key, 0.0), err / scale)
        gates.append({"arch": arch, "logits_rel_err": logit_err,
                      "argmax_differs": differs, "cache_rel_err": worst})
    return {"phase": "sp_prefill", "mesh": "x".join(map(str, TP_MESH)),
            "backend": ranks[0]["backend"],
            "host_staged_collectives": ranks[0]["host_staged_collectives"],
            "batch": SP_PREFILL_B, "seq": SP_PREFILL_S,
            "tolerance": TP_LOGITS_TOL, "gates": gates, "one_card": ones,
            "ranks": ranks, "ranks_wall_s": wall}, {
        k: v for k, v in launches.items() if v}


def dryrun_path() -> dict:
    """The ``dryrun`` phase (host only): ``python -m repro_torch.launch.
    dryrun --mesh both`` for each of DRYRUN_CELLS in subprocesses (all at
    once), each to exit 0, then ``python -m repro_torch.roofline.analysis``
    on ROOFLINE_CELL; per cell and mesh the record's per-device numbers."""
    import os

    from repro_torch.launch.dryrun import OUT_DIR
    from repro_torch.roofline.analysis import ROOFLINE_DIR
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src"),
           "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "both"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in DRYRUN_CELLS}
    logs = {}
    try:
        for cell, p in procs.items():
            logs[cell] = p.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            p.kill()
    for cell, p in procs.items():
        expect(p.returncode == 0, f"dryrun {cell} exit {p.returncode}: "
               f"{logs[cell][-2000:]}")
    wall = time.perf_counter() - t0
    cells = []
    for arch, shape in DRYRUN_CELLS:
        for mesh in ("single", "multi"):
            rec = json.loads((OUT_DIR / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            cells.append({
                "arch": arch, "shape": shape, "mesh": mesh,
                "n_chips": rec["n_chips"],
                "args_gb_per_dev":
                    rec["memory"]["argument_size_in_bytes"] / 1e9,
                "peak_gb_per_dev": rec["memory"]["peak_in_bytes"] / 1e9,
                "flop_per_dev": rec["cost"]["flops"],
                "bytes_accessed_per_dev": rec["cost"]["bytes accessed"],
                "collective_gb_per_dev": rec["collectives"]["total"] / 1e9,
                "collective_counts": rec["collectives"]["counts"],
                "trace_s": rec["trace_s"]})
    t1 = time.perf_counter()
    arch, shape = ROOFLINE_CELL
    r = subprocess.run([sys.executable, "-m", "repro_torch.roofline.analysis",
                        "--arch", arch, "--shape", shape, "--no-cache"],
                       env=env, capture_output=True, text=True,
                       timeout=DRYRUN_TIMEOUT_S)
    expect(r.returncode == 0, f"roofline exit {r.returncode}: "
           f"{(r.stdout + r.stderr)[-2000:]}")
    roof = json.loads((ROOFLINE_DIR / f"{arch}__{shape}__single.json")
                      .read_text())
    return {"phase": "dryrun", "cells": cells, "dryrun_wall_s": wall,
            "roofline": {k: roof[k] for k in (
                "arch", "shape", "mesh", "flops_per_dev", "bytes_per_dev",
                "coll_bytes_per_dev", "compute_s", "memory_s",
                "collective_s", "dominant", "compute_fraction",
                "useful_flops_ratio")},
            "roofline_wall_s": time.perf_counter() - t1}



# ------------------------------------------------------ 7e. examples -----
#: the kernels each walkthrough launches on the card (every other stays at
#: 0): the fused chain of the compute backend, the round trip's ChaCha20,
#: flash attention in training and prefill
EXAMPLE_KERNELS = {"vpc_chain": {"vpc_datapath", "chacha20_xor"},
                   "multi_tenant": {"vpc_datapath"},
                   "quickstart": {"flash_attention"},
                   "fault_tolerance": {"flash_attention"},
                   "serve_e2e": {"flash_attention"},
                   "sharded_rack": set(), "disaggregated_kv": set()}


#: the walkthroughs' datapath launches (packets, rules): vpc_chain's batch
#: of 4,096 against 32 rules; multi_tenant's dispatch groups against 16
#: rules, three heavy 64-packet batches (its bucket of 256) and one light
#: batch (64), 10 launches each
EXAMPLE_VPC_SHAPES = ((4096, 32), (256, 16), (64, 16))


def example_kernel_shapes(card: Card) -> dict:
    """``vpc_datapath`` at EXAMPLE_VPC_SHAPES and ``chacha20_xor`` at
    vpc_chain's 4,096 blocks, on random inputs: bit-exact against the
    plain version, raw-launch ms, bound and plain ms."""
    from repro_torch.kernels.chacha20.kernel import (chacha20_xor_cuda,
                                                     chacha20_xor_plain)
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    rng = np.random.default_rng(28)
    out = {}
    for n, r in EXAMPLE_VPC_SHAPES:
        a = vpc_inputs(rng, n, r, "cuda")
        got = vpc_datapath_cuda(**a)
        expect(same_triple(got, vpc_datapath_plain(**a)),
               f"vpc_datapath differs from plain at ({n}, {r})")
        bound, by, _, _ = vpc_bound(card, n, r, int(got[0].sum()))
        out[f"vpc_datapath N={n} R={r}"] = {
            "ms": cuda_ms(raw_vpc(a), 200), "bound_ms": bound, "bound_by": by,
            "plain_ms": cuda_ms(lambda: vpc_datapath_plain(**a), 3)}
    n = EXAMPLE_VPC_SHAPES[0][0]
    blocks = u32(rng, (n, 16)).to("cuda")
    key, nonce = u32(rng, (8,)).to("cuda"), u32(rng, (3,)).to("cuda")
    expect(max_abs_err((chacha20_xor_cuda(blocks, key, nonce, 1),),
                       (chacha20_xor_plain(blocks, key, nonce, 1),)) == 0,
           f"chacha20_xor differs from plain at {n} blocks")
    bound, by = card.bound(n * 128 + 11 * 4, n * CHACHA_OPS_PER_BLOCK)
    out[f"chacha20_xor N={n}"] = {
        "ms": cuda_ms(raw_chacha(blocks, key, nonce, 1), 200),
        "bound_ms": bound, "bound_by": by,
        "plain_ms": cuda_ms(lambda: chacha20_xor_plain(blocks, key, nonce, 1),
                            3)}
    return out


def all_kernels() -> dict:
    """Every kernel wrapper of the port, by its kernels-line name."""
    from repro_torch.kernels.chacha20.kernel import chacha20_xor_cuda
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    return {"vpc_datapath": vpc_datapath_cuda,
            "chacha20_xor": chacha20_xor_cuda, **train_kernels()}


def example_worker(name: str) -> int:
    """One walkthrough of EXAMPLES run as a user runs it (``python3
    examples/torch/<name>.py``: no arguments, so on cuda:0), every
    kernel's launches counted from 0; then one JSON line of them."""
    import runpy

    import torch
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    path = Path(__file__).resolve().parent / "examples" / "torch" / \
        f"{name}.py"
    sys.argv = [str(path)]
    t0 = time.perf_counter()
    runpy.run_path(str(path), run_name="__main__")
    torch.cuda.synchronize()
    print(json.dumps({"example": name, "seconds": time.perf_counter() - t0,
                      "launches": {n: k.launches
                                   for n, k in kernels.items()}}),
          flush=True)
    return 0


def examples_start(tmp: str) -> dict:
    """Every walkthrough of EXAMPLES started at once, each in a process of
    its own (this script with ``--example``), its output to a file in
    ``tmp``: name -> (process, output file, start time)."""
    started = {}
    for name in EXAMPLES:
        out = open(Path(tmp) / f"example_{name}.txt", "w")
        started[name] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--example",
             name], stdout=out, stderr=subprocess.STDOUT, text=True),
            out, time.perf_counter())
    return started


def examples_finish(started: dict) -> tuple[dict, dict]:
    """The ``examples`` phase: waits for the walkthroughs started by
    :func:`examples_start` (EXAMPLE_TIMEOUT_S at most, then every one
    still running is killed), each to exit 0 having launched exactly the
    kernels of EXAMPLE_KERNELS, ``vpc_chain`` printing its bit-exact line;
    each one's seconds (its run in its process, from the worker), launches
    and output (also in ``chiprun_out/examples/``).  The wait starts after
    the dry run, so ``all_exited_by_s`` (from the start) bounds the
    slowest one's wall from above.  Returns the record and the launches
    summed over the walkthroughs."""
    t0 = min(t for _, _, t in started.values())
    walls: dict = {}
    try:
        while len(walls) < len(started) and \
                time.perf_counter() - t0 < EXAMPLE_TIMEOUT_S:
            for name, (p, _, t) in started.items():
                if name not in walls and p.poll() is not None:
                    walls[name] = time.perf_counter() - t
            time.sleep(0.2)
    finally:
        for p, out, _ in started.values():
            p.kill()
            p.wait()
            out.close()
    keep = Path("chiprun_out") / "examples"
    keep.mkdir(parents=True, exist_ok=True)
    runs, total = {}, {}
    for name, (p, out, _) in started.items():
        text = Path(out.name).read_text()
        (keep / f"{name}.txt").write_text(text)
        expect(name in walls and p.returncode == 0,
               f"example {name}: exit {p.returncode}: {text[-3000:]}")
        lines = text.splitlines()
        last = json.loads(next(ln for ln in reversed(lines)
                               if ln.startswith('{"example": ')))
        launches = last["launches"]
        ran = {k for k, n in launches.items() if n}
        expect(ran == EXAMPLE_KERNELS[name], f"example {name} launched "
               f"{launches}, expected {sorted(EXAMPLE_KERNELS[name])}")
        if name == "vpc_chain":
            expect(any(ln.startswith("bit-exact    : matches vpc_chain")
                       for ln in lines), "vpc_chain printed no bit-exact line")
            expect(launches["vpc_datapath"] == 6 and
                   launches["chacha20_xor"] == 1,
                   f"vpc_chain: 6 fused runs and one decryption, {launches}")
        runs[name] = {"seconds": last["seconds"], "exit": p.returncode,
                      "launches": {k: n for k, n in launches.items() if n},
                      "stdout_lines": len(lines) - 1}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return ({"phase": "examples", "device": "cuda:0", "runs": runs,
             "beside": "dryrun",
             "longest_s": max(r["seconds"] for r in runs.values()),
             "all_exited_by_s": max(walls.values())}, total)


def with_paths(line: dict, by_path: dict, at: dict) -> dict:
    """A kernels-line entry with the launches of every path that ran the
    kernel (``launches_by_path``, each counted from 0 just before its
    run; ``launches`` their sum) and, per train phase (``train_paths``)
    and per serve phase timed at its own shapes (``serve_paths``), its
    per-launch ms, bound and library ms at the shape that phase ran it at
    most."""
    paths = {line["path"]: line["launches"], **by_path.get(line["name"], {})}
    line.update(launches=sum(paths.values()), launches_by_path=paths)
    for phase, entry in at.get(line["name"], {}).items():
        key = "train_paths" if phase.startswith("train") else "serve_paths"
        line.setdefault(key, {})[phase] = entry
    return line


def free_device() -> None:
    """Release a finished phase's tensors before the next phase's weights
    are drawn."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if "--tp-worker" in sys.argv:
        i = sys.argv.index("--tp-worker")
        job, rank, rdv, tmp = sys.argv[i + 1:i + 5]
        return tp_worker(job, int(rank), rdv, tmp)
    if "--example" in sys.argv:
        return example_worker(sys.argv[sys.argv.index("--example") + 1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.vpc_datapath.ops import smem_tile_bytes
    dev = torch.device("cuda", 0)
    profile = "--profile" in sys.argv
    # the plain versions' f32 products in full f32 (PyTorch's default, set
    # here so a changed default cannot loosen the f32 comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False

    card = Card()
    emit({"phase": "card", "name": card.name, "sms": card.sms,
          "max_sm_clock_mhz": card.clock_mhz,
          "int_ops_per_s": card.int_ops_per_s, "sfu_per_s": card.sfu_per_s,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})
    print(card.smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for log in _build.build_log.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    smem = libs["vpc_datapath"].vpc_datapath_smem_bytes()
    expect(smem == smem_tile_bytes(), f"shared memory {smem} != "
           f"smem_tile_bytes() {smem_tile_bytes()}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas,
          "vpc_smem_bytes": smem,
          "flash_smem_bytes": {f"{dt} hd={hd}": libs["flash_attention"]
                               .flash_attention_smem_bytes(hd, code)
                               for hd in FA_SWEEP["hd"]
                               for dt, code in (("f32", 0), ("bf16", 1))},
          "moe_gmm_smem_bytes": {f"{route} M={M}": libs["moe_gmm"]
                                 .moe_gmm_smem_bytes(xc, wc, M)
                                 for route, xc, wc in GMM_ROUTE_CODES
                                 for M in (4, 448)}})

    t0 = time.perf_counter()
    emit({"phase": "kernels_vs_plain", "chacha20_xor": check_chacha(dev),
          "vpc_datapath": check_vpc(dev), "bit_exact": True,
          "flash_attention": check_flash(dev),
          "moe_gmm": check_moe_gmm(dev), "mamba_ssm": check_mamba(dev),
          "rwkv6_wkv": check_rwkv(dev), "quantize": check_quantize(dev),
          "seconds": time.perf_counter() - t0})
    free_device()

    record, args, launches, main_a = main_path(dev, card, profile=profile)
    emit(record)
    vpc_launches = {"main": launches}

    record, chacha = encrypt_path(dev, card)
    emit(record)
    free_device()

    record, ref, vpc_launches["stream"] = stream_path(dev, card,
                                                      profile=profile)
    emit(record)
    record, vpc_launches["inject_stream"] = inject_stream_path(dev, ref)
    emit(record)
    del ref
    record, vpc_launches["fleet"] = fleet_path(dev)
    emit(record)
    record, vpc_launches["mixed_fleet"] = mixed_fleet_path(dev, card, main_a)
    emit(record)
    del main_a
    record, vpc_launches["trace"] = trace_path(dev)
    emit(record)
    emit(sim_resilience_path())
    vpc = vpc_line(card, args, vpc_launches)
    free_device()

    lines: dict = {}
    by_path: dict = {}                      # kernel -> {phase: launches}
    at: dict = {}                           # kernel -> {phase: its line}
    for phase, (arch, n_layers, requests) in SERVE_PHASES.items():
        cfg = get_config(arch)
        reduced = {}
        if n_layers is not None:
            reduced["n_layers"] = f"{cfg.n_layers} -> {n_layers}"
            cfg = cfg.replace(n_layers=n_layers)
        t0 = time.perf_counter()
        record, typical = serve_path(dev, card, phase, cfg, requests,
                                     reduced, profile=profile)
        launches = record["launches"]
        if phase == "serve_stablelm":       # head dim 160 at its prefill
            B, S = typical["flash_attention"][0].shape[:2]
            record["flash_attention_at_prefill"] = at.setdefault(
                "flash_attention", {})[phase] = flash_at(card, cfg, B, S, 20,
                                                         lse=False)
        record["phase_seconds"] = time.perf_counter() - t0
        emit(record)
        for name, n in launches.items():
            if n:
                by_path.setdefault(name, {})[phase] = n
        if phase == "serve":
            lines["flash_attention"] = flash_line(
                card, typical["flash_attention"], launches["flash_attention"])
        if phase == "serve_hybrid":
            lines["moe_gmm"] = gmm_line(card, typical, launches["moe_gmm"],
                                        phase)
            lines["mamba_ssm"] = scan_line(card, typical,
                                           launches["mamba_ssm"], phase)
        if phase == "serve_rwkv":
            lines["rwkv6_wkv"] = wkv_line(card, typical,
                                          launches["rwkv6_wkv"], phase)
        del record, typical
        free_device()

    t0 = time.perf_counter()
    record, launches = train_path(dev, profile=profile)
    record["phase_seconds"] = time.perf_counter() - t0
    emit(record)
    quant = quantize_lines(card, launches)
    for name, n in launches.items():
        by_path.setdefault(name, {})["train"] = n
    for phase in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        record, launches, train_at = family_train_path(dev, card, phase,
                                                       profile=profile)
        record["phase_seconds"] = time.perf_counter() - t0
        emit(record)
        for name, n in launches.items():
            if n:
                by_path.setdefault(name, {})[phase] = n
        for name, line in train_at.items():
            at.setdefault(name, {})[phase] = line
        del record
        free_device()
    record, launches = prefill_embeds_path(dev)
    emit(record)
    by_path.setdefault("flash_attention", {})["prefill_embeds"] = \
        launches["flash_attention"]
    free_device()

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        record, launches = mesh_train_path(dev, tmp)
        record["phase_seconds"] = time.perf_counter() - t0
        emit(record)
        for name, n in launches.items():
            by_path.setdefault(name, {})["mesh_train"] = n
        record, launches = compressed_psum_path(dev)
        emit(record)
        for name, n in launches.items():
            by_path.setdefault(name, {})["compressed_psum"] = n
    free_device()
    with tempfile.TemporaryDirectory() as tmp:
        for phase, path in (("tp_train", tp_train_path),
                            ("tp_prefill", tp_prefill_path),
                            ("tp_decode", tp_decode_path),
                            ("sp_prefill", sp_prefill_path)):
            t0 = time.perf_counter()
            record, launches = path(dev, tmp)
            record["phase_seconds"] = time.perf_counter() - t0
            emit(record)
            for name, n in launches.items():
                by_path.setdefault(name, {})[phase] = n
            free_device()
    with tempfile.TemporaryDirectory() as tmp:
        started = examples_start(tmp)       # beside the host-only dry run
        try:
            emit(dryrun_path())
        except BaseException:
            for p, out, _ in started.values():
                p.kill()
                p.wait()
                out.close()
            raise
        record, launches = examples_finish(started)
    record["kernels_at_their_shapes"] = example_kernel_shapes(card)
    emit(record)
    for name, n in launches.items():
        if n:
            by_path.setdefault(name, {})["examples"] = n
    n = by_path.get("vpc_datapath", {}).get("examples", 0)
    vpc["launches_by_path"]["examples"] = n
    vpc.update(launches=sum(vpc["launches_by_path"].values()),
               path=vpc["path"] + ", examples")

    print(card.smi, flush=True)             # again, within the tail
    emit({"kernels": [vpc, with_paths(chacha, by_path, at)] + [
        with_paths(line, by_path, at)
        for line in (lines["flash_attention"], lines["moe_gmm"], *quant,
                     lines["mamba_ssm"], lines["rwkv6_wkv"])]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
