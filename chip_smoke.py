#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # what the checks run
    python3 chip_smoke.py --profile    # plus one profiled main-path run

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch_kernels/``), holds each kernel bit-exact against its
plain PyTorch version on the card, drives the two paths a user calls, and
prints one JSON line per phase:

  1. card      — device name, and the ``nvidia-smi`` name / power limit line;
  2. build     — seconds the build took, ptxas register / spill counts;
  3. kernels   — ``chacha20_xor`` and ``vpc_datapath`` against their plain
                 versions at many shapes (``torch.equal``: bit-exact);
  4. main path — ``Platform(ComputeBackend())``, two tenants (weights 2:1)
                 each deploying firewall >> nat >> chacha20 with 300 rules,
                 ~1.0 M packets per run; checks outputs against the plain
                 version, decryption, launch counts, traces and the fair
                 interleave; prints Mpkt/s, wire Gbit/s and kernel ms;
  5. encrypt   — ``bytes_to_blocks`` -> ``encrypt`` -> ``blocks_to_bytes``
                 round trip of a 64 MiB buffer;
  6. serve     — ``Platform(ServeBackend(get_config("qwen3-8b"), ...))``
                 at the model's full width and depth (36 layers, random
                 f32 weights from a seeded ``torch.Generator``), two
                 tenants (gold 2 : free 1) deploying cache >> prefill >>
                 decode, 12 prompts of 256-1,536 tokens and 16 new tokens
                 each, then one prompt again (a cache hit); checks the
                 flash-attention launches (36 per prefill group), the
                 outputs, each layer's kernel attention in one group
                 against the plain version, and that group's logits
                 against a prefill whose plain attention rounds as the JAX
                 package's XLA fallback does (both within the reference's
                 bf16 tolerance); prints tokens/s, time to first token,
                 per-tenant completions and the compile log;
  7. the ``{"kernels": [...]}`` line: per kernel its launches on its path,
     time, plain time, bound and, where one PyTorch call computes the same
     function, that call's time;
and last ``{"ok": true, "device": {...}}``.  Phase 3 also holds the
flash-attention kernel against its plain version over causal and not,
G in {1, 4, 8}, hd in {64, 128}, S in {1, 7, 128, 1000, 2051}, B in {1, 4},
bf16 and f32 (the reference's tolerances: 3e-2 and 2e-5).  With
``--profile`` the main-path and serve records also carry a
``torch.profiler`` breakdown of one more run (device busy time against wall
time; full tables in ``chiprun_out/chip_smoke_profile*.txt``).  Any
mismatch raises, so the script exits non-zero; without a CUDA device it
exits non-zero at once.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

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
#: per rule per packet in the firewall: and, compare, compare, two selects
FW_OPS_PER_RULE = 5
#: NAT flow hash and port: 2 multiplies, 1 shift left, 4 xors, shift, and
NAT_OPS = 9
#: the chip-smoke workload (module level so a CPU rehearsal can shrink it)
RULES = 300
BATCHES = 8
ROWS_A, ROWS_B = 65536, 61440
TIMED_RUNS = 5
WIRE_BYTES_PER_PKT = (5 + 16) * 4
#: the serve phase
SERVE_ARCH = "qwen3-8b"
SERVE_REQUESTS = 12
SERVE_PROMPT = (256, 1536)          # prompt lengths, inclusive
SERVE_MAX_NEW = 16
SERVE_MAX_LEN = 2048
SERVE_SEED = 8
#: flash-attention sweep of phase 3, and the reference's tolerances
#: (tests/test_kernels.py: assert_allclose atol = rtol)
FA_SWEEP = dict(causal=(True, False), G=(1, 4, 8), hd=(64, 128),
                S=(1, 7, 128, 1000, 2048 + 3), B=(1, 4),
                dtype=("bfloat16", "float32"))
FA_KV = 2
FA_TOL = {"torch.bfloat16": 3e-2, "torch.float32": 2e-5}


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

    def bound(self, nbytes: float, ops: float,
              ops_per_s: float | None = None) -> tuple[float, str]:
        """Least ms for ``nbytes`` moved and ``ops`` done at ``ops_per_s``
        (default: the integer issue rate), and which of the two binds."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (ops_per_s or self.int_ops_per_s) * 1e3
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


def same_triple(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_vpc(dev) -> list:
    import torch

    from repro_torch.kernels.vpc_datapath import vpc_datapath
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    cases = []
    rng = np.random.default_rng(12)
    for n in (1, 255, 257, (1 << 20) + 3):
        for r in (1, 32, 300, 5000):
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


def close(got, want, what: str) -> float:
    """Max abs error of ``got`` against the plain ``want``; raises unless
    every element is within the reference's tolerance (|a - b| <= tol +
    tol * |b|, tol by dtype)."""
    tol = FA_TOL[str(want.dtype)]
    a, b = got.float(), want.float()
    err = (a - b).abs()
    expect(bool((err <= tol + tol * b.abs()).all()),
           f"{what} differs from plain beyond {tol}: max abs error "
           f"{float(err.max())}")
    return float(err.max())


def check_flash(dev) -> dict:
    """The flash-attention kernel against its plain version over the sweep;
    returns the case count and the largest error per dtype."""
    import itertools

    import torch

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    rng = np.random.default_rng(13)
    worst = {d: 0.0 for d in FA_SWEEP["dtype"]}
    n = 0
    for causal, G, hd, S, B, dtype in itertools.product(
            *(FA_SWEEP[k] for k in ("causal", "G", "hd", "S", "B",
                                    "dtype"))):
        q, k, v = fa_inputs(rng, B, S, FA_KV * G, FA_KV, hd, dtype, dev)
        got = flash_attention_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        err = close(got, attention_ref(q, k, v, causal),
                    "flash_attention")
        worst[dtype] = max(worst[dtype], err)
        n += 1
    return {"cases": n, "kv_heads": FA_KV, "sweep": FA_SWEEP,
            "max_abs_err": worst}


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
    rules_n, batches, rows_a, rows_b = RULES, BATCHES, ROWS_A, ROWS_B
    timed_runs = TIMED_RUNS
    import torch

    from repro_torch._u32 import arange32, narrow, where32
    from repro_torch.api import ComputeBackend, Platform, VPC_SPECS, nt
    from repro_torch.api.compute_backend import bucket_size
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels.chacha20.kernel import chacha20_xor
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    from repro_torch.kernels.vpc_datapath.ops import rule_table
    from repro_torch.serving.vpc import make_packets, make_rules

    rng = np.random.default_rng(2024)
    rules = make_rules(rules_n, seed=3, device="cpu")
    params = params_from_numpy({
        "firewall": {"rules": tuple(x.numpy() for x in rules)},
        "nat": {"nat_ip": 0x0A000001},
        "chacha20": {"key": rng.integers(0, 2 ** 32, 8, dtype=np.uint32),
                     "nonce": rng.integers(0, 2 ** 32, 3, dtype=np.uint32)},
    }, dev)
    # the card is the default device; a CPU rehearsal names its device and
    # asks for the fused path, which is the default only on CUDA
    on_cpu = {} if dev.type == "cuda" else {"device": dev, "use_fused": True}
    backend = ComputeBackend(quantum_bytes=rows_a * WIRE_BYTES_PER_PKT,
                             **on_cpu)
    plat = Platform(backend, specs=VPC_SPECS)
    vpc = nt("firewall") >> nt("nat") >> nt("chacha20")
    tenants = {"A": (2.0, rows_a), "B": (1.0, rows_b)}
    deps, traffic = {}, {}
    for i, (name, (weight, rows)) in enumerate(tenants.items()):
        deps[name] = plat.tenant(name, weight=weight).deploy(vpc,
                                                             params=params)
        traffic[name] = [make_packets(rows, seed=100 * i + b, device=dev)
                         for b in range(batches)]

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
    groups = fair_groups(last, rows_of)
    shape_counts: dict[int, int] = {}
    for _, rows in groups:
        shape_counts[bucket_size(rows)] = shape_counts.get(
            bucket_size(rows), 0) + 1
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
    if profile:
        record["profile"] = profile_run(one_run)
    common = max(shape_counts, key=lambda b: (shape_counts[b], b))
    return record, bucket_args(rng, common, table, ch, nat, dev), \
        launches_path


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
        avgs.table(sort_by="self_device_time_total", row_limit=20))
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda x: -x[1])[:8]
    total = sum(busy.values())
    return {"wall_ms": wall_ms, "device_busy_ms": total,
            "device_idle_share": 1 - total / wall_ms if dev_ev else None,
            "device_events": len(dev_ev),
            "top_device_ms": sorted(busy.items(), key=lambda x: -x[1])[:6],
            "top_host_self_ms": host}


def bucket_args(rng, n, table, ch, nat, dev):
    from repro_torch._u32 import arange32, narrow
    from repro_torch.serving.vpc import make_packets
    h, p = make_packets(n, seed=int(rng.integers(1 << 30)), device=dev)
    return dict(headers=h, payload=p, ctr=narrow(arange32(1, n, dev)),
                rule_table=table, key=ch["key"], nonce=ch["nonce"],
                nat_ip=nat, salt=0x9e3779b9)


def vpc_line(card: Card, args, launches: int) -> dict:
    from repro_torch.kernels.vpc_datapath.kernel import (vpc_datapath_cuda,
                                                         vpc_datapath_plain)
    n, r = args["headers"].shape[0], args["rule_table"].shape[0]
    out = vpc_datapath_cuda(**args)
    expect(same_triple(out, vpc_datapath_plain(**args)),
           "vpc_datapath differs from plain at the main-path shape")
    allowed = int(out[0].sum())
    nbytes = n * ((5 + 16 + 1) * 4 + 1 + (5 + 16) * 4) + r * 16 + 12 * 4
    ops = n * (FW_OPS_PER_RULE * r + NAT_OPS) + allowed * CHACHA_OPS_PER_BLOCK
    bound, by = card.bound(nbytes, ops)
    diff = max_abs_err(out, vpc_datapath_plain(**args))
    return {"name": "vpc_datapath", "route": "cuda",
            "source": "src/repro_torch/csrc/vpc_datapath.cu",
            "replaces": "src/repro/kernels/vpc_datapath/kernel.py:89",
            "path": "main", "launches": launches,
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
def serve_path(dev, card: Card, profile: bool = False):
    """Drive the serving path at the full ``SERVE_ARCH`` config.  Returns the
    phase record, the flash-attention inputs at the path's typical prefill
    shape, and the kernel's launches on the path."""
    import torch

    from repro_torch.api import SERVE_SPECS, Platform, ServeBackend, nt
    from repro_torch.configs import get_config
    from repro_torch.kernels.chacha20.kernel import chacha20_xor_cuda
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.vpc_datapath.kernel import vpc_datapath_cuda
    from repro_torch.models import apply_prefill, init_params
    from repro_torch.serving.engine import EngineConfig

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    params = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    pages = -(-(SERVE_PROMPT[1] + SERVE_MAX_NEW) // 16)
    ecfg = EngineConfig(batch_sizes=(1, 2, 4), max_len=SERVE_MAX_LEN,
                        mem_pages=SERVE_REQUESTS * pages + 64,
                        epoch_requests=6)
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
               for _ in range(SERVE_REQUESTS)]
    owner = ["gold" if i % 3 else "free" for i in range(SERVE_REQUESTS)]
    for kernel in (flash_attention_cuda, vpc_datapath_cuda, chacha20_xor_cuda):
        kernel.launches = 0                  # the serve path's counts start
    flash_attention_cuda.shapes.clear()
    t0 = time.perf_counter()
    reqs = [deps[o].inject(p, max_new=SERVE_MAX_NEW)
            for o, p in zip(owner, prompts)]
    plat.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    again = deps[owner[0]].inject(prompts[0], max_new=SERVE_MAX_NEW)
    plat.run()
    launches = flash_attention_cuda.launches
    shapes = dict(flash_attention_cuda.shapes)
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
    expect(launches == cfg.n_layers * len(groups) and launches > 0,
           f"flash-attention launches {launches} != {cfg.n_layers} x "
           f"{len(groups)} prefill groups")
    expect(other == 0, f"the serve path launched VPC kernels {other}x")
    # the kernel's own record of its (B, S): n_layers launches per group,
    # at each group's longest prompt and a batch size that holds it
    shape_list = sorted((b, s) for (b, s), n in shapes.items()
                        for _ in range(n // cfg.n_layers))
    expect(all(n % cfg.n_layers == 0 for n in shapes.values()) and
           sorted(s for _, s in shape_list) ==
           sorted(max(len(r.prompt) for r in g) for g in groups),
           f"kernel shapes {shapes} do not match the prefill groups")
    # the largest group once more, from its requests: every layer's kernel
    # attention against the plain version on the same q, k, v (the path's
    # real activations), then the logits against a prefill whose plain
    # attention rounds as the JAX package's XLA fallback does, and against
    # one with the plain version (f32 probabilities)
    bs, S = max(shape_list)
    group = next(g for g in groups if max(len(r.prompt) for r in g) == S)
    expect(len(group) <= bs, f"a group of {len(group)} in batch {bs}")
    rows = np.zeros((bs, S), np.int32)
    for j, r in enumerate(group):
        rows[j, S - len(r.prompt):] = r.prompt         # left-pad, as served
    tokens = torch.from_numpy(rows).to(dev)
    layer_errs = []

    def checked(q, k, v):
        out = flash_attention_cuda(q, k, v, True)
        layer_errs.append(close(out, attention_ref(q, k, v, True),
                                "flash_attention"))
        return out
    with torch.inference_mode():
        served, _ = apply_prefill(params, cfg, {"tokens": tokens},
                                  max_len=SERVE_MAX_LEN)
        got = prefill_logits(params, cfg, tokens, checked)
        want = prefill_logits(params, cfg, tokens, attention_fallback)
        plain = prefill_logits(params, cfg, tokens,
                               lambda q, k, v: attention_ref(q, k, v, True))
    expect(len(layer_errs) == cfg.n_layers, "attention check per layer")
    expect(torch.equal(got, served),
           "the checked prefill differs from apply_prefill")
    expect(bool(torch.isfinite(got).all()), "non-finite logits")

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())
    scale = float(want.float().abs().max())
    logits = {"bs": bs, "S": S, "rows": len(group), "max_abs": scale,
              "max_abs_err": diff(got, want), "rel_err": diff(got, want) /
              scale, "max_abs_err_vs_plain": diff(got, plain),
              "plain_versions_max_abs_err": diff(plain, want),
              "layer_attention_max_abs_err": max(layer_errs),
              "same_argmax_rows": int((got.argmax(-1) ==
                                       want.argmax(-1)).sum())}
    # element-wise, one bf16 step in one layer's attention grows through 36
    # bf16 layers past the reference's 3e-2 (the two plain versions differ
    # as much), so the logits are held to it relative to their own scale
    expect(logits["max_abs_err"] <= FA_TOL["torch.bfloat16"] * scale,
           f"prefill logits with the kernel differ from the fallback's "
           f"beyond 3e-2 of their scale: {logits}")

    ttft = [r.t_first - r.t_submit for r in reqs]
    record = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
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
        "flash_attention_launches": launches,
        "logits_vs_plain": logits,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    # the typical prefill shape: the most frequent batch size, then the
    # median prompt length among its groups
    by_bs: dict[int, list] = {}
    for b, s in shape_list:
        by_bs.setdefault(b, []).append(s)
    common = max(by_bs, key=lambda b: (len(by_bs[b]), b))
    s_med = sorted(by_bs[common])[len(by_bs[common]) // 2]
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = "torch." + cfg.compute_dtype
    fa = fa_inputs(rng, common, s_med, H, Kv, hd, cdt, dev)
    per_group = [cuda_ms(raw_flash(*fa_inputs(rng, b, s, H, Kv, hd, cdt,
                                              dev)), 10)
                 for b, s in shape_list]
    record["kernel_ms_per_run"] = cfg.n_layers * sum(per_group)
    record["kernel_share_of_run"] = record["kernel_ms_per_run"] / (wall * 1e3)
    if profile:
        more = [rng.integers(2, cfg.vocab_size, int(n), dtype=np.int64)
                .astype(np.int32)
                for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, 4)]

        def one_run():
            for p in more:
                deps["gold"].inject(p, max_new=SERVE_MAX_NEW)
            plat.run()
        record["profile"] = profile_run(one_run,
                                        "chip_smoke_profile_serve.txt")
    return record, fa, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def prefill_logits(params, cfg, tokens, attention):
    """``apply_prefill``'s logits (no cache kept) with ``attention(q, k, v)``
    as each layer's causal attention."""
    import torch

    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import linear, mlp, norm_apply
    from repro_torch.models.model import embed_inputs
    x = embed_inputs(params, cfg, {"tokens": tokens})
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    pos = pos.expand(B, S)
    for lp in params["layers"]:
        h = norm_apply(cfg.norm, lp["norm1"], x)
        q, k, v = _project_qkv(lp["attn"], h, cfg, pos)
        x = x + linear(lp["attn"]["wo"], attention(q, k, v).reshape(B, S, -1))
        h = norm_apply(cfg.norm, lp["norm2"], x)
        x = x + mlp(lp["mlp"], h, cfg.mlp_kind)
    x = norm_apply(cfg.norm, params["final_norm"], x[:, -1:, :])
    return linear(params["head"], x)[:, 0, :]


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


def raw_flash(q, k, v, causal: bool = True):
    import torch
    out = torch.empty_like(q)
    B, S, H, hd = q.shape
    return raw_launch("flash_attention", "flash_attention_launch", [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], hd, 1 if q.dtype == torch.bfloat16 else 0, int(causal),
        torch.cuda.current_stream().cuda_stream], (q, k, v, out))


def flash_line(card: Card, fa, launches: int) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    q, k, v = fa
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    got = flash_attention_cuda(q, k, v, True)
    err = close(got, attention_ref(q, k, v, True), "flash_attention")
    flops = 4 * B * H * hd * S * (S + 1) / 2
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = card.bound(nbytes, flops, PEAK_FLOPS[str(q.dtype)])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
            "path": "serve", "launches": launches,
            "shape": {"B": B, "S": S, "H": H, "Kv": Kv, "hd": hd,
                      "dtype": str(q.dtype), "causal": True},
            "max_abs_err": err,
            "ms": cuda_ms(raw_flash(q, k, v), 20),
            "call_ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), 10),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, True), 3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20),
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True), (B, H, S, hd)"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.vpc_datapath.ops import smem_tile_bytes
    dev = torch.device("cuda", 0)
    # the plain versions' f32 products in full f32 (PyTorch's default, set
    # here so a changed default cannot loosen the f32 comparisons)
    torch.backends.cuda.matmul.allow_tf32 = False

    card = Card()
    emit({"phase": "card", "name": card.name, "sms": card.sms,
          "max_sm_clock_mhz": card.clock_mhz,
          "int_ops_per_s": card.int_ops_per_s,
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
                               for dt, code in (("f32", 0), ("bf16", 1))}})

    t0 = time.perf_counter()
    emit({"phase": "kernels_vs_plain", "chacha20_xor": check_chacha(dev),
          "vpc_datapath": check_vpc(dev), "bit_exact": True,
          "flash_attention": check_flash(dev),
          "seconds": time.perf_counter() - t0})

    record, args, launches = main_path(dev, card,
                                       profile="--profile" in sys.argv)
    emit(record)
    vpc = vpc_line(card, args, launches)

    record, chacha = encrypt_path(dev, card)
    emit(record)

    record, fa, launches = serve_path(dev, card,
                                      profile="--profile" in sys.argv)
    emit(record)
    flash = flash_line(card, fa, launches)

    emit({"kernels": [vpc, chacha, flash]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
