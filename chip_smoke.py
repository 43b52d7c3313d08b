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
  6. the ``{"kernels": [...]}`` line: per kernel its launches on its path,
     time, plain time and bound;
and last ``{"ok": true, "device": {...}}``.  With ``--profile`` the
main-path record also carries a ``torch.profiler`` breakdown of one more
run (device busy time against wall time; full tables in
``chiprun_out/chip_smoke_profile.txt``).  Any mismatch raises, so the
script exits non-zero; without a CUDA device it exits non-zero at once.
Imports nothing of JAX and nothing of the JAX package.
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

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.int_ops_per_s * 1e3
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


def profile_run(one_run) -> dict:
    """One more main-path run under ``torch.profiler``: wall time, device
    busy time (sum of CUDA kernel and memory-op durations), and the top
    device and host entries.  The full tables go to chiprun_out/."""
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
    (out / "chip_smoke_profile.txt").write_text(
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.vpc_datapath.ops import smem_tile_bytes
    dev = torch.device("cuda", 0)

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
          "vpc_smem_bytes": smem})

    t0 = time.perf_counter()
    emit({"phase": "kernels_vs_plain", "chacha20_xor": check_chacha(dev),
          "vpc_datapath": check_vpc(dev), "bit_exact": True,
          "seconds": time.perf_counter() - t0})

    record, args, launches = main_path(dev, card,
                                       profile="--profile" in sys.argv)
    emit(record)
    vpc = vpc_line(card, args, launches)

    record, chacha = encrypt_path(dev, card)
    emit(record)

    emit({"kernels": [vpc, chacha]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card.name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
