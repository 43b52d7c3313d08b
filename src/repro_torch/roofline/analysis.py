"""Roofline analysis from the dry run's records (no real hardware).

Terms per (arch x shape), single-pod mesh, NVIDIA H100 constants:
    compute    = FLOPs_per_device / 989e12            [s]
    memory     = bytes_per_device / 3.35e12           [s]
    collective = collective_bytes_per_device / 50e9   [s]

As in the JAX package, each cell is traced again at L = one and two layer
periods (``grad_accum`` 1) and extrapolated:
    per_period = T(L2) - T(L1);   base = T(L1) - per_period
    total      = base + (n_layers / period) * per_period
The port's trace runs every layer (no ``while`` body counted once), so the
extrapolation here only keeps the JAX package's method and unit; the full
cell's own counts are kept beside it (``raw_flops_per_dev``).

MODEL_FLOPS (usefulness denominator): train 6*N*D, prefill 2*N*D,
decode 2*N_active*B tokens (N = params, N_active for MoE).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# NVIDIA H100 SXM5 80GB, 700 W (as nvidia-smi reads the card): dense bf16
# tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM5 80GB, 700 W: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 SXM5 80GB, 700 W, in nodes of 8: NDR InfiniBand, 400 Gbit/s
# per GPU, bytes/s: the link between nodes that a 16 x 16 mesh crosses
LINK_BW = 50e9

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
ROOFLINE_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "roofline_torch"


@dataclasses.dataclass
class Terms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of the step the tensor cores are the binding
        constraint (1.0 = perfectly compute-bound)."""
        return self.compute_s / max(self.bound_s, 1e-30)


def _measure(arch: str, shape: str, mesh_name: str, n_layers: int,
             out_dir: Path):
    """Trace an n_layers variant and return its record."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as DR

    cache = out_dir / "variants" / \
        f"{arch}__{shape}__{mesh_name}__L{n_layers}.json"
    if cache.exists():
        return json.loads(cache.read_text())
    cfg = configs.get_config(arch)
    variant = cfg.replace(n_layers=n_layers, grad_accum=1)
    orig_get = configs.get_config
    configs.get_config = lambda a: variant if a == arch else orig_get(a)
    try:
        rec = DR.run_cell(arch, shape, mesh_name,
                          out_dir=out_dir / "variants", verbose=False)
    finally:
        configs.get_config = orig_get
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps(rec, indent=1))
    return rec


def analyze_cell(arch: str, shape: str, mesh_name: str = "single",
                 dryrun_dir: Path = DRYRUN_DIR,
                 out_dir: Path = ROOFLINE_DIR,
                 use_cache: bool = True) -> dict:
    """Full roofline record for one cell (with L1/L2 extrapolation)."""
    from repro_torch import configs

    out_dir.mkdir(parents=True, exist_ok=True)
    cache_fn = out_dir / f"{arch}__{shape}__{mesh_name}.json"
    if use_cache and cache_fn.exists():
        return json.loads(cache_fn.read_text())

    base_rec = json.loads(
        (dryrun_dir / f"{arch}__{shape}__{mesh_name}.json").read_text())
    cfg = configs.get_config(arch)
    L = cfg.n_layers

    # heterogeneous stacks (jamba: attn every 8th layer): extrapolate with
    # one and two full periods so the per-"layer" unit is the real mix
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    r1 = _measure(arch, shape, mesh_name, period, out_dir)
    r2 = _measure(arch, shape, mesh_name, 2 * period, out_dir)

    def term(rec, key):
        if key == "coll":
            return rec["collectives"]["total"]
        return rec["cost"].get(key, 0.0)

    vals = {}
    for key in ("flops", "bytes accessed", "coll"):
        t1, t2 = term(r1, key), term(r2, key)
        per_period = max(t2 - t1, 0.0)
        base = max(t1 - per_period, 0.0)
        # the variants run grad_accum=1 with the FULL global batch, so the
        # extrapolated totals already cover the whole step's tokens
        vals[key] = base + (L / period) * per_period

    terms = Terms(compute_s=vals["flops"] / PEAK_FLOPS,
                  memory_s=vals["bytes accessed"] / HBM_BW,
                  collective_s=vals["coll"] / LINK_BW)

    # ---- useful model flops ----
    n_chips = base_rec["n_chips"]
    Na = cfg.active_param_counts()
    B, S = base_rec["global_batch"], base_rec["seq_len"]
    if base_rec["kind"] == "train":
        model_flops = 6.0 * Na * B * S
    elif base_rec["kind"] == "prefill":
        model_flops = 2.0 * Na * B * S
    else:
        model_flops = 2.0 * Na * B          # one token per sequence
    flops_total = vals["flops"] * n_chips
    useful = model_flops / max(flops_total, 1e-30)

    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "kind": base_rec["kind"], "n_chips": n_chips,
        "flops_per_dev": vals["flops"],
        "bytes_per_dev": vals["bytes accessed"],
        "coll_bytes_per_dev": vals["coll"],
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "bound_s": terms.bound_s,
        "compute_fraction": terms.compute_fraction,
        "model_flops": model_flops,
        "useful_flops_ratio": useful,
        "raw_flops_per_dev": base_rec["cost"].get("flops", 0.0),
        "collective_counts": base_rec["collectives"].get("counts", {}),
    }
    cache_fn.write_text(json.dumps(rec, indent=1))
    return rec


def summarize(records: list[dict]) -> str:
    """Markdown table of the roofline terms."""
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| compute frac | useful ratio |\n|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for r in records:
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['compute_fraction']:.2f} "
            f"| {r['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    import argparse

    from repro_torch import configs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args(argv)
    cells = []
    for a, s, ok, _ in configs.all_cells():
        if args.arch and a != args.arch:
            continue
        if args.shape and s != args.shape:
            continue
        cells.append((a, s))
    recs, failed = [], 0
    for a, s in cells:
        try:
            r = analyze_cell(a, s, args.mesh, use_cache=not args.no_cache)
            recs.append(r)
            print(f"[roofline] {a} x {s}: dom={r['dominant']} "
                  f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                  f"coll={r['collective_s']:.3e}s "
                  f"frac={r['compute_fraction']:.2f} "
                  f"useful={r['useful_flops_ratio']:.2f}", flush=True)
        except Exception as e:  # noqa: BLE001
            failed += 1
            print(f"[roofline] FAIL {a} x {s}: {e!r}", flush=True)
    print()
    print(summarize(recs))
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
