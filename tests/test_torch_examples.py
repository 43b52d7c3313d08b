"""The port's walkthroughs (``examples/torch/*.py``) on the CPU.

``sharded_rack`` and ``disaggregated_kv`` simulate on the host: the port's
stdout equals the JAX package's walkthrough (``examples/*.py``), line for
line.  The other five run at small sizes passed to ``main(device="cpu")``
and keep their own assertions: ``vpc_chain`` holds the fused program's
output bit for bit against the plain chain and decrypts it again,
``multi_tenant`` checks the weights' direction on the sim and the WDRR
drain order, ``quickstart`` trains, serves and hits the cache,
``fault_tolerance`` crashes and restores its checkpoint, ``serve_e2e``
drains every request.  Without a device every walkthrough means the card,
which raises here.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "vpc_chain", "multi_tenant", "sharded_rack",
            "fault_tolerance", "disaggregated_kv", "serve_e2e")
#: the CPU sizes of the five that run on the device
SIZES = {
    "vpc_chain": dict(n=1024, duration_ms=0.5),
    "multi_tenant": dict(duration_ms=0.5, heavy=12, light=4),
    "quickstart": dict(steps=4, batch=2, seq=32, requests=4, max_new=4),
    "fault_tolerance": dict(steps=8, crash_at=7, batch=2, seq=32),
    "serve_e2e": dict(n_layers=2, requests=6, max_new=4),
}


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str):
    return load(ROOT / "examples" / "torch" / f"{name}.py",
                f"torch_example_{name}")


def test_every_reference_walkthrough_has_a_port():
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    mine = sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py"))
    assert ref == mine == sorted(EXAMPLES)


@pytest.mark.parametrize("name", ["sharded_rack", "disaggregated_kv"])
def test_host_walkthrough_prints_what_jax_prints(name, capsys):
    load(ROOT / "examples" / f"{name}.py", f"jax_example_{name}").main()
    want = capsys.readouterr().out
    port(name).main(device="cpu")
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) > 10


@pytest.mark.parametrize("name", sorted(SIZES))
def test_walkthrough_runs_on_the_cpu(name, capsys):
    port(name).main(device="cpu", **SIZES[name])
    out = capsys.readouterr().out
    if name == "vpc_chain":
        assert "bit-exact    : matches vpc_chain" in out
    assert out.strip()


@pytest.mark.parametrize("name", EXAMPLES)
def test_walkthrough_without_a_device_means_the_card(name, capsys,
                                                     monkeypatch):
    """No device is ``cuda:0``: with no card it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(name).main()
    assert capsys.readouterr().out == ""
