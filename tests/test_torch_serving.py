"""The port's serving slice held against the JAX package, on the CPU.

Both packages run with the same weights: the JAX package initialises them,
and :func:`repro_torch.convert.model_params_from_numpy` carries them across
(as a list of layers and as layers stacked for ``lax.scan``).  Prompts are
drawn with numpy from a seed.  Logits agree within 1e-4 (f32 tiny configs:
summation order differs between XLA and PyTorch), greedy tokens exactly;
the engine scenarios of ``tests/test_serving.py`` replay on both packages
and must agree on generated tokens, cache hits, the ``active_bs``
trajectory, the ``compile_log`` kinds and shapes, and the KV frames freed.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import Platform as JPlatform
from repro.api import nt as jnt
from repro.models import model as JM
from repro.serving import engine as jengine

from repro_torch import configs
from repro_torch.api import DagError, Platform, nt
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as TM
from repro_torch.serving import engine as tengine

CPU = "cpu"
#: the JAX package's model steps, jitted as its engine runs them
j_prefill = jax.jit(JM.apply_prefill, static_argnums=(1,),
                    static_argnames=("max_len",))
j_decode = jax.jit(JM.apply_decode, static_argnums=(1,))


def musicgen_cfg(pkg):
    return pkg.get_tiny_config("musicgen-medium").replace(
        frontend="tokens", vocab_size=64)


def prompts(n, lo=4, hi=12, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def ported(jparams, cfg):
    return model_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   CPU)


def assert_logits(t, j, atol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


# ========================================================== model steps ====
@pytest.mark.parametrize("arch,scan", [("qwen3-8b", False), ("qwen3-8b", True),
                                       ("musicgen-medium", False),
                                       ("musicgen-medium", True)])
def test_prefill_and_decode_match_jax(arch, scan):
    """Left-padded prompts, greedy decode past the prompt: logits within
    1e-4 and the same greedy tokens at every step."""
    check_prefill_and_decode(jconfigs.get_tiny_config(arch).replace(
        frontend="tokens", scan_layers=scan), scan)


@pytest.mark.parametrize("scan", [False, True])
def test_stablelm_at_head_dim_160_prefill_and_decode_match_jax(scan):
    """Tiny stablelm (LayerNorm) at stablelm-12b's head dim, 160, which the
    port's attention kernel is instantiated for: the same logits, caches
    and greedy tokens as the JAX package."""
    cfg = jconfigs.get_tiny_config("stablelm-12b").replace(head_dim=160,
                                                           scan_layers=scan)
    assert cfg.norm == "layernorm" and cfg.hd == 160
    check_prefill_and_decode(cfg, scan)


def check_prefill_and_decode(cfg, scan):
    jp = JM.init_params(jax.random.PRNGKey(7), cfg)
    assert isinstance(jp["layers"], dict) == scan     # both JAX layouts
    tp = ported(jp, cfg)
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab_size, (3, 13)).astype(np.int32)
    toks[1, :4] = 0                                   # left-pad, as the engine
    jl, jc = j_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = TM.apply_prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              max_len=24)
    assert tl.shape == (3, cfg.vocab_size) and tc[0]["k"].shape[1] == 24
    assert_logits(tl, jl)
    jk = jc["k"][0] if scan else jc[0]["k"]
    np.testing.assert_allclose(tc[0]["k"].numpy(), np.asarray(jk),
                               atol=1e-5, rtol=1e-5)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    for i in range(6):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = j_decode(jp, cfg, jc, {"tokens": jt[:, None]},
                          jnp.int32(13 + i))
        tl, tc = TM.apply_decode(tp, cfg, tc, {"tokens": tt[:, None]}, 13 + i)
        assert_logits(tl, jl)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)


#: MoE and hybrid stacks: (arch, scan_layers, n_layers or None for the
#: tiny config's own).  Tiny Jamba keeps its copied ``attn_period = 8``, so
#: its 4 layers have attention only at layer 1 (also an MoE layer); at 8
#: layers attention, Mamba + MLP and Mamba + MoE layers all run.
MOE_HYBRID = [("granite-moe-1b-a400m", False, None),
              ("granite-moe-1b-a400m", True, None),
              ("jamba-v0.1-52b", False, None),
              ("jamba-v0.1-52b", False, 8)]


def layer_cache(cache, i, key, scan):
    return cache[key][i] if scan else cache[i][key]


#: each mixer kind's decode state
CACHE_KEYS = {"attn": ("k", "v"), "mamba": ("conv", "ssm"),
              "rwkv": ("x_tm", "x_cm", "wkv")}


def assert_caches(tc, jc, cfg, scan):
    """Every layer's decode state: K/V rows, the conv state and the f32 SSM
    state, the RWKV blocks' last tokens and f32 WKV state."""
    for i, (mix, _) in enumerate(cfg.layer_kinds()):
        for key in CACHE_KEYS[mix]:
            np.testing.assert_allclose(
                tc[i][key].float().numpy(),
                np.asarray(layer_cache(jc, i, key, scan), np.float32),
                atol=1e-4, rtol=1e-4, err_msg=f"layer {i} {key}")


@pytest.mark.parametrize("arch,scan,n_layers", MOE_HYBRID)
def test_moe_and_hybrid_prefill_and_decode_match_jax(arch, scan, n_layers):
    """Left-padded prompts, greedy decode past the prompt: logits within
    1e-4, the same greedy tokens, and every layer's cache (K/V, conv, SSM)
    within 1e-4 after the prefill and after the last decode step."""
    cfg = jconfigs.get_tiny_config(arch).replace(scan_layers=scan)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    check_steps_and_caches(cfg, scan)


@pytest.mark.parametrize("scan", [False, True])
def test_rwkv_prefill_and_decode_match_jax(scan):
    """Tiny rwkv6-3b in both layer layouts (its tiny config lists the
    layers, the full one stacks them): logits within 1e-4, the same greedy
    tokens, and every layer's ``x_tm``, ``x_cm`` and ``wkv`` within 1e-4
    after the prefill and after the last decode step.  The left pad tokens
    enter the recurrent state, as they do in the JAX package."""
    cfg = jconfigs.get_tiny_config("rwkv6-3b").replace(scan_layers=scan)
    check_steps_and_caches(cfg, scan)


def check_steps_and_caches(cfg, scan):
    jp = JM.init_params(jax.random.PRNGKey(11), cfg)
    assert isinstance(jp["layers"], dict) == scan     # both JAX layouts
    tp = ported(jp, cfg)
    assert len(tp["layers"]) == cfg.n_layers
    rng = np.random.default_rng(5)
    toks = rng.integers(2, cfg.vocab_size, (3, 13)).astype(np.int32)
    toks[2, :5] = 0                                   # left-pad, as the engine
    jl, jc = j_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = TM.apply_prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              max_len=24)
    assert_logits(tl, jl)
    assert_caches(tc, jc, cfg, scan)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    for i in range(6):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = j_decode(jp, cfg, jc, {"tokens": jt[:, None]},
                          jnp.int32(13 + i))
        tl, tc = TM.apply_decode(tp, cfg, tc, {"tokens": tt[:, None]}, 13 + i)
        assert_logits(tl, jl)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_caches(tc, jc, cfg, scan)


def test_decode_past_max_len_clamps_like_dynamic_update_slice():
    """pos >= max_len writes K/V at max_len - 1 and attends to pos + 1 keys,
    as ``jax.lax.dynamic_update_slice`` clamps in the JAX package."""
    cfg = jconfigs.get_tiny_config("qwen3-8b")
    jp = JM.init_params(jax.random.PRNGKey(1), cfg)
    tp = ported(jp, cfg)
    toks = np.arange(2, 8, dtype=np.int32)[None]
    jl, jc = j_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, max_len=8)
    tl, tc = TM.apply_prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              max_len=8)
    for pos in range(6, 12):                          # 8..11 are past the end
        step = np.full((1, 1), pos + 3, np.int32)
        jl, jc = j_decode(jp, cfg, jc, {"tokens": jnp.asarray(step)},
                          jnp.int32(pos))
        tl, tc = TM.apply_decode(tp, cfg, tc,
                                 {"tokens": torch.from_numpy(step)}, pos)
        assert_logits(tl, jl)
        np.testing.assert_allclose(tc[1]["v"].numpy(), np.asarray(jc[1]["v"]),
                                   atol=1e-5, rtol=1e-5)


def test_prefill_longer_than_cache_raises_in_both():
    cfg = jconfigs.get_tiny_config("qwen3-8b")
    jp = JM.init_params(jax.random.PRNGKey(1), cfg)
    toks = np.ones((1, 12), np.int32)
    with pytest.raises(Exception):
        j_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        TM.apply_prefill(ported(jp, cfg), cfg,
                         {"tokens": torch.from_numpy(toks)}, max_len=8)


def test_configs_match_jax():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        for get in ("get_config", "get_tiny_config"):
            mine = getattr(configs, get)(name)
            ref = getattr(jconfigs, get)(name)
            assert vars(mine) == vars(ref), (name, get)
            assert mine.param_counts() == ref.param_counts()
    assert configs.get_config("qwen3-8b").param_counts()["total"] == \
        8_190_427_136


@pytest.mark.parametrize("arch", ["qwen2-vl-2b"])
def test_other_families_raise_naming_their_slice(arch):
    """The name dates from when Qwen2-VL's multimodal RoPE raised; it is
    ported now, so a Qwen2-VL prefill from embeddings (M-RoPE over (3, B,
    S) positions) is held against the JAX package's, logits within 1e-4."""
    cfg = jconfigs.get_tiny_config(arch)
    jp = JM.init_params(jax.random.PRNGKey(2), cfg)
    embeds = np.random.default_rng(4).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32) * 0.02
    jl, _ = j_prefill(jp, cfg, {"embeds": jnp.asarray(embeds)}, max_len=8)
    tl, _ = TM.apply_prefill(ported(jp, cfg), cfg,
                             {"embeds": torch.from_numpy(embeds)}, max_len=8)
    assert_logits(tl, jl)


def test_init_params_shapes_dtypes_and_default_device():
    check_init_params(configs.get_tiny_config("qwen3-8b"))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_init_params_moe_and_hybrid_shapes_dtypes(arch):
    check_init_params(configs.get_tiny_config(arch).replace(n_layers=8))


def test_init_params_rwkv_shapes_dtypes():
    check_init_params(configs.get_tiny_config("rwkv6-3b"))
    cfg = configs.get_config("rwkv6-3b")
    assert cfg.param_counts()["total"] == 3_099_033_600
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_size,
            cfg.compute_dtype) == (32, 2560, 40, 64, "bfloat16")


def check_init_params(cfg):
    """The port's random parameters have the JAX package's leaves, shapes
    and dtypes; no device means the card, which is an error without one."""
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = TM.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    flat_j = jax.tree.leaves_with_path(jp)
    flat_t = ported(jp, cfg)
    assert len(flat_j) == sum(1 for _ in _leaves(tp)) == \
        sum(1 for _ in _leaves(flat_t))
    for (pj, a), (pt, b) in zip(_leaves(flat_t), _leaves(tp)):
        assert pj == pt and a.shape == b.shape and a.dtype == b.dtype
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(0, cfg)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# ======================================================= engine scenarios ====
def engines(cfg, ecfg_kw, seed):
    """A JAX engine and a port engine on the CPU with the same weights."""
    je = jengine.Engine(cfg, jengine.EngineConfig(**ecfg_kw), seed=seed)
    te = tengine.Engine(cfg, tengine.EngineConfig(**ecfg_kw),
                        params=ported(je.params, cfg), device=CPU)
    return je, te


def drain(eng, traj, max_iters=1000):
    for _ in range(max_iters):
        if not eng.sched.pending():
            break
        eng.step()
        traj.append(eng.active_bs)


def record(eng, traj):
    return {
        "done": [(r.rid, r.tenant, r.out, r.cached) for r in eng.done],
        "hits": (eng.cache_nt.hits, eng.cache_nt.misses),
        "active_bs": list(traj),
        "compile_log": [(k, bs) for k, bs, _ in eng.compile_log],
        "frames_free": (len(eng.vmem.free_frames), eng.vmem.n_frames),
        "allocs": eng.vmem.stats.allocs,
    }


def sc_generate(eng, traj):
    eng.submit("t0", np.arange(3, 9, dtype=np.int32), max_new=6)
    drain(eng, traj)


def sc_cache_hit(eng, traj):
    p = np.arange(3, 9, dtype=np.int32)
    eng.submit("t0", p, max_new=4)
    drain(eng, traj)
    eng.submit("t0", p, max_new=4)
    drain(eng, traj)


def sc_drf(eng, traj):
    for p in prompts(40, seed=1):
        eng.submit("heavy", p, max_new=4)
    for p in prompts(4, seed=2):
        eng.submit("light", p, max_new=4)
    for _ in range(6):
        eng.step()
        traj.append(eng.active_bs)


def sc_autoscale(eng, traj):
    for p in prompts(24, seed=5):
        eng.submit("t", p, max_new=2)
    eng.step()
    traj.append(eng.active_bs)
    drain(eng, traj)


def sc_prelaunch(eng, traj):
    eng.prelaunch()
    traj.append(len(eng.compile_log))
    for p in prompts(4, seed=6):
        eng.submit("t", p, max_new=2)
    drain(eng, traj)


def sc_kv_pages(eng, traj):
    for p in prompts(3, lo=30, hi=34, seed=7):
        eng.submit("t", p, max_new=16)
    drain(eng, traj, max_iters=40)


def sc_past_max_len(eng, traj):
    """prompt + max_new > max_len: decode runs past the cache's end."""
    eng.submit("a", np.arange(2, 12, dtype=np.int32), max_new=12)
    eng.submit("b", np.arange(5, 9, dtype=np.int32), max_new=12)
    drain(eng, traj)


SCENARIOS = {
    "generate": (sc_generate, dict(batch_sizes=(1,), max_len=64,
                                   enable_cache_nt=False), 1),
    "cache_hit": (sc_cache_hit, dict(batch_sizes=(1,), max_len=64), 2),
    "drf_fairness": (sc_drf, dict(batch_sizes=(1, 2, 4), max_len=64,
                                  enable_cache_nt=False,
                                  epoch_requests=4), 3),
    "autoscale": (sc_autoscale, dict(batch_sizes=(1, 2, 4), max_len=64,
                                     enable_cache_nt=False,
                                     epoch_requests=8), 4),
    "prelaunch": (sc_prelaunch, dict(batch_sizes=(1, 2), max_len=64), 5),
    "kv_pages": (sc_kv_pages, dict(batch_sizes=(1,), max_len=64,
                                   mem_pages=4, page_tokens=8,
                                   enable_cache_nt=False), 6),
    "past_max_len": (sc_past_max_len, dict(batch_sizes=(2,), max_len=16,
                                           enable_cache_nt=False), 8),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_jax(name):
    scenario, ecfg_kw, seed = SCENARIOS[name]
    cfg = musicgen_cfg(jconfigs)
    je, te = engines(cfg, ecfg_kw, seed)
    runs = []
    for eng in (je, te):
        traj: list = []
        scenario(eng, traj)
        runs.append(record(eng, traj))
    assert runs[1] == runs[0]
    rec = runs[1]
    # the JAX package's own assertions on each scenario hold for the port
    if name == "cache_hit":
        assert rec["hits"][0] == 1 and rec["done"][1][3]
    if name == "drf_fairness":
        assert sum(1 for d in rec["done"] if d[1] == "light") >= 2
    if name == "autoscale":
        assert rec["active_bs"][0] > 1
        assert any(k == "decode" for k, _ in rec["compile_log"])
    if name == "prelaunch":
        assert len(rec["compile_log"]) == rec["active_bs"][0]
    if name in ("kv_pages", "past_max_len"):
        assert rec["allocs"] > 0
        assert rec["frames_free"][0] == rec["frames_free"][1]
    if name == "past_max_len":
        assert [len(d[2]) for d in rec["done"]] == [12, 12]


def sc_mixed(eng, traj):
    """Autoscaling over mixed prompt lengths, then a repeat (a cache hit)."""
    ps = prompts(9, lo=3, hi=20, seed=12)
    for i, p in enumerate(ps):
        eng.submit("gold" if i % 3 else "free", p, max_new=5)
    drain(eng, traj)
    eng.submit("free", ps[0], max_new=5)
    drain(eng, traj)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_engine_scenario_moe_and_hybrid_match_jax(arch):
    """Tokens, the cache hit, the ``active_bs`` trajectory and the compile
    log of the port's engine against the JAX engine, on the MoE and hybrid
    tiny configs."""
    check_mixed_scenario(jconfigs.get_tiny_config(arch))


def test_engine_scenario_rwkv_matches_jax():
    """The same scenario on tiny rwkv6-3b: the engine batches, pads and
    decodes RWKV's constant-size state without looking inside it."""
    check_mixed_scenario(jconfigs.get_tiny_config("rwkv6-3b"))


def check_mixed_scenario(cfg):
    je, te = engines(cfg, dict(batch_sizes=(1, 2, 4), max_len=32,
                               epoch_requests=6), seed=13)
    runs = []
    for eng in (je, te):
        traj: list = []
        sc_mixed(eng, traj)
        runs.append(record(eng, traj))
    assert runs[1] == runs[0]
    assert runs[1]["hits"][0] == 1 and runs[1]["done"][-1][3]
    assert max(runs[1]["active_bs"]) > 1


def test_engine_output_equals_direct_steps():
    """The port's engine output == its own direct prefill + decode."""
    cfg = musicgen_cfg(configs)
    eng = tengine.Engine(cfg, tengine.EngineConfig(
        batch_sizes=(1,), max_len=64, enable_cache_nt=False), seed=1,
        device=CPU)
    p = np.arange(3, 9, dtype=np.int32)
    req = eng.submit("t0", p, max_new=6)
    eng.run_until_drained()
    logits, cache = TM.apply_prefill(eng.params, cfg,
                                     {"tokens": torch.from_numpy(p)[None]},
                                     max_len=64)
    toks = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(6):
        toks.append(int(tok[0]))
        logits, cache = TM.apply_decode(eng.params, cfg, cache,
                                        {"tokens": tok[:, None]}, len(p) + i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    assert req.out == toks


def test_engine_overload_and_default_device():
    cfg = musicgen_cfg(configs)
    eng = tengine.Engine(cfg, tengine.EngineConfig(max_pending=2), seed=0,
                         device=CPU)
    eng.submit("a", np.arange(4, dtype=np.int32))
    eng.submit("a", np.arange(4, dtype=np.int32))
    from repro_torch.faults import Overloaded
    with pytest.raises(Overloaded) as err:
        eng.submit("a", np.arange(4, dtype=np.int32))
    assert err.value.retry_after_s > 0 and eng.rejected == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.Engine(cfg, tengine.EngineConfig())


# =========================================================== ServeBackend ====
def serve_platform(pkg, cfg, ecfg, params):
    if pkg == "jax":
        from repro.api import SERVE_SPECS, ServeBackend
        be = ServeBackend(cfg, jengine.EngineConfig(**ecfg), params=params)
        return JPlatform(be, specs=SERVE_SPECS), jnt
    from repro_torch.api import SERVE_SPECS, ServeBackend
    be = ServeBackend(cfg, tengine.EngineConfig(**ecfg), params=params,
                      device=CPU)
    return Platform(be, specs=SERVE_SPECS), nt


def platform_reports(cfg, jparams):
    """The same two-tenant traffic through ``Platform(ServeBackend)`` of
    the JAX package and of the port, with the same weights."""
    ecfg = dict(batch_sizes=(1, 2), max_len=32, epoch_requests=4)
    reports = []
    for pkg, params in (("jax", jparams), ("torch", ported(jparams, cfg))):
        plat, mk = serve_platform(pkg, cfg, ecfg, params)
        chain = mk("cache") >> mk("prefill") >> mk("decode")
        deps = {"gold": plat.tenant("gold", weight=2.0).deploy(chain),
                "free": plat.tenant("free", weight=1.0).deploy(chain)}
        assert plat.admission_log == []       # shared cache spec: no finding
        plat.backend.prelaunch()
        for i, p in enumerate(prompts(6, seed=11)):
            deps["gold" if i % 2 else "free"].inject(p, max_new=3)
        plat.run()
        deps["free"].inject(prompts(6, seed=11)[0], max_new=3)   # cache hit
        plat.run()
        rep = plat.report()
        reports.append({
            "tenants": {n: (t.pkts_done, t.extra["cached"], t.extra["weight"],
                            [r.out for r in t.outputs])
                        for n, t in sorted(rep.tenants.items())},
            "cache": (rep.extra["cache_hits"], rep.extra["cache_misses"]),
            "compile_log": [(k, bs) for k, bs, _ in rep.extra["compile_log"]],
            "capacity": plat.backend.capacity()})
    return reports


def test_serve_backend_through_platform_matches_jax():
    cfg = musicgen_cfg(jconfigs)
    reports = platform_reports(cfg, JM.init_params(jax.random.PRNGKey(9),
                                                   cfg))
    assert reports[1] == reports[0]
    assert reports[1]["cache"][0] == 1
    assert reports[1]["tenants"]["free"][1] == 1


def test_serve_backend_hybrid_through_platform_matches_jax():
    """Tiny Jamba (Mamba, attention and MoE layers) behind the Platform:
    the same tokens, cache hits and compile log as the JAX package."""
    cfg = jconfigs.get_tiny_config("jamba-v0.1-52b").replace(n_layers=8)
    reports = platform_reports(cfg, JM.init_params(jax.random.PRNGKey(9),
                                                   cfg))
    assert reports[1] == reports[0]
    assert reports[1]["cache"][0] == 1
    assert reports[1]["tenants"]["free"][1] == 1


def test_serve_backend_rwkv_through_platform_matches_jax():
    """Tiny rwkv6-3b behind the Platform: the same tokens, cache hits and
    compile log as the JAX package."""
    cfg = jconfigs.get_tiny_config("rwkv6-3b")
    reports = platform_reports(cfg, JM.init_params(jax.random.PRNGKey(9),
                                                   cfg))
    assert reports[1] == reports[0]
    assert reports[1]["cache"][0] == 1
    assert reports[1]["tenants"]["free"][1] == 1


def test_serve_backend_stablelm_hd160_through_platform_matches_jax():
    """Tiny stablelm at head dim 160 behind the Platform: the same tokens,
    cache hits and compile log as the JAX package."""
    cfg = jconfigs.get_tiny_config("stablelm-12b").replace(head_dim=160)
    reports = platform_reports(cfg, JM.init_params(jax.random.PRNGKey(9),
                                                   cfg))
    assert reports[1] == reports[0]
    assert reports[1]["cache"][0] == 1


def test_serve_cache_setting_conflict_rejected():
    """The response cache is engine-wide: a second deployment that
    disagrees must fail loudly, not silently reconfigure tenant A."""
    cfg = musicgen_cfg(configs)
    plat, _ = serve_platform("torch", cfg, dict(batch_sizes=(1,),
                                                max_len=32),
                             TM.init_params(0, cfg, device=CPU))
    plat.tenant("a").deploy(nt("cache") >> nt("prefill") >> nt("decode"))
    with pytest.raises(DagError, match="engine-wide"):
        plat.tenant("b").deploy(nt("prefill") >> nt("decode"))
    assert plat.backend.engine.ecfg.enable_cache_nt is True
    with pytest.raises(DagError, match="prefill and decode"):
        plat.tenant("c").deploy(nt("cache") >> nt("decode"))
    with pytest.raises(DagError, match="no serving implementation"):
        from repro_torch.core.nt import NTSpec
        plat.register(NTSpec("firewall"))


def test_isolation_scan_covers_the_serving_slice():
    """``tests/test_torch_isolation.py`` imports and scans every module
    under ``src/repro_torch`` by glob; the serving slice's modules are among
    them."""
    port = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    found = {".".join(p.relative_to(port.parent).with_suffix("").parts)
             for p in port.rglob("*.py")}
    for m in ("configs.__init__", "configs.qwen3_8b", "faults.__init__",
              "faults.errors", "models.layers", "models.attention",
              "models.model", "serving.engine", "api.serve_backend",
              "kernels.flash_attention.kernel",
              "kernels.flash_attention.ops", "kernels.flash_attention.ref",
              "models.moe", "models.mamba", "models.rwkv6",
              *(f"kernels.{k}.{m}"
                for k in ("moe_gmm", "mamba_scan", "rwkv6_scan")
                for m in ("kernel", "ops", "ref"))):
        assert f"repro_torch.{m}" in found, m
