"""Architecture registry: one module per assigned architecture.

A copy of the JAX package's ``configs`` (pure dataclasses, no framework).
"""
from __future__ import annotations

from importlib import import_module

from .base import ModelConfig, ShapeConfig, SHAPES, shape_applicable  # noqa: F401

_ARCH_MODULES = {
    "stablelm-12b": "stablelm_12b",
    "yi-6b": "yi_6b",
    "qwen3-8b": "qwen3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-3b": "rwkv6_3b",
    "grok-1-314b": "grok_1_314b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "jamba-v0.1-52b": "jamba_52b",
}

ARCH_NAMES = list(_ARCH_MODULES)


def _mod(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return import_module(f".{_ARCH_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_tiny_config(name: str) -> ModelConfig:
    return _mod(name).tiny()


def all_cells(include_skipped: bool = False):
    """Yield (arch_name, shape_name, applicable, reason) for the 40 cells."""
    for a in ARCH_NAMES:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            if ok or include_skipped:
                yield a, s.name, ok, why
