"""Configurations of the port: the SockShop application (paper §6.3) and
the Table 2 capacity cases (``capacity``, ``sockshop``), and the model-zoo
architectures that are ported (``get_config``)."""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeCfg, shape_applies  # noqa: F401

ARCH_IDS = (
    "qwen3-0.6b", "granite-20b", "phi3-medium-14b", "internlm2-1.8b",
    "whisper-base", "mamba2-130m", "jamba-1.5-large-398b", "qwen2-vl-7b",
    "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
)
# architecture → its module in this package
_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b", "granite-20b": "granite_20b",
    "phi3-medium-14b": "phi3_medium_14b", "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-130m": "mamba2_130m", "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-base": "whisper_base", "qwen2-vl-7b": "qwen2_vl_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}
PORTED = tuple(a for a in ARCH_IDS if a in _MODULES)


def get_config(name: str) -> ArchConfig:
    """The ``ArchConfig`` of an architecture (every one of ``ARCH_IDS`` is
    ported); an unknown name raises."""
    if name in _MODULES:
        return importlib.import_module(f".{_MODULES[name]}",
                                       __name__).CONFIG
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_IDS)}")
