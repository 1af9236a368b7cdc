"""Model zoo of the port: ``build_model(cfg)`` for every family."""
from __future__ import annotations


def build_model(cfg):
    """The model of ``cfg.family``: ``EncDec`` for ``encdec``,
    ``HybridLM`` for ``hybrid``, the decoder-only ``LM`` for ``dense``,
    ``moe``, ``ssm`` and ``vlm``."""
    # local imports: configs.base imports models.mamba2/moe for the dims
    # dataclasses, so the model modules load lazily here
    if cfg.family == "encdec":
        from .encdec import EncDec
        return EncDec(cfg)
    if cfg.family == "hybrid":
        from .hybrid import HybridLM
        return HybridLM(cfg)
    from .transformer import LM
    return LM(cfg)
