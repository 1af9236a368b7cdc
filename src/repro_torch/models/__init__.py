"""Model zoo of the port: ``build_model(cfg)`` for the ported families."""
from __future__ import annotations


def build_model(cfg):
    """The model of ``cfg.family``: ``EncDec`` for ``encdec``, the
    decoder-only ``LM`` for ``dense``, ``moe``, ``ssm`` and ``vlm``;
    ``hybrid`` is not ported yet and raises."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported to "
            "repro_torch yet")
    # local imports: configs.base imports models.mamba2/moe for the dims
    # dataclasses, so the model modules load lazily here
    if cfg.family == "encdec":
        from .encdec import EncDec
        return EncDec(cfg)
    from .transformer import LM
    return LM(cfg)
