"""Model zoo of the port: ``build_model(cfg)`` for the ported families."""
from __future__ import annotations


def build_model(cfg):
    """The model of ``cfg.family``: the decoder-only ``LM`` for ``dense``,
    ``moe`` and ``ssm`` (``vlm`` raises when built); ``hybrid`` and
    ``encdec`` are not ported yet."""
    if cfg.family in ("hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported to "
            "repro_torch yet")
    # local import: configs.base imports models.mamba2/moe for the dims
    # dataclasses, so the model modules load lazily here
    from .transformer import LM
    return LM(cfg)
