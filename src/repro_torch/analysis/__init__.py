"""simcheck on the port — static checks of the tick the card replays
(DESIGN.md §8), the counterpart of ``repro.analysis``.

Four analyzers, one CLI (``python -m repro_torch.analysis``):

* :mod:`.op_lint` — every aten operation of one eager tick step, for
  every lint combo: float64 outside the declared widening sites, host
  reads and transfers in the hot loop, loop buffers that move between
  steps (the counterpart of ``jaxpr_lint``);
* :mod:`.layout_check` — replays one tick against a recording layout
  proxy and diffs the actual column read/write sets against
  ``PHASE_COLUMNS``;
* :mod:`.streams` — named RNG streams; reuse/collision audit and the
  topology digest per combo;
* :mod:`.recompile` — the capture sentinel over the golden combos and a
  ``run_batch`` sweep of each.

Beside them :mod:`.annotate` holds checked mode (``REPRO_CHECKED=1``) and
:mod:`.waivers` the dated waivers of ``waivers.toml``.  ``streams``,
``annotate`` and ``op_lint`` are imported by the core and by ``random``
and import no ``repro_torch.core``; the checkers, which import the core
back, load lazily, so that ``core → analysis`` stays cycle-free.
"""
from . import streams  # noqa: F401  (eager: the core's wrapper target)

_LAZY = {
    "annotate": ".annotate",
    "layout_check": ".layout_check",
    "op_lint": ".op_lint",
    "recompile": ".recompile",
    "simcheck": ".simcheck",
    "waivers": ".waivers",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
