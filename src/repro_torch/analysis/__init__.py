"""repro_torch.analysis: MPI-3 RMA memory-model checking + protocol lint (§14).

Three entry points:

  * `races.RaceChecker` — the runtime shadow: attach to any fabric with
    ``fab.attach_shadow(RaceChecker(p))`` and it observes every one-sided
    op, AMO, notification and sync edge, reporting memory-model
    violations with exact descriptor provenance.  The conformance CLI
    exposes it as ``python -m repro_torch.sim.conformance --check-races``.
  * `ir.from_plan` / `ir.from_trace` + `races.check_ir` — static analysis
    of recorded `RmaPlan` programs and exported `obs` traces.
  * `lint` — AST-level repo rules (``python -m repro_torch.analysis.lint``).
"""

from . import ir, lint, races  # noqa: F401
from .races import (  # noqa: F401
    RaceChecker,
    RaceError,
    RaceViolation,
    check_ir,
)
