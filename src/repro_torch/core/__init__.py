"""JXPerf core, PyTorch port: the measurement substrate and the tiers
that run without JAX.

  events.py       memory events, the PMU-style ``GeometricSampler``, the
                  ``EventEngine`` (reservoir watchpoints + Defs. 1-3 trap
                  classification), ``EventTrace`` for trace→replay
                  epochs, and the one ``silent_mask`` / ``approx_equal``
  findings.py     the unified Finding / WasteProfile schema every tier emits
  reservoir.py    the paper's reservoir-sampled watchpoint slots
  context.py      calling contexts of recorded operations, ⟨C1,C2⟩ pairs
  interpreter.py  tier 1: a concrete run recorded under a dispatch mode,
                  replayed through the engine (``profile_fn``)
  detectors.py    tier 3 serving/training detectors (+ tier 4 kernel
                  counters)
  report.py       rendering, JSON round-trip and post-mortem merges
  sarif.py        SARIF v2.1.0 export

The reference's HLO analyses (tier 2) are bound to JAX and are not part
of this package.
"""
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint  # noqa: F401
from repro_torch.core.events import (EventEngine, EventTrace,  # noqa: F401
                                     GeometricSampler, MemEvent,
                                     approx_equal, silent_mask)
from repro_torch.core.findings import (Finding, WasteProfile, merge,  # noqa: F401
                                       merge_profiles)
from repro_torch.core.interpreter import JxInterpreter, Report, profile_fn  # noqa: F401
from repro_torch.core.report import (dump_json, load_json,  # noqa: F401
                                     merge_reports, merge_shards, render)
