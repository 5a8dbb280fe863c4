"""JXPerf core, PyTorch port: the measurement substrate and the serving
tiers.

  events.py     memory-event kinds, ``MemEvent`` and the one ``silent_mask``
  findings.py   the unified Finding / WasteProfile schema every tier emits
  reservoir.py  the paper's reservoir-sampled watchpoint slots
  detectors.py  tier 3 serving detectors (+ tier 4 kernel counters)
  report.py     JSON round-trip and post-mortem merges
  sarif.py      SARIF v2.1.0 export

The reference's interpreter (tier 1) and HLO analyses (tier 2) are bound
to JAX and are not part of this package.
"""
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint  # noqa: F401
from repro_torch.core.events import MemEvent, silent_mask  # noqa: F401
from repro_torch.core.findings import (Finding, WasteProfile, merge,  # noqa: F401
                                       merge_profiles)
from repro_torch.core.report import dump_json, load_json  # noqa: F401
