"""JXPerf core, PyTorch port: the measurement substrate and every tier.

  events.py       memory events, the PMU-style ``GeometricSampler``, the
                  ``EventEngine`` (reservoir watchpoints + Defs. 1-3 trap
                  classification), ``EventTrace`` for trace→replay
                  epochs, and the one ``silent_mask`` / ``approx_equal``
  findings.py     the unified Finding / WasteProfile schema every tier emits
  reservoir.py    the paper's reservoir-sampled watchpoint slots
  context.py      calling contexts of recorded operations and traced
                  nodes, ⟨C1,C2⟩ pairs
  graph_trace.py  abstract traces of a step on fake tensors (kernel entry
                  points as single nodes): the graphs tiers 0 and 2 read
  graph_lint.py   tier 0: static lint of a traced step (dead/silent
                  stores, redundant loads, dead parameters; ``lint_fn``)
  graph_cost.py   tier 2's cost model of a traced step (flops, bytes,
                  collective wire bytes)
  graph_waste.py  tier 2: waste analysis of a traced step (redundant
                  collectives, recompute, reshard copies, padding;
                  ``analyze_waste``)
  interpreter.py  tier 1: a concrete run recorded under a dispatch mode,
                  replayed through the engine (``profile_fn``)
  detectors.py    tier 3 serving/training detectors (+ tier 4 kernel
                  counters)
  objects.py      the object tier's registry: allocation-site provenance
                  of KV pages, parameter and optimizer leaves, draft
                  windows
  replicas.py     the object tier's replica detector (content digests
                  taken on the objects' device)
  report.py       rendering, JSON round-trip and post-mortem merges
  sarif.py        SARIF v2.1.0 export
"""
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint  # noqa: F401
from repro_torch.core.events import (EventEngine, EventTrace,  # noqa: F401
                                     GeometricSampler, MemEvent,
                                     approx_equal, silent_mask)
from repro_torch.core.findings import (Finding, WasteProfile, merge,  # noqa: F401
                                       merge_profiles)
from repro_torch.core.interpreter import JxInterpreter, Report, profile_fn  # noqa: F401
from repro_torch.core.graph_trace import (abstract_mode, trace_program,  # noqa: F401
                                          trace_step)
from repro_torch.core.graph_lint import lint_fn, lint_graph  # noqa: F401
from repro_torch.core.graph_waste import WasteReport, analyze_waste  # noqa: F401
from repro_torch.core.report import (dump_json, load_json,  # noqa: F401
                                     merge_reports, merge_shards, render)
