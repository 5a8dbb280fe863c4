"""Fault tolerance runtime: heartbeats, straggler detection, restart policy.

Port of src/repro/runtime/fault.py (pure Python, the same logic).

On a real multi-host deployment each host runs a ``Heartbeat`` reporter and
rank 0 runs the ``FleetMonitor``; here the same objects are driven by the
single-process launcher and by tests (simulated hosts), which is exactly
the logic that matters — detection thresholds, restart decisions, and the
interaction with the checkpointer — minus the transport.

Policy (DESIGN.md §4):
  * a host missing `dead_after` heartbeats is declared failed -> restore
    from the last checkpoint onto the surviving device set (elastic);
  * a host whose step time exceeds `straggler_factor` x the fleet median
    for `straggler_patience` consecutive steps is flagged (mitigation at
    1000+ nodes: drop from the critical path / re-shard around it);
  * restarts are bounded by `max_restarts` within a sliding window.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HostState:
    last_beat: float = 0.0
    step_times: deque = field(default_factory=lambda: deque(maxlen=32))
    straggler_streak: int = 0


class FleetMonitor:
    def __init__(self, hosts: List[int], *, dead_after: float = 60.0,
                 straggler_factor: float = 2.0, straggler_patience: int = 3,
                 max_restarts: int = 5, clock=time.monotonic):
        self.clock = clock
        self.dead_after = dead_after
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.max_restarts = max_restarts
        self.restarts = 0
        self.hosts: Dict[int, HostState] = {h: HostState() for h in hosts}
        now = clock()
        for st in self.hosts.values():
            st.last_beat = now

    # ------------------------------------------------------------------
    def heartbeat(self, host: int, step_time_s: Optional[float] = None):
        st = self.hosts[host]
        st.last_beat = self.clock()
        if step_time_s is not None:
            st.step_times.append(step_time_s)

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.dead_after]

    def stragglers(self) -> List[int]:
        times = [st.step_times[-1] for st in self.hosts.values()
                 if st.step_times]
        if len(times) < max(2, len(self.hosts) // 2):
            return []
        med = sorted(times)[len(times) // 2]
        out = []
        for h, st in self.hosts.items():
            if st.step_times and st.step_times[-1] > self.straggler_factor * med:
                st.straggler_streak += 1
                if st.straggler_streak >= self.straggler_patience:
                    out.append(h)
            else:
                st.straggler_streak = 0
        return out

    # ------------------------------------------------------------------
    def plan(self) -> Dict[str, object]:
        """Decision for the launcher at this tick."""
        dead = self.dead_hosts()
        if dead:
            if self.restarts >= self.max_restarts:
                return {"action": "abort",
                        "reason": f"restart budget exhausted ({self.restarts})"}
            self.restarts += 1
            survivors = [h for h in self.hosts if h not in dead]
            return {"action": "elastic_restart", "dead": dead,
                    "survivors": survivors}
        strag = self.stragglers()
        if strag:
            return {"action": "mitigate_stragglers", "hosts": strag}
        return {"action": "continue"}

    def remove_hosts(self, hosts: List[int]):
        for h in hosts:
            self.hosts.pop(h, None)
