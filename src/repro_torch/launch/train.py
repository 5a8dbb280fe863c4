"""Training driver: config registry -> model -> synthetic data (+prefetch)
-> mixed-precision train step -> checkpointing (atomic, async) -> fault
monitor -> tier-3 training detectors (--profile).

    python -m repro_torch.launch.train --arch qwen3-1.7b --profile

trains qwen3-1.7b at its published width from random weights (seeded) on
the CUDA device; ``--device cpu`` runs on the CPU (with ``--smoke``, the
reduced config). Without CUDA and without ``--device cpu`` it raises.

``--objects`` registers the master, compute and moment trees in an
object registry (core/objects.py) and runs the replica scan at init
(core/replicas.py), where the zero moments are bit-identical.

``--waste-report`` traces one train step abstractly before training
(``core/graph_trace.py``: fake tensors of the state's and the batch's
shapes; the forward, the backward and, under remat, the recompute),
prints its tier-2 ``summary()`` and merges the tier-2 profile into the
report (``--profile-out``). Under a strategy each rank traces its own
step on its rows, its collectives nodes of the trace.

``--ckpt-dir`` saves the state every ``--ckpt-every`` steps (async) and
at the end (checkpoint/checkpointer.py); ``--resume`` restarts from its
latest step, and ``total_steps`` fixes the LR schedule's horizon apart
from how many steps one invocation runs, so 2 steps, a save and a resume
of 2 more give the losses of 4 straight steps. Every step heartbeats a
``FleetMonitor`` (runtime/fault.py); its ``plan()`` aborting ends the run.

``run(strategy="dp_tp" | "fsdp", mesh=...)`` trains sharded: called on
every rank of a joined mesh (``launch.mesh.launch``), each rank holds
its share of the state (``train/state.py:create``), takes its rows of
the same seeded global batch (``train/step.py:rank_batch``) and runs
the sharded step; its detectors see the global batch and count each
watched leaf whole. A checkpoint holds whole leaves, gathered leaf by
leaf and written by rank 0 in the unsharded layout, and a resume cuts
each rank's share from it, so either restores in the other. Rank 0
prints the ``[train]`` lines; every rank returns the losses and its
merged profile. Without a mesh, a strategy runs on the one-rank host
mesh, as in the reference. ``--strategy`` stays out of ``main``, as in
the reference.

Port of src/repro/launch/train.py.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import ProfilerConfig, TrainConfig
from repro_torch.core.detectors import TrainingDetectors
from repro_torch.core.findings import merge_profiles
from repro_torch.core.graph_trace import abstract_mode, trace_step
from repro_torch.core.graph_waste import analyze_waste
from repro_torch.core.objects import ObjectRegistry
from repro_torch.core.replicas import ReplicaDetector
from repro_torch.core.report import dump_json
from repro_torch.core.sarif import write_sarif
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import stream
from repro_torch.launch.serve import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.runtime.fault import FleetMonitor
from repro_torch.train import state as TS
from repro_torch.train.step import make_train_step, rank_batch


LOG_EVERY = 10


def run(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 25, profile: bool = False,
        waste_report: bool = False, resume: bool = False,
        microbatches: int = 1, remat: str = "none", seed: int = 0,
        strategy: Optional[str] = None, total_steps: Optional[int] = None,
        profile_out: Optional[str] = None, sarif_out: Optional[str] = None,
        objects: bool = False, device: str = "cuda", mesh=None):
    """Train up to step ``steps`` (from 0, or from the latest checkpoint
    in ``ckpt_dir`` with ``resume``) on seeded synthetic batches. Returns
    ``(losses, merged profile or None)``: this run's per-step losses as
    floats, and with ``profile`` the tier-3 training findings, with
    ``waste_report`` the tier-2 findings of the traced step (with
    ``objects`` the replica scan at init), merged. With ``strategy``
    ("dp_tp" or "fsdp") the step is sharded over ``mesh`` (this rank's
    view of a joined mesh; None: the one-rank host mesh), on the mesh's
    device when it has one."""
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    strat, rank0 = None, True
    if strategy:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.sharding.rules import make_strategy
        if strategy not in ("dp_tp", "fsdp"):
            raise ValueError(f"strategy {strategy!r}: dp_tp or fsdp")
        mesh = mesh if mesh is not None else make_host_mesh()
        strat = make_strategy(strategy, mesh)
        rank0 = mesh.rank == 0
        if mesh.device is not None:
            device = str(mesh.device)
    dev = resolve_device(device)
    # total_steps fixes the LR schedule's horizon apart from how many
    # steps this invocation runs (checkpoint/restart determinism)
    horizon = total_steps or steps
    tc = TrainConfig(learning_rate=lr, total_steps=horizon,
                     warmup_steps=max(horizon // 10, 1),
                     microbatches=microbatches, remat=remat, seed=seed)
    step_fn = make_train_step(model, tc, strat)
    obj_registry = ObjectRegistry() if objects else None
    state = TS.create(model, seed, device=dev, registry=obj_registry,
                      strategy=strat)
    obj_scan = None
    if obj_registry is not None:
        # scan AT INIT: the moments are all bit-identical zeros here (the
        # in-place updates make them differ after the first step)
        obj_scan = ReplicaDetector(obj_registry).scan()
        print(f"[train] object scan: {len(obj_registry)} live objects, "
              f"{len(obj_scan.findings)} replica groups, "
              f"{sum(f.bytes for f in obj_scan.findings):.0f} "
              f"duplicate bytes")
    start_step = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        state = (ckpt.restore(state) if strat is None else
                 ckpt.restore(TS.abstract(model, device=dev,
                                          mode=abstract_mode()),
                              specs=TS.state_specs(model, strat),
                              mesh=strat.mesh, device=dev))
        start_step = int(state.step)
        if rank0:
            print(f"[train] resumed from step {start_step}")
    tier2 = waste_tier2(cfg, step_fn, state, batch, seq, dev,
                        strat, microbatches, rank0) if waste_report else None
    detectors = None
    if profile:
        detectors = TrainingDetectors(
            ProfilerConfig(enabled=True),
            **({} if strat is None else
               dict(mesh=strat.mesh, specs=strat.param_specs(model))))
    monitor = FleetMonitor(hosts=[0], dead_after=3600.0)
    data = Prefetcher(stream(cfg, batch, seq, seed=seed,
                             start_step=start_step))

    losses = []
    t_start = time.time()
    for step in range(start_step, steps):
        b = next(data)
        mine = b if strat is None else rank_batch(b, strat, microbatches)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in mine.items()}
        if detectors:
            detectors.on_batch(step, b)
            params_before = state.params
        t0 = time.time()
        state, metrics = step_fn(state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.heartbeat(0, time.time() - t0)
        if detectors:
            detectors.on_step(step, params_before, state.params)
            del params_before
        if ckpt and (step + 1) % ckpt_every == 0:
            save_state(ckpt, step + 1, state, strat, model, wait=False)
        if rank0 and ((step + 1) % LOG_EVERY == 0 or step == start_step):
            print(f"[train] step {step+1:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        plan = monitor.plan()
        if plan["action"] == "abort":
            raise RuntimeError(plan["reason"])
    if ckpt:
        save_state(ckpt, steps, state, strat, model, wait=True)
    data.close()
    dt = time.time() - t_start
    if rank0:
        print(f"[train] done: {steps - start_step} steps in {dt:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    parts = [p for p in (detectors.report if detectors else None, tier2,
                         obj_scan) if p is not None]
    merged = merge_profiles(parts) if parts else None
    if merged is not None and rank0:
        print(merged.render(top_k=5))
        if profile_out:
            dump_json(merged, profile_out)
            print(f"[train] waste profile written to {profile_out}")
        if sarif_out:
            write_sarif(merged, sarif_out, src_root=os.getcwd())
            print(f"[train] SARIF findings written to {sarif_out}")
    return losses, merged


def save_state(ckpt: Checkpointer, step: int, state, strat, model, *,
               wait: bool) -> None:
    """Save ``state`` at ``step`` (async unless ``wait``). Under a
    strategy every rank gathers each leaf whole (``TS.gather_state``,
    collectively), rank 0 writes the unsharded layout, and with ``wait``
    every rank returns once it is on disk."""
    if strat is None:
        _write(ckpt, step, state, wait)
        return
    whole = TS.gather_state(state, model, strat)
    if strat.mesh.rank == 0:
        _write(ckpt, step, whole, wait)
    if wait:
        from repro_torch.sharding import comm
        comm.all_reduce(torch.zeros((), device=state.step.device),
                        strat.mesh.axis_names, strat.mesh)


def _write(ckpt: Checkpointer, step: int, state, wait: bool) -> None:
    if wait:
        ckpt.save(step, state)
        ckpt.wait()
    else:
        ckpt.save_async(step, state)


def waste_tier2(cfg, step_fn, state, batch: int, seq: int, dev,
                strat=None, microbatches: int = 1, verbose: bool = True):
    """Tier 2 of one train step, traced on fake tensors of the state's
    and a (batch, seq) batch's shapes — under a strategy this rank's
    step on its share of the state and its rows of the batch
    (``rank_batch``), every collective a node (sharding/comm.py): prints
    the trace line and the ``summary()`` (with ``verbose``), returns the
    tier-2 profile (``meta``: ``trace_s``, ``nodes``,
    ``kernel_nodes``)."""
    from repro_torch.launch.lint import _train_batch
    fake = _train_batch(cfg, batch, seq, mode=abstract_mode(), device=dev)
    if strat is not None:
        fake = rank_batch(fake, strat, microbatches)
    traced = trace_step(step_fn, state, fake)
    rep = analyze_waste(traced)
    if verbose:
        print(f"[train] tier 2 (train step): {traced.nodes} nodes, kernel "
              f"nodes {dict(sorted(traced.kernel_nodes().items()))}; "
              f"traced in {traced.seconds:.2f} s; "
              f"{len(rep.profile.findings)} findings")
        print(rep.summary())
    return rep.profile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--waste-report", action="store_true",
                    help="tier-2 waste report of the traced train step")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"),
                    help="activation checkpointing of each superblock")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-out", default=None,
                    help="write the merged waste profile as JSON")
    ap.add_argument("--sarif-out", default=None,
                    help="write the merged waste profile as SARIF 2.1.0")
    ap.add_argument("--objects", action="store_true",
                    help="register params/opt state in the object "
                         "registry and run the replica scan at init")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    a = ap.parse_args()
    run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
        lr=a.lr, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
        profile=a.profile, waste_report=a.waste_report, resume=a.resume,
        microbatches=a.microbatches,
        remat=a.remat, seed=a.seed, profile_out=a.profile_out,
        sarif_out=a.sarif_out, objects=a.objects, device=a.device)


if __name__ == "__main__":
    main()
