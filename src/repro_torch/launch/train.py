"""Training driver: config registry -> model -> synthetic data (+prefetch)
-> mixed-precision train step -> tier-3 training detectors (--profile).

    python -m repro_torch.launch.train --arch qwen3-1.7b --profile

trains qwen3-1.7b at its published width from random weights (seeded) on
the CUDA device; ``--device cpu`` runs on the CPU (with ``--smoke``, the
reduced config). Without CUDA and without ``--device cpu`` it raises.

Port of src/repro/launch/train.py. Not ported yet (ROADMAP A6): the
checkpoint options ``--ckpt-dir``/``--resume`` and the ``FleetMonitor``
heartbeat (A11), ``--waste-report`` (tier 2, A10), ``--objects`` (A9),
``--strategy`` (A11) and ``--remat`` other than none.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ProfilerConfig, TrainConfig
from repro_torch.core.detectors import TrainingDetectors
from repro_torch.core.findings import merge_profiles
from repro_torch.core.report import dump_json
from repro_torch.core.sarif import write_sarif
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import stream
from repro_torch.launch.serve import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.train import state as TS
from repro_torch.train.step import make_train_step


LOG_EVERY = 10


def run(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, profile: bool = False,
        microbatches: int = 1, seed: int = 0,
        profile_out: Optional[str] = None, sarif_out: Optional[str] = None,
        device: str = "cuda"):
    """Train ``steps`` steps on seeded synthetic batches. Returns
    ``(losses, merged profile or None)``: the per-step losses as floats,
    and with ``profile`` the tier-3 training findings."""
    dev = resolve_device(device)
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=lr, total_steps=steps,
                     warmup_steps=max(steps // 10, 1),
                     microbatches=microbatches, remat="none", seed=seed)
    step_fn = make_train_step(model, tc)
    state = TS.create(model, seed, device=dev)
    detectors = (TrainingDetectors(ProfilerConfig(enabled=True))
                 if profile else None)
    data = Prefetcher(stream(cfg, batch, seq, seed=seed))

    losses = []
    t_start = time.time()
    for step in range(steps):
        b = next(data)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if detectors:
            detectors.on_batch(step, b)
            params_before = state.params
        state, metrics = step_fn(state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        if detectors:
            detectors.on_step(step, params_before, state.params)
            del params_before
        if (step + 1) % LOG_EVERY == 0 or step == 0:
            print(f"[train] step {step+1:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
    data.close()
    dt = time.time() - t_start
    print(f"[train] done: {steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    merged = merge_profiles([detectors.report]) if detectors else None
    if merged is not None:
        print(merged.render(top_k=5))
        if profile_out:
            dump_json(merged, profile_out)
            print(f"[train] waste profile written to {profile_out}")
        if sarif_out:
            write_sarif(merged, sarif_out)
            print(f"[train] SARIF findings written to {sarif_out}")
    return losses, merged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-out", default=None,
                    help="write the merged waste profile as JSON")
    ap.add_argument("--sarif-out", default=None,
                    help="write the merged waste profile as SARIF 2.1.0")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    a = ap.parse_args()
    run(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch, seq=a.seq,
        lr=a.lr, profile=a.profile, microbatches=a.microbatches,
        seed=a.seed, profile_out=a.profile_out, sarif_out=a.sarif_out,
        device=a.device)


if __name__ == "__main__":
    main()
