"""Production dry run: one rank of the 16 x 16 (or 2 x 16 x 16) mesh,
traced on fake tensors at its rank-local shapes, for every (arch x
shape) cell.

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k,prefill_32k,decode_32k --mesh single

Port of src/repro/launch/dryrun.py. The reference compiles each cell for
a 512-device host mesh and reads XLA's cost and memory analyses. Here
one rank of the mesh (rank 0; a ``Mesh`` with no processes,
launch/mesh.py) traces its own step (``core/graph_trace.py``): its
shares of the parameters, optimizer state, batch and cache, cut by the
strategy's specs, every collective a node of the trace
(sharding/comm.py), every kernel one node (kernels/traced.py). Nothing is
allocated on the device and no kernel is built or launched, whatever
the widths: the fake tensors claim the card (``--device``, default
cuda) or the CPU (``--device cpu``). What each cell traces:

  * train: the train step under ``--strategy`` (dp_tp or fsdp) and
    ``--remat`` on the rank's rows (``train/step.py:rank_batch``);
  * prefill: the forward (``make_eval_step``) under the strategy (dp_tp
    for tp_serve, as the reference);
  * decode: one tp_serve serve step (``make_serve_step``) over the
    rank's chunk of the dense cache, weight-gathered when a 'model'
    rank's share of the bf16 weights passes ``_SERVE_WG_BYTES`` (the
    reference's rule). An eager trace unrolls the layers, so every
    decode cell traces what the reference's ``--decode-unroll`` compiles
    and the flag is not taken.

Each record has the reference's keys where the port has the quantity:
``status``, ``trace_s`` (in place of ``compile_s``), ``memory`` (the
rank's argument, output and peak temporary bytes, the last an estimate:
``trace_memory``), ``flops_per_device`` and the roofline terms of
``launch/roofline.py:analyze_traced`` (``dominant``,
``roofline_fraction``): a model of the mesh's cards, not a measurement.
A cell that raises records ``status: "error"`` with the message; a
cell the assignment skips records ``status: "skipped"``. Every family
traces under both training strategies. Records are written as
JSON under ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES_BY_NAME, TrainConfig
from repro_torch.core.graph_trace import abstract_mode, trace_step
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.zoo import build_model, model_flops_per_token
from repro_torch.serve.decode import make_serve_step, shard_params
from repro_torch.sharding.ctx import sharding_ctx
from repro_torch.sharding.rules import make_strategy, shard_tree
from repro_torch.train import state as TS
from repro_torch.train.step import make_eval_step, make_train_step, rank_batch

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# bf16 TP-16 weights above this no longer fit a card alongside the KV
# cache -> serve weight-gathered (the reference's rule)
_SERVE_WG_BYTES = 12e9


def _storages(val):
    """(storage key, the bytes of it this tensor spans) of each tensor
    in ``val``."""
    if isinstance(val, torch.Tensor):
        span = 0
        if val.numel():
            span = val.storage_offset() + 1 + sum(
                (n - 1) * s for n, s in zip(val.shape, val.stride()))
        yield (StorageWeakRef(val.untyped_storage()).cdata,
               span * val.element_size())
    elif isinstance(val, (tuple, list)):
        for v in val:
            yield from _storages(v)


def trace_memory(traced) -> Dict[str, int]:
    """A rank's bytes by the trace: its arguments' storages
    (``argument_size_in_bytes``), the outputs' storages that are not
    arguments' (``output_size_in_bytes``) and the peak of the storages
    alive at once that are not arguments' (``temp_size_in_bytes``, the
    outputs among them); a storage counts the bytes its tensors span. The
    peak is
    an estimate from a liveness pass: a storage lives from the node that
    makes it to its last reader (an output's to the end); views share
    their base's; the caching allocator's rounding and reuse, and tensors
    Python keeps alive past their last use, are not modelled."""
    nodes = list(traced.graph.nodes)
    size, born, last, args = {}, {}, {}, set()
    end = len(nodes)
    for i, node in enumerate(nodes):
        for a in node.all_input_nodes:
            for key, _ in _storages(a.meta.get("val")):
                last[key] = i
        if node.op == "output":
            for a in node.all_input_nodes:
                for key, _ in _storages(a.meta.get("val")):
                    last[key] = end
            continue
        for key, nbytes in _storages(node.meta.get("val")):
            # a storage's bytes: the most that any of its tensors spans
            # (an argument may be a view into a larger one)
            size[key] = max(size.get(key, 0), nbytes)
            if key in born:
                continue
            born[key] = i
            last.setdefault(key, i)
            if node.op in ("placeholder", "get_attr"):
                args.add(key)
    outs = {key for key, at in last.items() if at == end} - args
    deltas = [0] * (end + 2)
    for key in size:
        if key in args:
            continue
        deltas[born[key]] += size[key]
        deltas[last[key] + 1] -= size[key]
    live = peak = 0
    for d in deltas:
        live += d
        peak = max(peak, live)
    out = {"argument_size_in_bytes": sum(size[k] for k in args),
           "output_size_in_bytes": sum(size[k] for k in outs),
           "temp_size_in_bytes": peak}
    out["total_per_device"] = (out["argument_size_in_bytes"]
                               + out["temp_size_in_bytes"])
    return out


def _own(tree):
    """Each tensor of a tree as a tensor of its own. The cells' inputs are
    cut from whole fake leaves, and a cut can be a view: its storage
    would span (and ``trace_memory`` count) most of the whole leaf."""
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                    tree)


def _rows(batch, strat):
    """The rank's rows of a global batch (whole when the batch does not
    divide the batch axes, as the reference's replicated spec)."""
    n = strat.mesh.axis_size(strat.batch_axes)
    if batch["tokens"].shape[0] % n:
        return batch
    return _own(rank_batch(batch, strat))


def _leaf_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool, strategy_name: str,
             remat: str = "full", *, device: str = "cuda",
             smoke: bool = False,
             mesh: Optional[Mesh] = None) -> dict:
    """One cell's record (module docstring). ``mesh``: the rank to trace
    on another mesh than the production one (e.g. a (2, 2) mesh at
    ``rank``); ``smoke``: the arch's reduced config."""
    cfg = registry.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = registry.cell_applicable(cfg, shape)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(n) for n in mesh.shape.values()),
           "rank": mesh.rank, "strategy": strategy_name, "remat": remat}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    model = build_model(cfg)
    mode = abstract_mode()
    bf16 = torch.bfloat16
    t0 = time.time()
    if shape.kind == "train":
        strat = make_strategy(strategy_name, mesh)
        step = make_train_step(model, TrainConfig(remat=remat), strat)
        state = TS.shard_state(TS.abstract(model, device=device, mode=mode),
                               model, strat)
        batch = _rows(SP.batch_specs(cfg, shape, mode=mode, device=device),
                      strat)
        traced = trace_step(step, state, batch)
        # 6*N per token already counts the forward and the backward
        mf = model_flops_per_token(cfg) * shape.tokens
    elif shape.kind == "prefill":
        strat = make_strategy(strategy_name if strategy_name != "tp_serve"
                              else "dp_tp", mesh)
        params = _own(shard_tree(model.abstract_params(
            device=device, mode=mode, dtype=bf16), strat.param_specs(model),
            mesh))
        batch = _rows(SP.batch_specs(cfg, shape, mode=mode, device=device),
                      strat)
        eval_step = make_eval_step(model, strat)
        traced = trace_step(lambda p, b: eval_step(p, b)[0], params, batch)
        # forward only: 2N of the 6N convention
        mf = model_flops_per_token(cfg) / 3.0 * shape.tokens
    else:
        params_bytes = 2 * model_flops_per_token(cfg) / 6.0
        wg = (params_bytes / mesh.shape["model"]) > _SERVE_WG_BYTES
        strat = make_strategy("tp_serve", mesh, weight_gathered=wg)
        rec["weight_gathered"] = bool(wg)
        whole, cache_all, _ = SP.decode_inputs(model, cfg, shape, mode=mode,
                                               device=device)
        local, step_params = shard_params(model, strat, whole)
        with sharding_ctx(strat.sharder()):
            _, cache, tokens = SP.decode_inputs(model, cfg, shape, mode=mode,
                                                device=device, params=local)
        traced = trace_step(make_serve_step(model, strat), step_params,
                            cache, tokens)
        # one token per sequence, forward only
        mf = model_flops_per_token(cfg) / 3.0 * shape.global_batch
        # decode ideal: every weight byte and cache byte read once
        rec["min_bytes_global"] = params_bytes + _leaf_bytes(cache_all)
    trace_s = time.time() - t0
    terms = RL.analyze_traced(traced, mesh, mf,
                              rec.get("min_bytes_global", 0.0))
    rec.update(status="ok", trace_s=round(trace_s, 2),
               memory=trace_memory(traced), nodes=traced.nodes,
               kernel_nodes=dict(sorted(traced.kernel_nodes().items())),
               kernel_ideal_bytes_global=(RL.ideal_kernel_bytes(cfg, shape)
                                          if shape.kind != "decode"
                                          else 0.0),
               **terms)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run driver")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="dp_tp",
                    help="train/prefill strategy (decode always tp_serve)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the fake tensors claim (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = (list(SHAPES_BY_NAME) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = (f"{arch}_{shape}_{'multi' if mp else 'single'}_"
                        f"{args.tag}.json")
                path = OUT_DIR / name
                if path.exists() and not args.force:
                    print(f"[skip existing] {name}", flush=True)
                    continue
                print(f"[dryrun] {arch} x {shape} x "
                      f"{'2x16x16' if mp else '16x16'} ({args.strategy})",
                      flush=True)
                try:
                    rec = run_cell(arch, shape, mp, args.strategy,
                                   args.remat, device=args.device,
                                   smoke=args.smoke)
                except Exception as e:  # record failures: they are bugs
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "strategy": args.strategy, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                rec["tag"] = args.tag
                path.write_text(json.dumps(rec, indent=2))
                status = rec.get("status")
                extra = (f" dominant={rec.get('dominant')} "
                         f"rf={rec.get('roofline_fraction', 0):.3f} "
                         f"trace={rec.get('trace_s')}s"
                         if status == "ok"
                         else rec.get("reason") or rec.get("error", ""))
                print(f"  -> {status} {extra}", flush=True)
                results.append(rec)
    n_ok = sum(r.get("status") == "ok" for r in results)
    print(f"done: {n_ok} ok / {len(results)} attempted", flush=True)


if __name__ == "__main__":
    main()
