"""Multi-pod dry run: trace every (arch x shape x mesh) cell at full size on
one host.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 placeholder XLA devices.  Here this process is rank 0 of a
fake process group of 256 (``single_pod``) or 512 (``multi_pod``) ranks
(``torch.testing``'s ``FakeStore`` and its ``fake`` backend: every
collective is accepted and moves nothing), the production mesh is built
over it, and rank 0's train step (``make_train_step`` on its slices of
the parameters, ``init_train_state``'s moments and its rows of the batch),
``prefill`` or ``decode_step`` runs once on ``meta`` tensors, which carry
shapes and dtypes and neither memory nor arithmetic, under
``analysis.hlo.analyze``: its flops, bytes and the collectives the port's
wrappers issue, a rank.  What a cell records:

* ``memory.argument_bytes``: rank 0's parameters, optimizer state, batch
  rows and cache; ``output_bytes``: its outputs (the step updates in
  place, so its parameters and moments again); ``temp_bytes``: the most
  bytes the step's own operations held live at once, beyond the
  arguments; ``alias_bytes`` and ``code_bytes`` are 0: PyTorch runs
  eagerly, so nothing is compiled and no buffer is donated.
* ``lower_s``: the trace's seconds; ``compile_s``: 0 (nothing compiles).
* ``hlo_cost``: the reference's keys, from the trace (there is no HLO).
* ``status``: ``ok``; ``skipped`` where ``launch.specs.runnable`` skips
  the cell, for the reference's reasons; ``error`` with its traceback.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out runs/dryrun [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from ..analysis import hlo as hlo_analysis
from ..configs import ARCH_IDS, get_config
from ..configs.base import SHAPES, TrainConfig, shape_by_name
from ..distributed.parallel import Parallel
from ..distributed.sharding import (batch_axes, batch_shardings,
                                    cache_specs, local_slices, mesh_shape,
                                    param_shardings, shard_tree)
from ..models import build
from ..train.train_loop import (batch_layout, init_train_state,
                                make_train_step)
from . import specs as S
from .mesh import make_production_mesh, PRODUCTION_MESHES

MESHES = {"single_pod": False, "multi_pod": True}


def init_fake_group(multi_pod: bool) -> None:
    """Make this process rank 0 of a fake group of the production mesh's
    size (any group of this process is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    shape, _ = PRODUCTION_MESHES[multi_pod]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))


def _rows(batch: dict, shardings: dict) -> dict:
    """The rank's rows of each array of a ``meta`` batch."""
    return {k: v[shardings[k].slices(v.shape)] for k, v in batch.items()}


def _tensor_axes(cfg, shape, mesh):
    """A batch-starved decode (a batch the data axes do not divide, as
    long_500k's B = 1) would repeat its work on every data rank: the SSM
    family's tensor dims go over (data x model) instead, where its dims
    divide the whole product (the reference's gate: partial divisibility
    costs more than it saves)."""
    sizes = mesh_shape(mesh)
    baxes = batch_axes(mesh)
    n_batch = math.prod(sizes[a] for a in baxes)
    n_total = n_batch * sizes["model"]
    fits_2d = (cfg.family == "ssm" and cfg.d_inner % n_total == 0
               and cfg.vocab_size % n_total == 0)
    if shape.global_batch % n_batch != 0 and fits_2d:
        return tuple(baxes) + ("model",)
    return "model"


def lower_cell(arch: str, shape_name: str, mesh, *, tc: TrainConfig,
               cfg_overrides: dict | None = None):
    """Build one cell on ``meta``: returns (fn, args, meta), ``fn(*args)``
    being rank 0's step; fn is None for a skipped cell.  ``cfg_overrides``
    re-traces the same cell with e.g. {"fused_qkv": True}."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape_by_name(shape_name)
    ok, why = S.runnable(cfg, shape)
    if not ok:
        return None, (), {"status": "skipped", "reason": why}

    bundle = build(cfg, device=S.META)
    p_shape = S.params_shape(bundle)
    tp = mesh_shape(mesh)["model"]

    if shape.kind == "train":
        params, opt = init_train_state(p_shape, tc, mesh)
        batch = S.input_specs(cfg, shape)
        rows = _rows(batch, batch_layout(tc, mesh)(batch, mesh))
        step = make_train_step(bundle, tc, mesh)
        return step, (params, opt, rows), {"status": "ok"}

    if shape.kind == "prefill":
        # the layout is built once, outside the step, as a server builds
        # it: its meta parameter tree (names and shapes) is no step work
        par = Parallel(mesh, cfg, "tp")
        params = shard_tree(p_shape, param_shardings(p_shape, mesh))
        batch = S.input_specs(cfg, shape)
        rows = _rows(batch, batch_shardings(batch, mesh))

        def prefill_fn(params, b):
            return bundle.prefill(params, b, mesh=par, tp=tp,
                                  max_len=shape.seq_len)
        return prefill_fn, (params, rows), {"status": "ok"}

    # decode
    tensor_axes = _tensor_axes(cfg, shape, mesh)
    par = Parallel(mesh, cfg, "tp", tensor_axes=tensor_axes)
    params = shard_tree(p_shape, param_shardings(p_shape, mesh,
                                                 tensor_axes=tensor_axes))
    cache = S.cache_shape(bundle, cfg, shape, tp, p_shape=p_shape)
    c_specs = cache_specs(cache, mesh, tensor_axes=tensor_axes)
    cache = {k: v[local_slices(c_specs[k], v.shape, mesh)] if c_specs[k]
             else v for k, v in cache.items()}
    token = S.token_specs(cfg, shape)
    token = _rows({"token": token}, batch_shardings({"token": token},
                                                    mesh))["token"]

    def serve_step(params, c, tok):
        return bundle.decode_step(params, c, tok, mesh=par)
    return serve_step, (params, cache, token), {
        "status": "ok", "tensor_axes": list(par.axes)}


def trace_cell(arch: str, shape_name: str, mesh, tc: TrainConfig,
               cfg_overrides: dict | None = None) -> dict:
    """One trace of rank 0's step (``lower_cell``) under ``analyze``: its
    counts, flat, and the cell's status."""
    fn, args, meta = lower_cell(arch, shape_name, mesh, tc=tc,
                                cfg_overrides=cfg_overrides)
    if meta["status"] == "skipped":
        return meta
    t0 = time.time()
    out = {}

    def run(*a):
        out["value"] = fn(*a)
        return out["value"]
    cost = hlo_analysis.analyze(run, *args)
    return {**meta, "lower_s": time.time() - t0,
            "argument_bytes": hlo_analysis.nbytes(args),
            "output_bytes": hlo_analysis.nbytes(out["value"]),
            "temp_bytes": cost.peak_temp_bytes,
            "flops": cost.flops, "bytes": cost.bytes,
            "bytes_naive": cost.bytes_naive,
            "collective_bytes": cost.collective_bytes,
            "n_collectives": cost.n_collectives,
            **{f"collective_breakdown/{k}": v
               for k, v in cost.collective_breakdown.items()}}


_COUNTS = ("argument_bytes", "output_bytes", "temp_bytes", "flops", "bytes",
           "bytes_naive", "collective_bytes", "n_collectives")


def depth_points(cfg) -> list[dict]:
    """The depths traced: 1 and 2 layers (an encoder-decoder: (1, 1),
    (2, 1) and (1, 2) encoder and decoder layers)."""
    if cfg.is_encdec:
        return [{"n_enc_layers": 1, "n_layers": 1},
                {"n_enc_layers": 2, "n_layers": 1},
                {"n_enc_layers": 1, "n_layers": 2}]
    return [{"n_layers": 1}, {"n_layers": 2}]


def extrapolate(cfg, traces: list[dict]) -> dict:
    """Every count of the traces at ``depth_points(cfg)`` taken linearly to
    ``cfg``'s depth: a layer is one module, the same at every depth, so a
    count is what the rest of the step costs plus the layer count times
    what one layer costs (the reference's analyzer multiplies a scanned
    layer by its trip count alike)."""
    base, *more = traces
    steps = [cfg.n_layers - 1] if not cfg.is_encdec else \
        [cfg.n_enc_layers - 1, cfg.n_layers - 1]
    keys = set(base) | {k for t in more for k in t}
    counts = [k for k in keys if k in _COUNTS
              or k.startswith("collective_breakdown/")]
    out = {k: v for k, v in base.items() if k not in counts}
    for k in counts:
        v = base.get(k, 0.0)
        for n, t in zip(steps, more):
            v += n * (t.get(k, 0.0) - base.get(k, 0.0))
        out[k] = v
    out["n_collectives"] = int(round(out["n_collectives"]))
    out["lower_s"] = sum(t["lower_s"] for t in traces)
    return out


def analyze_cell(arch: str, shape_name: str, mesh, mesh_name: str,
                 tc: TrainConfig) -> dict:
    """One cell's record: the counts of rank 0's step at the config's full
    depth, from traces at ``depth_points`` (``extrapolate``)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": mesh_shape(mesh), "n_chips": mesh.size(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    try:
        ok, why = S.runnable(cfg, shape)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec
        points = depth_points(cfg)
        got = extrapolate(cfg, [trace_cell(arch, shape_name, mesh, tc, p)
                                for p in points])
        rec.update(status="ok", lower_s=got["lower_s"], compile_s=0.0,
                   traced_depths=points)
        if "tensor_axes" in got:
            rec["tensor_axes"] = got["tensor_axes"]
        rec["memory"] = {
            "argument_bytes": got["argument_bytes"],
            "output_bytes": got["output_bytes"],
            "temp_bytes": got["temp_bytes"],
            "alias_bytes": 0,
            "code_bytes": 0,
        }
        rec["hlo_cost"] = {
            "flops": got["flops"], "bytes": got["bytes"],
            "bytes_naive": got["bytes_naive"],
            "collective_bytes": got["collective_bytes"],
            "collective_breakdown": {
                k.split("/", 1)[1]: v for k, v in got.items()
                if k.startswith("collective_breakdown/")},
            "n_collectives": got["n_collectives"],
        }
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else [
        a.replace("-", "_").replace(".", "_") for a in args.arch.split(",")]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    mesh_names = {"single": ["single_pod"], "multi": ["multi_pod"],
                  "both": ["single_pod", "multi_pod"]}[args.mesh]
    tc = TrainConfig()
    os.makedirs(args.out, exist_ok=True)
    try:
        for mesh_name in mesh_names:
            init_fake_group(MESHES[mesh_name])
            mesh = make_production_mesh(multi_pod=MESHES[mesh_name],
                                        device="cpu")
            for arch in archs:
                for shape_name in shapes:
                    path = os.path.join(
                        args.out, f"{mesh_name}__{arch}__{shape_name}.json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip cached] {path}")
                        continue
                    t0 = time.time()
                    rec = analyze_cell(arch, shape_name, mesh, mesh_name, tc)
                    rec["wall_s"] = time.time() - t0
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    status = rec["status"]
                    extra = ""
                    if status == "ok":
                        extra = (f"trace {rec['lower_s']:.1f}s "
                                 f"flops/dev {rec['hlo_cost']['flops']:.3e} "
                                 f"bytes/dev {rec['hlo_cost']['bytes']:.3e} "
                                 f"coll {rec['hlo_cost']['collective_bytes']:.3e}B")
                    elif status == "error":
                        extra = rec["error"][:160]
                    print(f"[{status}] {mesh_name} {arch} {shape_name} "
                          f"({rec['wall_s']:.1f}s) {extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
