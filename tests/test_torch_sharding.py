"""The port's mesh paths against the JAX package's, on the CPU.

Every case of ``tests/test_sharding.py`` on the port.  The reference runs
its mesh on 8 fake host devices; the port's twin is 8 processes joined by
``torch.distributed`` over gloo (``launch.ranks.RankPool``), started once
for this module with one torch thread each, every case run on that pool
with a hard timeout a call.  Same inputs on both sides: the reference's
weights carried across with ``convert.lm_params_from_jax``, the same numpy
batches and gradients.  Tolerances:

  * the spec rules (``param_specs``, ``zero1_specs``, ``fsdp_param_specs``,
    ``cache_specs``, ``batch_shardings``) on every config, reduced and full,
    over (1,1), (2,4), (4,2) and (2,16,16) stand-in meshes: equal;
  * the (2,4) train step (reduced llama, d_model 64, vocab 256, float32,
    ``tp`` and ``fsdp``, ZeRO-1 on and off) against the reference's
    single-device step: loss and grad norm within 1e-4, parameters within
    1e-4, the reference test's bound (observed ~7e-6: reductions in other
    orders);
  * expert-parallel MoE forward against the fallback and the reference:
    1e-4; the elastic (4,2) -> (2,4) restore: exact, files byte-equal;
  * compressed psum: bf16 within 0.05 relative, int8 within 0.05 a step
    and the 20-step error-feedback mean within 0.02 (the reference test's
    bounds); int8 against the reference's ``compressed_psum`` on 8 fake
    devices fed the same per-rank gradients: within 1e-6 x max|sum| (the
    int32 sums are exact on both sides; only the float32 scale's last bit
    may differ).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.distributed import sharding as ref_sh
from repro.launch import specs as ref_specs
from repro.models import build as ref_build
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.train.train_loop import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.configs.base import ShapeCell, TrainConfig
from repro_torch.convert import reference_path
from repro_torch.data.synthetic import token_batches
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.parallel import Parallel
from repro_torch.launch import specs as t_specs
from repro_torch.launch.mesh import (PRODUCTION_MESHES, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.ranks import RankPool
from repro_torch.models import build
from repro_torch.models import transformer as t_tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_loop import (init_train_state, jit_train_step,
                                          loss_and_grads, make_train_step,
                                          train_state_shardings)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _stand_in(shape, axes):
    """A mesh both packages' rules accept without devices."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _flat(tree) -> dict:
    leaves, _ = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {ref_sh._path_str(p): x for p, x in leaves}


@pytest.fixture(scope="module")
def pool():
    """Eight gloo ranks on the CPU, one torch thread each."""
    p = RankPool(WORLD, device="cpu", threads=1, timeout=60)
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the spec rules ------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, size):
    """Shapes only: every spec rule, on every mesh, equals the
    reference's; so do the shape stand-ins they read."""
    rcfg, tcfg = ref_get_config(arch), get_config(arch)
    if size == "reduced":
        rcfg, tcfg = ref_reduced(rcfg), reduced(tcfg)
    rb, tb = ref_build(rcfg), build(tcfg, device="cpu")
    rps, tps = ref_specs.params_shape(rb), t_specs.params_shape(tb)
    assert all(p.device.type == "meta" for p in tps.parameters())
    want_shapes = {k: (tuple(v.shape), str(v.dtype))
                   for k, v in _flat(rps).items()}
    got = sh.stacked_shapes(tps)
    dtypes = {reference_path(n)[0]: str(p.dtype).removeprefix("torch.")
              for n, p in tps.named_parameters()}
    assert want_shapes == {k: (v, dtypes[k]) for k, v in got.items()}
    cell = ShapeCell("cell", 64, 8, "decode")
    for key, fn in (("input", ref_specs.input_specs),
                    ("token", ref_specs.token_specs)):
        want = fn(rcfg, cell)
        have = getattr(t_specs, f"{key}_specs")(tcfg, cell)
        want, have = (_flat(want), have) if key == "input" else \
            ({"x": want}, {"x": have})
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in have.items()}
    for name in ("train_4k", "long_500k"):
        from repro.configs.base import shape_by_name
        assert t_specs.runnable(tcfg, shape_by_name(name)) == \
            ref_specs.runnable(rcfg, shape_by_name(name))
    batch = ref_specs.input_specs(rcfg, cell)
    for shape, axes in MESHES:
        m = _stand_in(shape, axes)
        for rule in ("param_specs", "zero1_specs", "fsdp_param_specs"):
            assert getattr(sh, rule)(tps, m) == \
                _flat(getattr(ref_sh, rule)(rps, m)), (rule, shape)
        rcache = ref_specs.cache_shape(rb, rcfg, cell, shape[-1])
        tcache = t_specs.cache_shape(tb, tcfg, cell, shape[-1])
        assert {k: tuple(v.shape) for k, v in _flat(rcache).items()} == \
            {k: tuple(v.shape) for k, v in tcache.items()}
        assert sh.cache_specs(tcache, m) == _flat(ref_sh.cache_specs(
            rcache, m))
        # the reference wraps each spec in a NamedSharding of a real mesh
        ref_batch = ref_sh._maybe_batch
        want = {k: (ref_batch(v.shape[0], ref_sh.batch_axes(m), m),
                    *([None] * (len(v.shape) - 1))) for k, v in batch.items()}
        got = {k: s.spec for k, s in sh.batch_shardings(
            t_specs.input_specs(tcfg, cell), m).items()}
        assert got == want
        assert sh.batch_spec(m) == ref_sh.batch_spec(m)


def test_spec_rules_on_known_leaves():
    """The reference test's own spot checks, on a (2,4) stand-in: experts
    and heads shard, hymba's kv=2 does not divide 4, ZeRO-1 adds data."""
    m = _stand_in((2, 4), ("data", "model"))
    shapes = t_specs.params_shape(build(reduced(get_config(
        "qwen3_moe_30b_a3b")), device="cpu"))
    specs = sh.param_specs(shapes, m)
    assert specs["embed"] == jax.sharding.PartitionSpec("model", None)
    assert specs["layers/moe/e_gate"] == (None, "model", None, None)
    assert specs["layers/attn/wq"][2] == "model"
    assert specs["layers/ln1"] == ()
    specs2 = sh.param_specs(t_specs.params_shape(build(reduced(get_config(
        "hymba_1_5b")), device="cpu")), m)
    assert specs2["layers/attn/wk"][2] is None
    assert specs2["layers/ssm/in_proj"][2] == "model"
    z = sh.zero1_specs(shapes, m)
    assert z["layers/ln1"] == ("data", None)       # the layer axis, L = 2
    assert z["embed"] == ("model", "data")


def test_local_slices_place_blocks_as_jax_does():
    m = _stand_in((2, 16, 16), ("pod", "data", "model"))
    spec = (("pod", "data"), "model")
    got = sh.local_slices(spec, (64, 32), m, {"pod": 1, "data": 3,
                                             "model": 5})
    assert got == (slice(38, 40), slice(10, 12))   # block 1 * 16 + 3 = 19
    with pytest.raises(ValueError, match="does not split"):
        sh.local_slices(("model",), (30,), m, {"pod": 0, "data": 0,
                                               "model": 0})


def test_param_specs_rules_single_device():
    """Divisor rule on a one-device mesh (a one-rank group of this
    process): nothing shards."""
    import torch.distributed as dist
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        assert sh.axis_names(mesh) == ("data", "model")
        assert sh.mesh_shape(mesh) == {"data": 1, "model": 1}
        shapes = t_specs.params_shape(build(reduced(get_config(
            "llama3_2_1b")), device="cpu"))
        specs = sh.param_specs(shapes, mesh)
        assert len(specs) == len(sh.stacked_shapes(shapes))
        assert all(all(a is None for a in s) for s in specs.values())
    finally:
        dist.destroy_process_group()


def test_production_mesh_shapes():
    assert PRODUCTION_MESHES[False] == ((16, 16), ("data", "model"))
    assert PRODUCTION_MESHES[True] == ((2, 16, 16), ("pod", "data", "model"))


def test_mesh_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        make_host_mesh(1, 1)


# -- the rank side (module-level: the pool pickles them by name) -------------

def _llama_cfg(**changes):
    return dataclasses.replace(
        reduced(get_config("llama3_2_1b"), d_model=changes.pop("d_model", 64),
                vocab=changes.pop("vocab", 256)), dtype="float32",
        param_dtype="float32", **changes)


def _moe_cfg(**changes):
    return dataclasses.replace(reduced(get_config("qwen3_moe_30b_a3b")),
                               dtype="float32", param_dtype="float32",
                               capacity_factor=64.0, **changes)


def _np_tree(tree) -> dict:
    return {n: p.detach().numpy().copy() for n, p in tree.named_parameters()}


def _r_meshes(data, model):
    mesh = make_host_mesh(data, model, device="cpu")
    bad = []
    for make in (lambda: make_host_mesh(4, 4, device="cpu"),
                 lambda: make_host_mesh(1, 1, device="cpu"),
                 lambda: make_production_mesh(device="cpu"),
                 lambda: make_production_mesh(multi_pod=True, device="cpu")):
        try:
            make()
        except ValueError as e:
            bad.append(str(e))
    return {"names": sh.axis_names(mesh), "shape": sh.mesh_shape(mesh),
            "coord": sh.coordinate(mesh), "bad": bad}


def _r_step(tree, cfg_changes, shape, mode, zero1, batch, lr):
    cfg = _llama_cfg(**cfg_changes)
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=lr, sharding_mode=mode,
                     zero1=zero1)
    params, opt = init_train_state(
        convert.lm_params_from_jax(tree, cfg, "cpu"), tc, mesh)
    before = col.counters()
    params, opt, m = jit_train_step(bundle, tc, mesh)(params, opt, batch)
    after = col.counters()
    return {"params": _np_tree(params), "mu": _np_tree(opt.mu),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "coord": sh.coordinate(mesh),
            "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


def _r_moe(tree, shape, batch, cfg_changes=None):
    from repro_torch.data.loader import device_placer
    cfg = _moe_cfg(**(cfg_changes or {}))
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    local = sh.shard_tree(params, sh.param_shardings(params, mesh))
    rows = device_placer(mesh, sh.batch_shardings)(batch)
    before = col.counters()
    logits = bundle.forward(local, rows, mesh=mesh)
    after = col.counters()
    return {"logits": logits.numpy(), "rows": sh.batch_shardings(
        batch, mesh)["tokens"].slices(batch["tokens"].shape)[0],
        "held": sum(p.numel() for p in local.parameters()),
        "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


def _r_grads(tree, shape, mode, zero1, batch):
    """The gradients a (2,4) step hands its update on this rank."""
    from repro_torch.train.train_loop import mesh_gradients
    cfg = _llama_cfg()
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(sharding_mode=mode, zero1=zero1)
    params, _ = init_train_state(
        convert.lm_params_from_jax(tree, cfg, "cpu"), tc, mesh)
    return [(name, sl, g.numpy()) for name, sl, g in mesh_gradients(
        build(cfg, device="cpu"), tc, mesh, params, batch)]


def _r_manager_wait(workdir, async_save, slow_s):
    """Every rank saves step 1 through a sharded ``CheckpointManager``,
    rank 0's write held back ``slow_s``; after ``wait()`` each rank looks
    for the committed directory."""
    import time
    cfg = _llama_cfg()
    mesh = make_host_mesh(2, 4, device="cpu")
    tc = TrainConfig()
    full = build(cfg, device="cpu").init(0)
    p_sh, o_sh = train_state_shardings(full, tc, mesh)
    params, opt = init_train_state(full, tc, mesh)
    save = ckpt.save_checkpoint

    def slow_save(*args, **kwargs):
        time.sleep(slow_s)
        return save(*args, **kwargs)
    ckpt.save_checkpoint = slow_save
    try:
        m = ckpt.CheckpointManager(workdir, every=1, async_save=async_save,
                                   shardings={"params": p_sh, "opt": o_sh})
        m.maybe_save(1, {"params": params, "opt": opt})
        m.wait()
    finally:
        ckpt.save_checkpoint = save
    return ckpt.committed_steps(workdir)


def _r_moe_step(tree, batch, lr):
    cfg = _moe_cfg()
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(1, WORLD, device="cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=lr)
    params, opt = init_train_state(
        convert.lm_params_from_jax(tree, cfg, "cpu"), tc, mesh)
    params, opt, m = jit_train_step(bundle, tc, mesh)(params, opt, batch)
    return {"params": _np_tree(params), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "coord": sh.coordinate(mesh)}


def _r_save(tree, shape, zero1, batch, d):
    """A ZeRO-1 step on ``shape`` (moments with the layer axis over data),
    then a sharded save at step 7."""
    cfg = _llama_cfg()
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3, zero1=zero1)
    params, opt = init_train_state(
        convert.lm_params_from_jax(tree, cfg, "cpu"), tc, mesh)
    params, opt, _ = jit_train_step(bundle, tc, mesh)(params, opt, batch)
    p_sh, o_sh = train_state_shardings(params_full_shape(cfg), tc, mesh)
    ckpt.save_checkpoint(d, 7, {"params": params, "opt": opt},
                         shardings={"params": p_sh, "opt": o_sh})
    return {"held": [p.numel() for p in opt.mu.parameters()]}


def params_full_shape(cfg):
    return t_specs.params_shape(build(cfg, device="cpu"))


def _r_restore(shape, zero1, src, dst):
    """Restore step 7 onto ``shape`` (another mesh), then save it again."""
    cfg = _llama_cfg()
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(zero1=zero1)
    p_sh, o_sh = train_state_shardings(params_full_shape(cfg), tc, mesh)
    target = dict(zip(("params", "opt"), init_train_state(
        build(cfg, device="cpu").init(3), tc, mesh)))
    shardings = {"params": p_sh, "opt": o_sh}
    step, state = ckpt.restore_checkpoint(src, target, shardings=shardings)
    ckpt.save_checkpoint(dst, step, state, shardings=shardings)
    return {"step": step, "params": _np_tree(state["params"]),
            "coord": sh.coordinate(mesh)}


def _r_psum(g_all, mode, steps):
    mesh = make_host_mesh(WORLD, 1, device="cpu")
    r = sh.coordinate(mesh)["data"]
    grads = {"w": torch.from_numpy(g_all[r])}
    err = col.init_error_feedback(grads) if mode == "int8" else None
    outs = []
    for _ in range(steps):
        out, err = col.compressed_psum(grads, mode, ("data",), err,
                                       mesh=mesh)
        outs.append(out["w"].numpy())
    return outs


def _r_collectives(x):
    mesh = make_host_mesh(2, 4, device="cpu")
    c = sh.coordinate(mesh)
    r = c["data"] * 4 + c["model"]
    before = col.counters()
    t = torch.from_numpy(x) * (r + 1)
    summed = col.all_reduce(t.clone(), mesh, "model")
    peak = col.all_reduce(t.clone(), mesh, ("data", "model"), "max")
    gathered = col.all_gather(t, mesh, "model", 1)
    scattered = col.reduce_scatter(t, mesh, "data", 0)
    strided = t.t().clone().t()[:, ::2]              # not contiguous
    col.all_reduce(strided, mesh, "model")
    after = col.counters()
    return {"r": r, "coord": c, "sum": summed.numpy(), "max": peak.numpy(),
            "gather": gathered.numpy(), "scatter": scattered.numpy(),
            "strided": strided.numpy(),
            "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


def _r_placer(batch, mode):
    from repro_torch.data.loader import device_placer
    from repro_torch.train.train_loop import batch_layout
    mesh = make_host_mesh(2, 4, device="cpu")
    tc = TrainConfig(sharding_mode=mode)
    out = device_placer(mesh, batch_layout(tc, mesh))(batch)
    return {k: v.numpy() for k, v in out.items()}


def _r_train_loop(workdir, shape, steps, stop_after, batches):
    from repro_torch.train.train_loop import TrainLoop
    cfg = _llama_cfg()
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(total_steps=steps, checkpoint_every=2,
                     keep_checkpoints=1, warmup_steps=1, learning_rate=1e-3)
    loop = TrainLoop(bundle, tc, None, workdir, mesh=mesh,
                     log=lambda *_: None)

    def data():
        for i, b in enumerate(batches):
            if i == stop_after:
                loop.stop()
            yield b
    loop.data = data()
    out = loop.run()
    return {"losses": out["losses"], "params": _np_tree(out["params"]),
            "coord": sh.coordinate(mesh)}


# -- the parent side -----------------------------------------------------------

def _small_ref(**changes):
    d, v = changes.pop("d_model", 64), changes.pop("vocab", 256)
    return dataclasses.replace(
        ref_reduced(ref_get_config("llama3_2_1b"), d_model=d, vocab=v),
        dtype="float32", param_dtype="float32", **changes)


def _ref_tree(rcfg, seed=0):
    return jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(seed)))


def _per_layer(tree: dict, cfg) -> dict:
    """The reference's stacked numpy tree -> the port's leaves by name."""
    model = convert.lm_params_from_jax(tree, cfg, "cpu")
    return _np_tree(model)


def _assemble(results, specs: dict, stacked: dict, mesh) -> dict:
    """Full per-layer arrays from every rank's slices under ``specs``."""
    out: dict = {}
    for res in results:
        for name, piece in res["params"].items():
            rel, i = reference_path(name)
            shape = stacked[rel] if i is None else stacked[rel][1:]
            full = out.setdefault(name, np.zeros(shape, piece.dtype))
            sl = sh.local_slices(specs[rel], stacked[rel], mesh,
                                 res["coord"])
            full[sl if i is None else sl[1:]] = piece
    return out


def _max_err(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


STEP_CASES = [("tp", False), ("tp", True), ("fsdp", False), ("fsdp", True)]


@pytest.fixture(scope="module")
def ref_step():
    """The reference's single-device step on reduced llama (d_model 64,
    vocab 256, float32), compiled once for the cases that compare with
    it: (weights, batch, new parameters, metrics)."""
    rcfg = _small_ref()
    tree = _ref_tree(rcfg)
    batch = next(token_batches(rcfg.vocab_size_real, 8, 32, seed=0))
    rtc = RefTrainConfig(warmup_steps=0, learning_rate=1e-3)
    rp, _, rm = jax.jit(ref_make_train_step(ref_build(rcfg), rtc))(
        tree, ref_init_opt_state(tree), batch)
    return tree, batch, jax.tree.map(np.asarray, rp), \
        {k: float(v) for k, v in rm.items()}


@pytest.mark.parametrize("mode,zero1", STEP_CASES)
def test_sharded_train_step_matches_reference(pool, ref_step, mode, zero1):
    """Same weights, same batch: the (2,4)-mesh step reproduces the
    reference's single-device step."""
    tree, batch, rp, rm = ref_step
    res = pool.run(_r_step, tree, {}, (2, 4), mode, zero1, batch, 1e-3)
    cfg = _llama_cfg()
    mesh = _stand_in((2, 4), ("data", "model"))
    shapes = sh.stacked_shapes(t_specs.params_shape(build(cfg,
                                                          device="cpu")))
    specs = (sh.param_specs if mode == "tp" else sh.fsdp_param_specs)(
        shapes, mesh)
    got = _assemble(res, specs, shapes, mesh)
    assert _max_err(got, _per_layer(rp, cfg)) < 1e-4
    for r in res:
        assert abs(r["loss"] - rm["loss"]) < 1e-4
        assert abs(r["grad_norm"] - rm["grad_norm"]) < 1e-4
    counts = res[0]["counts"]
    if mode == "tp":      # tensor parallel gathers no weight
        assert "mesh.all_gather.calls" not in counts or zero1
        assert counts["mesh.all_reduce.calls"] > 0
    if zero1 and mode == "tp":
        assert counts["mesh.reduce_scatter.calls"] > 0
        assert counts["mesh.all_gather.calls"] > 0


@pytest.mark.parametrize("mode,zero1", STEP_CASES)
def test_sharded_step_gradients_match_reference(pool, ref_step, mode,
                                                zero1):
    """What the (2,4) step hands its update, piece by piece on every rank,
    equals the slice of the reference's single-device ``jax.grad``: within
    1e-5 x the leaf's largest gradient (observed ~1e-6: sums in other
    orders).  Together the pieces cover every leaf (each rank updates its
    own block under ZeRO-1)."""
    tree, batch, _, _ = ref_step
    rcfg = _small_ref()
    rb = ref_build(rcfg)
    want = _per_layer(jax.tree.map(np.asarray, jax.grad(
        lambda p: rb.loss_fn(p, batch)[0])(tree)), _llama_cfg())
    res = pool.run(_r_grads, tree, (2, 4), mode, zero1, batch)
    seen = set()
    for pieces in res:
        for name, sl, g in pieces:
            w = want[name][sl]
            assert g.shape == w.shape, name
            scale = max(float(np.abs(want[name]).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 1e-5 * scale, name
            seen.add(name)
    assert seen == set(want)


def test_fsdp_gathers_each_weight_at_its_use(pool):
    """At d_model 128 and vocab 1024 the embedding (131,072 elements) is
    big enough to shard under FSDP: the step all-gathers it, reduce-
    scatters its gradient, and still equals the reference's step."""
    rcfg = _small_ref(d_model=128, vocab=1024)
    tree = _ref_tree(rcfg)
    batch = next(token_batches(rcfg.vocab_size_real, 8, 32, seed=1))
    rtc = RefTrainConfig(warmup_steps=0, learning_rate=1e-3)
    rp, _, rm = jax.jit(ref_make_train_step(ref_build(rcfg), rtc))(
        tree, ref_init_opt_state(tree), batch)
    res = pool.run(_r_step, tree, {"d_model": 128, "vocab": 1024}, (2, 4),
                   "fsdp", False, batch, 1e-3)
    cfg = _llama_cfg(d_model=128, vocab=1024)
    mesh = _stand_in((2, 4), ("data", "model"))
    shapes = sh.stacked_shapes(t_specs.params_shape(build(cfg,
                                                          device="cpu")))
    specs = sh.fsdp_param_specs(shapes, mesh)
    assert specs["embed"] == ("model", None)
    got = _assemble(res, specs, shapes, mesh)
    assert _max_err(got, _per_layer(jax.tree.map(np.asarray, rp), cfg)) \
        < 1e-4
    assert all(abs(r["loss"] - float(rm["loss"])) < 1e-4 for r in res)
    counts = res[0]["counts"]
    assert counts["mesh.all_gather.calls"] >= 2   # the lookup and the head
    assert counts["mesh.reduce_scatter.calls"] >= 2
    assert res[0]["params"]["embed"].shape == (256, 128)


def test_moe_expert_parallel_matches_fallback_and_reference(pool):
    """Expert-parallel MoE over (2,4) == the single-device fallback and the
    reference's forward (capacity 64: no drops)."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(
        "qwen3_moe_30b_a3b")), dtype="float32", param_dtype="float32",
        capacity_factor=64.0)
    tree = _ref_tree(rcfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size_real, (8, 32))
             .astype(np.int32)}
    want = np.asarray(ref_build(rcfg).forward(tree, batch))
    cfg = _moe_cfg()
    fallback = build(cfg, device="cpu").forward(
        convert.lm_params_from_jax(tree, cfg, "cpu"), batch).numpy()
    assert np.abs(fallback - want).max() < 1e-4
    res = pool.run(_r_moe, tree, (2, 4), batch)
    got = np.zeros_like(want)
    for r in res:
        got[r["rows"]] = r["logits"]
    assert np.abs(got - fallback).max() < 1e-4
    assert np.abs(got - want).max() < 1e-4
    counts = res[0]["counts"]
    # the features are whole on every model rank: the only all-gather is
    # the logits' vocab; the experts' outputs are summed once a layer
    assert counts.get("mesh.all_gather.calls", 0) <= 1
    assert counts["mesh.all_reduce.calls"] >= cfg.n_layers
    full = sum(p.numel() for p in build(cfg, device="cpu").init(0)
               .parameters())
    assert all(r["held"] < full for r in res)


def test_moe_expert_parallel_with_d_model_not_dividing_the_model_axis(pool):
    """d_model 98 over a model axis of 4: the experts still split (the
    features are not), and the forward over (2,4) equals the single-device
    fallback and the reference's forward, which leaves this layout to
    GSPMD (capacity 64: no drops)."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(
        "qwen3_moe_30b_a3b")), dtype="float32", param_dtype="float32",
        capacity_factor=64.0, d_model=98)
    tree = _ref_tree(rcfg, seed=2)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, rcfg.vocab_size_real, (8, 16))
             .astype(np.int32)}
    want = np.asarray(ref_build(rcfg).forward(tree, batch))
    cfg = _moe_cfg(d_model=98)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"),
                                 get_coordinate=lambda: (0, 1))
    assert Parallel(mesh, cfg).ep and cfg.d_model % 4
    fallback = build(cfg, device="cpu").forward(
        convert.lm_params_from_jax(tree, cfg, "cpu"), batch).numpy()
    res = pool.run(_r_moe, tree, (2, 4), batch, {"d_model": 98})
    got = np.zeros_like(want)
    for r in res:
        got[r["rows"]] = r["logits"]
    assert np.abs(got - fallback).max() < 1e-4
    assert np.abs(got - want).max() < 1e-4


def test_moe_expert_parallel_step_matches_single_device(pool):
    """One train step with the 8 experts over an (1,8) mesh: the same loss,
    grad norm and parameters as the port's single-device step (one data
    shard, so the aux loss is the whole batch's on both sides)."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(
        "qwen3_moe_30b_a3b")), dtype="float32", param_dtype="float32",
        capacity_factor=64.0)
    tree = _ref_tree(rcfg, seed=1)
    batch = next(token_batches(rcfg.vocab_size_real, 4, 32, seed=2))
    cfg = _moe_cfg()
    bundle = build(cfg, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    p1, _, m1 = make_train_step(bundle, tc)(params, init_opt_state(params),
                                            batch)
    res = pool.run(_r_moe_step, tree, batch, 1e-3)
    mesh = _stand_in((1, WORLD), ("data", "model"))
    shapes = sh.stacked_shapes(p1)
    got = _assemble(res, sh.param_specs(shapes, mesh), shapes, mesh)
    assert _max_err(got, _np_tree(p1)) < 1e-4
    for r in res:
        assert r["loss"] == pytest.approx(float(m1["loss"]), rel=1e-5)
        assert r["grad_norm"] == pytest.approx(float(m1["grad_norm"]),
                                               rel=1e-5)


def test_elastic_checkpoint_reshard(pool, ref_step, tmp_path):
    """Save a ZeRO-1 state on (4,2), restore it onto (2,4): the same
    arrays, and the files written on either mesh byte-equal to the ones a
    single device writes for the gathered state."""
    tree, batch, _, _ = ref_step
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    saved = pool.run(_r_save, tree, (4, 2), True, batch, a)
    # each rank holds only its data block of the moments (L = 2 over 4
    # data ranks does not divide, so ZeRO-1 takes the next dim)
    assert sum(saved[0]["held"]) < sum(
        np.prod(s) for s in sh.stacked_shapes(t_specs.params_shape(build(
            _llama_cfg(), device="cpu"))).values())
    res = pool.run(_r_restore, (2, 4), True, a, b)
    assert all(r["step"] == 7 for r in res)
    cfg = _llama_cfg()
    mesh = _stand_in((2, 4), ("data", "model"))
    shapes = sh.stacked_shapes(t_specs.params_shape(build(cfg,
                                                          device="cpu")))
    got = _assemble(res, sh.param_specs(shapes, mesh), shapes, mesh)
    _, whole = ckpt.restore_checkpoint(a, {"params": build(cfg, device="cpu")
                                           .init(5)})
    assert all(np.array_equal(got[n], v) for n, v in
               _np_tree(whole["params"]).items())
    # the gathered state saved by one device gives the same files
    _, full = ckpt.restore_checkpoint(a, {
        "params": build(cfg, device="cpu").init(5),
        "opt": init_opt_state(build(cfg, device="cpu").init(5))})
    c = str(tmp_path / "c")
    ckpt.save_checkpoint(c, 7, full)
    for d in (a, b):
        step_dir = Path(d) / "step_00000007"
        names = sorted(os.listdir(step_dir))
        assert names == sorted(os.listdir(Path(c) / "step_00000007"))
        for n in names:
            assert (step_dir / n).read_bytes() == (
                Path(c) / "step_00000007" / n).read_bytes(), (d, n)


def test_restore_on_the_layer_axis_layout(pool, tmp_path):
    """ZeRO-1 on (2,4) shards the stacked layer axis (L = 2) of the moments
    over data: a rank holds whole layers or nothing of a leaf; a save from
    (4,2) restores there and back, bytes equal."""
    rcfg = _small_ref()
    tree = _ref_tree(rcfg)
    batch = next(token_batches(rcfg.vocab_size_real, 8, 32, seed=3))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    saved = pool.run(_r_save, tree, (2, 4), True, batch, a)
    held = saved[0]["held"]
    assert 0 in held                        # a layer it does not hold
    pool.run(_r_restore, (4, 2), True, a, b)
    for n in sorted(os.listdir(Path(a) / "step_00000007")):
        assert (Path(a) / "step_00000007" / n).read_bytes() == (
            Path(b) / "step_00000007" / n).read_bytes(), n


def test_train_loop_over_a_mesh_restarts_on_another(pool, tmp_path):
    """``TrainLoop(mesh=)`` on (2,4), stopped after 3 of 6 steps (every
    rank stops together and saves), restarted on (4,2): its losses and final
    parameters equal an uninterrupted single-device run's."""
    from repro_torch.train.train_loop import TrainLoop
    cfg = _llama_cfg()
    batches = [next(token_batches(cfg.vocab_size_real, 8, 32, seed=s))
               for s in range(6)]
    tc = TrainConfig(total_steps=6, checkpoint_every=2, keep_checkpoints=1,
                     warmup_steps=1, learning_rate=1e-3)
    whole = TrainLoop(build(cfg, device="cpu"), tc, iter(batches),
                      str(tmp_path / "one"), log=lambda *_: None).run()
    wd = str(tmp_path / "mesh")
    first = pool.run(_r_train_loop, wd, (2, 4), 6, 2, batches)
    assert ckpt.committed_steps(wd) == [3]
    second = pool.run(_r_train_loop, wd, (4, 2), 6, 99, batches[3:])
    losses = first[0]["losses"] + second[0]["losses"]
    assert np.allclose(losses, whole["losses"], rtol=0, atol=1e-4)
    mesh = _stand_in((4, 2), ("data", "model"))
    shapes = sh.stacked_shapes(whole["params"])
    got = _assemble(second, sh.param_specs(shapes, mesh), shapes, mesh)
    assert _max_err(got, _np_tree(whole["params"])) < 1e-4


@pytest.mark.parametrize("async_save", [True, False])
def test_sharded_manager_wait_returns_once_committed(pool, tmp_path,
                                                     async_save):
    """A sharded ``CheckpointManager``: rank 0 writes, and its write is
    held back 1 s; every rank's ``wait()`` returns only once the step is
    committed, so a rank that restores right after finds it."""
    wd = str(tmp_path / "ck")
    assert pool.run(_r_manager_wait, wd, async_save, 1.0) == [[1]] * WORLD


# -- compressed psum -----------------------------------------------------------

def _grads():
    rng = np.random.default_rng(0)
    return rng.normal(size=(WORLD, 64, 32)).astype(np.float32)


def test_grad_compression_bf16_close_to_fp32(pool):
    g_all = _grads()
    exact = g_all.sum(0)
    outs = pool.run(_r_psum, g_all, "bf16", 1)
    for (out,) in outs:
        rel = np.abs(out - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel
    plain = pool.run(_r_psum, g_all, "none", 1)
    assert np.abs(plain[0][0] - exact).max() < 1e-5


def test_int8_error_feedback_psum(pool):
    """int8 + error feedback: close per step, and the running mean of 20
    compressed sums of the same gradients converges to the exact sum."""
    g_all = _grads()
    exact = g_all.sum(0)
    outs = pool.run(_r_psum, g_all, "int8", 20)[0]
    rel = np.abs(outs[0] - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel
    rel_avg = np.abs(np.mean(outs, 0) - exact).max() / np.abs(exact).max()
    assert rel_avg < 0.02, rel_avg
    with pytest.raises(ValueError, match="error-feedback"):
        col.compressed_psum({"w": torch.zeros(2)}, "int8", ("data",),
                            mesh=None)
    with pytest.raises(ValueError, match="unknown"):
        col.compressed_psum({"w": torch.zeros(2)}, "fp4", ("data",),
                            mesh=None)


_REF_INT8 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
if not hasattr(jax, "shard_map"):
    from jax.experimental.shard_map import shard_map as _shard_map
    jax.shard_map = _shard_map
from repro.distributed.collectives import compressed_psum
mesh = jax.make_mesh((8,), ("data",))
g_all = np.load(sys.argv[1])
def body(g_shard, err):
    out, new_err = compressed_psum({"w": g_shard[0]}, "int8", ("data",),
                                   err_state={"w": err[0]})
    return out["w"], new_err["w"][None]
f = jax.jit(jax.shard_map(body, mesh=mesh,
            in_specs=(P("data", None, None), P("data", None, None)),
            out_specs=(P(None, None), P("data", None, None))))
err = jnp.zeros(g_all.shape, jnp.float32)
outs = []
for _ in range(int(sys.argv[3])):
    out, err = f(jnp.asarray(g_all), err)
    outs.append(np.asarray(out))
np.save(sys.argv[2], np.stack(outs))
"""


def test_int8_psum_matches_reference_on_eight_devices(pool, tmp_path):
    """The reference's ``compressed_psum`` in a ``shard_map`` over 8 fake
    devices and the port's over 8 gloo ranks, fed the same per-rank
    gradients, for 5 error-feedback steps: the same sums (the int32 sums
    are exact on both sides)."""
    g_all = _grads()
    np.save(tmp_path / "g.npy", g_all)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_INT8),
                        str(tmp_path / "g.npy"), str(tmp_path / "out.npy"),
                        "5"], capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    want = np.load(tmp_path / "out.npy")
    got = np.stack(pool.run(_r_psum, g_all, "int8", 5)[0])
    tol = 1e-6 * np.abs(g_all.sum(0)).max()
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


# -- the collectives and the layouts ------------------------------------------

def test_collective_wrappers_count_calls_and_bytes(pool):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    res = pool.run(_r_collectives, x)
    for r in res:
        d, m = r["coord"]["data"], r["coord"]["model"]
        group = [d * 4 + k for k in range(4)]
        assert np.array_equal(r["sum"], x * sum(g + 1 for g in group))
        assert np.array_equal(r["max"], x * WORLD)
        assert np.array_equal(r["gather"], np.concatenate(
            [x * (g + 1) for g in group], axis=1))
        col_ranks = [k * 4 + m for k in range(2)]
        total = x * sum(g + 1 for g in col_ranks)
        assert np.array_equal(r["scatter"], total[2 * d:2 * d + 2])
        assert np.array_equal(r["strided"], (x * sum(
            g + 1 for g in group))[:, ::2])
        c = r["counts"]
        assert c["mesh.all_reduce.calls"] == 4     # model, data + model, 1
        assert c["mesh.all_gather.calls"] == 1
        assert c["mesh.all_gather.bytes"] == x.nbytes
        assert c["mesh.reduce_scatter.calls"] == 1
        assert c["mesh.reduce_scatter.bytes"] == x.nbytes
        assert "mesh.host_staged" not in c          # CPU tensors: never


def test_host_mesh_over_the_ranks(pool):
    res = pool.run(_r_meshes, 2, 4)
    for rank, r in enumerate(res):
        assert r["names"] == ("data", "model")
        assert r["shape"] == {"data": 2, "model": 4}
        assert r["coord"] == {"data": rank // 4, "model": rank % 4}
        assert r["bad"] == ["need 16 devices, have 8",
                            "need 1 devices, have 8",
                            "need 256 devices, have 8",
                            "need 512 devices, have 8"]


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_device_placer_gives_each_rank_its_rows(pool, mode):
    batch = {"tokens": np.arange(16 * 3, dtype=np.int32).reshape(16, 3),
             "mask": np.ones((16, 3), np.float32)}
    res = pool.run(_r_placer, batch, mode)
    for rank, r in enumerate(res):
        n = 8 if mode == "tp" else 2           # rows a shard
        i = rank // 4 if mode == "tp" else rank
        assert np.array_equal(r["tokens"], batch["tokens"][i * n:(i + 1)
                                                            * n])
        assert r["mask"].shape == (n, 3)


def test_each_rank_holds_its_shards(pool, ref_step):
    """A rank's parameter and moment elements are its shards' sizes: on
    (2,4), a model-sharded leaf a quarter, a replicated one whole, and
    ZeRO-1 halves the moments' data-sharded dim again."""
    tree, batch, _, _ = ref_step
    res = pool.run(_r_step, tree, {}, (2, 4), "tp", True, batch, 1e-3)
    cfg = _llama_cfg()
    mesh = _stand_in((2, 4), ("data", "model"))
    shapes = sh.stacked_shapes(t_specs.params_shape(build(cfg,
                                                          device="cpu")))
    p_specs, m_specs = sh.param_specs(shapes, mesh), sh.zero1_specs(
        shapes, mesh)

    def held(specs, coord):
        n = 0
        for rel, shape in shapes.items():
            sl = sh.local_slices(specs[rel], shape, mesh, coord)
            n += int(np.prod([s.stop - s.start for s in sl]))
        return n
    for r in res:
        assert sum(v.size for v in r["params"].values()) == \
            held(p_specs, r["coord"])
        assert sum(v.size for v in r["mu"].values()) == \
            held(m_specs, r["coord"])
    full = sum(int(np.prod(s)) for s in shapes.values())
    assert held(p_specs, res[0]["coord"]) < full / 2


# -- one device: the caches at tp > 1, and what stays unported --------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b",
                                  "hymba_1_5b", "seamless_m4t_medium"])
def test_caches_at_tp_match_reference(arch, tp):
    """``kv_eff_heads``, ``init_cache(tp=)`` and ``prefill(tp=)`` on one
    device: the reference's replicated-KV caches."""
    from repro.models import transformer as ref_tf
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch),
                                           d_model=64), dtype="float32",
                               param_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=64),
                              dtype="float32", param_dtype="float32")
    assert t_tf.kv_eff_heads(cfg, tp) == ref_tf.kv_eff_heads(rcfg, tp)
    tree = _ref_tree(rcfg)
    rb, tb = ref_build(rcfg), build(cfg, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    rng = np.random.default_rng(tp)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (2, 12))
             .astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(2, 12, cfg.d_model)).astype(
            np.float32)
    else:
        want = rb.init_cache(2, 16, tp=tp)
        got = tb.init_cache(2, 16, tp=tp)
        assert set(want) == set(got)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert np.array_equal(np.asarray(want[k]), got[k].numpy())
    rl, rc = rb.prefill(tree, batch, tp=tp, max_len=16)
    tl, tc = tb.prefill(params, batch, tp=tp, max_len=16)
    assert np.abs(np.asarray(rl) - tl.numpy()).max() < 1e-4
    assert set(rc) == set(tc)
    for k in rc:
        assert tuple(tc[k].shape) == tuple(rc[k].shape), k
        assert np.abs(np.asarray(rc[k]) - tc[k].numpy()).max() < 1e-4, k


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b",
                                  "pixtral_12b", "seamless_m4t_medium"])
def test_other_families_mesh_forward_raises(arch):
    """The ssm, hybrid, vlm and encdec mesh forwards are not ported: they
    raise and name the roadmap."""
    cfg = reduced(get_config(arch))
    bundle = build(cfg, device="cpu")
    params = bundle.init(0)
    mesh = _stand_in((2, 4), ("data", "model"))
    batch = {"tokens": np.zeros((2, 8), np.int32)}
    if cfg.is_encdec:
        batch["frames"] = np.zeros((2, 8, cfg.d_model), np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = np.zeros((2, 1, cfg.d_model), np.float32)
    for call in (lambda: bundle.forward(params, batch, mesh=mesh),
                 lambda: bundle.loss_fn(params, batch, mesh),
                 lambda: make_train_step(bundle, TrainConfig(), mesh)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def _r_decode(tree, arch, shape, batch, feed):
    """Prefill the rank's rows over ``shape`` (tp = the model axis), then
    teacher-forced decode steps of ``feed``'s tokens."""
    from repro_torch.data.loader import device_placer
    cfg = _decode_cfg(arch)
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    local = sh.shard_tree(params, sh.param_shardings(params, mesh))
    rows = device_placer(mesh, sh.batch_shardings)(batch)
    sl = sh.batch_shardings(batch, mesh)["tokens"].slices(
        batch["tokens"].shape)[0]
    logits, cache = bundle.prefill(local, rows, mesh=mesh, tp=shape[1],
                                   max_len=batch["tokens"].shape[1]
                                   + len(feed))
    out = [logits.numpy()]
    for tok in feed:
        logits, cache = bundle.decode_step(local, cache, tok[sl], mesh=mesh)
        out.append(logits.numpy())
    return {"logits": out, "rows": sl, "coord": sh.coordinate(mesh),
            "cache": {k: v.numpy() for k, v in cache.items()}}


def _decode_cfg(arch):
    return dataclasses.replace(reduced(get_config(arch), d_model=64),
                               dtype="float32", param_dtype="float32",
                               capacity_factor=64.0)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b"])
def test_mesh_prefill_and_decode_match_one_device(pool, arch, shape):
    """Prefill and 4 teacher-forced decode steps over a mesh (tp = the
    model axis: reduced kv = 2 is replicated to 4 heads, one a rank, on
    (2,4) and split as is on (4,2)): each rank's logits equal one device's
    rows, and its cache blocks assemble to one device's ``tp``-cache, the
    reference's (``test_caches_at_tp_match_reference``), within 1e-4."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch),
                                           d_model=64), dtype="float32",
                               param_dtype="float32", capacity_factor=64.0)
    tree = _ref_tree(rcfg)
    cfg = _decode_cfg(arch)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (8, 12))
             .astype(np.int32)}
    feed = rng.integers(0, cfg.vocab_size_real, (4, 8)).astype(np.int32)
    bundle = build(cfg, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    logits, cache = bundle.prefill(params, batch, tp=shape[1], max_len=16)
    want = [logits.numpy()]
    for tok in feed:
        logits, cache = bundle.decode_step(params, cache, tok)
        want.append(logits.numpy())
    res = pool.run(_r_decode, tree, arch, shape, batch, feed)
    mesh = _stand_in(shape, ("data", "model"))
    specs = sh.cache_specs(cache, mesh)
    full = {k: np.zeros_like(v.numpy()) for k, v in cache.items()}
    for r in res:
        for w, g in zip(want, r["logits"]):
            assert np.abs(w[r["rows"]] - g).max() < 1e-4
        for k, v in r["cache"].items():
            full[k][sh.local_slices(specs[k], v.shape if not specs[k]
                                    else full[k].shape, mesh,
                                    r["coord"])] = v
    assert specs["k"][3] == "model"            # the heads are split
    for k, v in cache.items():
        assert np.abs(full[k] - v.numpy()).max() < 1e-4, k


def _r_unheld_cache(tree):
    cfg = _decode_cfg("llama3_2_1b")
    mesh = make_host_mesh(1, WORLD, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    local = sh.shard_tree(params, sh.param_shardings(params, mesh))
    try:
        build(cfg, device="cpu").prefill(
            local, {"tokens": np.zeros((2, 8), np.int32)}, mesh=mesh,
            tp=WORLD)
    except NotImplementedError as e:
        return str(e)
    return "no error"


def test_mesh_cache_it_cannot_hold_raises(pool):
    """Reduced llama's 4 query heads do not split 8 ways: attention runs
    replicated, and a prefill over (1,8) refuses to build a cache the
    decode could not read, naming the roadmap."""
    rcfg = dataclasses.replace(ref_reduced(ref_get_config("llama3_2_1b"),
                                           d_model=64), dtype="float32",
                               param_dtype="float32")
    msgs = pool.run(_r_unheld_cache, _ref_tree(rcfg))
    assert all("ROADMAP" in m for m in msgs), msgs


def test_one_rank_mesh_step_equals_the_plain_step():
    """A (1,1) mesh (this process alone): the mesh step is the plain step,
    bit for bit in loss and parameters."""
    import torch.distributed as dist
    cfg = _llama_cfg()
    bundle = build(cfg, device="cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    batch = next(token_batches(cfg.vocab_size_real, 4, 16, seed=0))
    params = bundle.init(0)
    p1, _, m1 = make_train_step(bundle, tc)(
        params.map(lambda _, p: p.clone()), init_opt_state(params), batch)
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        pm, om = init_train_state(params, tc, mesh)
        par = Parallel(mesh, cfg)
        assert not (par.q_split or par.vocab_split or par.ff_split)
        pm, _, mm = jit_train_step(bundle, tc, mesh)(pm, om, batch)
        loss, _, _ = loss_and_grads(bundle, params, batch, mesh)
    finally:
        dist.destroy_process_group()
    assert float(mm["loss"]) == float(m1["loss"]) == float(loss)
    assert all(torch.equal(a, b) for a, b in zip(pm.parameters(),
                                                 p1.parameters()))
