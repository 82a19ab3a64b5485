"""The port's checkpoints and training launcher against the JAX package's,
on the CPU.

Checkpoints keep the reference's layout (``step_%08d/manifest.json``,
``t_%05d.npy``, ``COMMIT`` last) and its leaf paths and order, so a
checkpoint written by either package restores in the other: leaves equal
exactly, manifests and array files equal byte for byte.
"""

import dataclasses
import filecmp
import os
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import ARCH_IDS
from repro.distributed.sharding import _path_str
from repro.models import build as ref_build
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptState, init_opt_state
from repro_torch.train.train_loop import make_train_step

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are tiny, and the suite runs
    its files in parallel processes, where a thread pool a process
    oversubscribes the cores (measured: 10x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg = t_configs.reduced(t_configs.get_config("llama3_2_1b"), d_model=64,
                            vocab=256)
    return cfg, build(cfg, device="cpu")


def _trained_state(arch):
    """The reference's weights for ``arch`` (reduced, d_model 64) and random
    moments at step 7, on both sides: (reference state, port state)."""
    rcfg = dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch), d_model=64),
        dtype="float32")
    tcfg = dataclasses.replace(
        t_configs.reduced(t_configs.get_config(arch), d_model=64),
        dtype="float32")
    params = jax.tree.map(np.asarray,
                          ref_build(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def moment(p):
        return rng.normal(size=p.shape).astype(np.float32)
    opt = ref_opt.OptState(np.asarray(7, np.int32),
                           jax.tree.map(moment, params),
                           jax.tree.map(moment, params))
    host = {"params": params, "opt": opt}
    tp = convert.lm_params_from_jax(host["params"], tcfg, "cpu")
    topt = OptState(torch.tensor(host["opt"].step),
                    convert.lm_params_from_jax(host["opt"].mu, tcfg, "cpu"),
                    convert.lm_params_from_jax(host["opt"].nu, tcfg, "cpu"))
    return {"params": params, "opt": opt}, {"params": tp, "opt": topt}


def _ref_leaves(ref_state) -> list:
    """(the reference's leaf path, host array) in its flatten order."""
    return [(_path_str(p), np.asarray(leaf)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(ref_state)[0]]


def _assert_equal_states(ref_state, port_state):
    got = ckpt._flatten(ckpt.host_tree(port_state))
    want = _ref_leaves(ref_state)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def _same_files(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_checkpoints_cross_load_both_ways(arch, tmp_path):
    """Every architecture's reduced state: saved by each package, restored
    by the other."""
    ref_state, port_state = _trained_state(arch)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_checkpoint(ref_dir, 3, ref_state)
    ckpt.save_checkpoint(port_dir, 3, port_state)
    # byte for byte: manifest, COMMIT and every array file
    _same_files(os.path.join(ref_dir, "step_00000003"),
                os.path.join(port_dir, "step_00000003"))
    # the reference's checkpoint into the port, the port's into the reference
    step, got = ckpt.restore_checkpoint(ref_dir, port_state)
    assert step == 3
    _assert_equal_states(ref_state, got)
    assert got["opt"].step.dtype == torch.int32
    assert isinstance(got["params"], type(port_state["params"]))
    step, got = ref_ckpt.restore_checkpoint(port_dir, ref_state)
    assert step == 3
    _assert_equal_states(got, port_state)


def test_checkpoint_paths_are_the_references():
    ref_state, port_state = _trained_state("llama3_2_1b")
    paths = [p for p, _ in ckpt._flatten(ckpt.host_tree(port_state))]
    assert paths[:3] == ["opt/.step", "opt/.mu/embed", "opt/.mu/final_norm"]
    assert "params/layers/attn/wq" in paths
    assert "opt/.nu/layers/mlp/w_up" in paths
    assert paths == [p for p, _ in _ref_leaves(ref_state)]


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cfg, bundle = _tiny()
    params = bundle.init(0)
    state = {"params": params, "opt": init_opt_state(params)}
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save_checkpoint(d, s, state)
    ckpt.prune_checkpoints(d, keep=2)
    assert ckpt.committed_steps(d) == [2, 3]
    step, restored = ckpt.restore_checkpoint(d, state)
    assert step == 3
    for a, b in zip(ckpt._flatten(ckpt.host_tree(state)),
                    ckpt._flatten(ckpt.host_tree(restored))):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    # new tensors: restoring leaves the target as it was
    assert all(a is not b for a, b in zip(params.parameters(),
                                          restored["params"].parameters()))


def test_checkpoint_ignores_uncommitted(tmp_path):
    cfg, bundle = _tiny()
    params = bundle.init(0)
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 5, {"p": params})
    os.remove(os.path.join(d, "step_00000005", "COMMIT"))
    assert ckpt.latest_step(d) is None
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.committed_steps(d) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, {"p": params})


def test_restore_refuses_another_shape(tmp_path):
    cfg, bundle = _tiny()
    ckpt.save_checkpoint(str(tmp_path), 1, {"p": bundle.init(0)})
    other = build(dataclasses.replace(cfg, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch for p/layers"):
        ckpt.restore_checkpoint(str(tmp_path), {"p": other.init(0)})


def test_manager_saves_async_keeps_and_skips_a_saved_step(tmp_path):
    """Periodic saves on the background thread, retention, a forced save,
    a step already saved not written twice; the copy on the host is taken
    before the next in-place step changes the parameters."""
    cfg, bundle = _tiny()
    params = bundle.init(0)
    opt = init_opt_state(params)
    step = make_train_step(bundle, TrainConfig())
    batch = {"tokens": np.ones((2, 16), np.int32)}
    m = ckpt.CheckpointManager(str(tmp_path), every=2, keep=2)
    saved = []
    for s in range(1, 6):
        params, opt, _ = step(params, opt, batch)
        if m.maybe_save(s, {"params": params, "opt": opt}):
            saved.append(s)
        if s == 4:
            at_4 = convert.lm_params_to_numpy(params)
    assert not m.maybe_save(4, {"params": params, "opt": opt}, force=True)
    assert m.maybe_save(5, {"params": params, "opt": opt}, force=True)
    assert not m.maybe_save(5, {"params": params, "opt": opt}, force=True)
    m.wait()
    assert saved == [2, 4]
    assert ckpt.committed_steps(str(tmp_path)) == [4, 5]
    _, back = ckpt.restore_checkpoint(str(tmp_path), {"params": params,
                                                      "opt": opt}, step=4)
    got = convert.lm_params_to_numpy(back["params"])
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(at_4)))
    assert int(back["opt"].step) == 4


def test_manager_raises_a_failed_async_save(tmp_path):
    cfg, bundle = _tiny()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    m = ckpt.CheckpointManager(str(blocker), every=1)
    assert m.maybe_save(1, {"p": bundle.init(0)})
    with pytest.raises(OSError):
        m.wait()
    m.wait()                                    # raised once


def test_lm_params_to_numpy_inverts_lm_params_from_jax():
    for arch in ("hymba_1_5b", "seamless_m4t_medium"):
        cfg = ref_configs.reduced(ref_configs.get_config(arch), d_model=64)
        params = jax.tree.map(np.asarray,
                              ref_build(cfg).init(jax.random.PRNGKey(1)))
        tcfg = t_configs.reduced(t_configs.get_config(arch), d_model=64)
        got = convert.lm_params_to_numpy(
            convert.lm_params_from_jax(params, tcfg, "cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the launcher and the example ------------------------------------------

def test_launch_train_dedups_and_trains_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --device cpu --reduced --dedup`` end to end: the
    reference's ``[launch]`` lines and its kept count (D = 2^14, K = 256
    over the 400-document corpus), checkpoints in the workdir, a second
    run resuming at the end.  (The import rule for the launcher is
    ``test_torch_core``'s.)"""
    from repro_torch.launch.train import main
    wd = str(tmp_path / "run")
    argv = ["--arch", "llama3_2_1b", "--reduced", "--dedup", "--steps", "8",
            "--workdir", wd, "--device", "cpu"]
    out = main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[launch] llama3_2_1b: 0.4M params (reduced)"
    assert lines[1] == "[launch] dedup kept 334/400 docs"
    assert lines[-1].startswith("[launch] final loss ")
    assert sum(line.startswith("[train] step ") for line in lines) == 8
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert ckpt.committed_steps(wd) == [4, 6, 8]
    again = main(argv)
    printed = capsys.readouterr().out
    assert f"[train] restored step 8 from {wd}" in printed
    assert "final loss" not in printed and again["losses"] == []


def test_train_example_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["x", "--device", "cpu", "--steps", "4",
                                      "--batch", "2", "--seq", "64",
                                      "--workdir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    printed = capsys.readouterr().out
    assert "dedup: kept 334/400 documents" in printed
    assert "loss: first-1-avg" in printed
    assert ckpt.committed_steps(str(tmp_path)) == [2, 3, 4]


def test_train_entry_points_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3_2_1b", "--reduced",
                           "--workdir", str(tmp_path)])
    cfg, bundle = _tiny()
    ckpt.save_checkpoint(str(tmp_path), 1, {"p": bundle.init(0)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_checkpoint(str(tmp_path), {"p": bundle.init(0)},
                                device="cuda")
