"""The port's dry run (``repro_torch.launch.dryrun``) on real, full-size
configs: the reference test's cells (``tests/test_dryrun_small.py``) and
the batch-starved SSM decode, each in a subprocess (the fake process group
that stands in for the 256- or 512-rank mesh is process-global), with the
reference's assertions on the record; a cell of every family held to the
reference's own dry run of it; every cell's status against the
reference's ``runnable``; and the depth extrapolation against a full
trace.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch.specs import runnable as ref_runnable
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, shape_by_name
from repro_torch.launch.specs import runnable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [
    ("llama3_2_1b", "decode_32k", "single"),
    ("hymba_1_5b", "long_500k", "single"),
    ("qwen3_moe_30b_a3b", "train_4k", "multi"),    # expert parallel, 512
    ("seamless_m4t_medium", "decode_32k", "multi"),
    ("falcon_mamba_7b", "long_500k", "single"),    # tensor dims over 256
]


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_dryrun_cell_traces(arch, shape, mesh, tmp_path):
    out = tmp_path / "dryrun"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    mesh_name = "single_pod" if mesh == "single" else "multi_pod"
    rec = json.loads((out / f"{mesh_name}__{arch}__{shape}.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback", rec.get("error"))
    assert rec["n_chips"] == (256 if mesh == "single" else 512)
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    if shape == "train_4k":
        assert rec["hlo_cost"]["collective_bytes"] > 0  # DP+EP collectives
    if arch == "falcon_mamba_7b":
        # batch-starved (B = 1): the SSM's dims over (data x model), so a
        # rank holds 1/256 of every split leaf, as the reference lays it
        assert rec["tensor_axes"] == ["data", "model"]
        cfg = get_config(arch)
        assert rec["memory"]["argument_bytes"] < cfg.param_count() * 4 / 128
        assert rec["hlo_cost"]["collective_breakdown"]["all-gather"] > 0


# single-pod cells held to the reference's dry run: each family, each
# kind of step, and the largest layout difference (danube's prefill)
REF_CELLS = [
    ("llama3_2_1b", "decode_32k"),     # the reference test's cell
    ("llama3_2_1b", "prefill_32k"),
    ("llama3_2_1b", "train_4k"),
    ("h2o_danube3_4b", "prefill_32k"),  # sliding window, 8 KV heads
    ("qwen3_moe_30b_a3b", "train_4k"),  # MoE, expert parallel
    ("falcon_mamba_7b", "train_4k"),    # SSM
    ("hymba_1_5b", "decode_32k"),       # hybrid, query heads whole
    ("seamless_m4t_medium", "train_4k"),  # encoder-decoder
]
# the relative tolerance on FLOPs: the products are equal, but XLA lowers
# softmax, masking and norms into other elementwise operations than the
# port's eager ones (up to 2% of a step); the reference's SSM scan does
# more elementwise work than the port's (3.4% of falcon_mamba's step)
FLOP_TOL = {"falcon_mamba_7b": 0.04}


def _records(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def both_dry_runs():
    """{(arch, shape): (port's record, reference's record)} for
    ``REF_CELLS``, each package's dry run in its own subprocess (the
    reference's needs its 512 XLA host devices, the port's its fake
    group), the two at once."""
    cells = json.dumps(REF_CELLS)
    port = _records(f"""
        import json
        from repro_torch.configs.base import TrainConfig
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_production_mesh
        D.init_fake_group(False)
        mesh = make_production_mesh(device="cpu")
        print(json.dumps([D.analyze_cell(a, s, mesh, "single_pod",
                                         TrainConfig()) for a, s in {cells}]))
    """, _env())
    ref = _records(f"""
        import json
        from repro.launch import dryrun as D    # sets the XLA device count
        from repro.configs.base import TrainConfig
        from repro.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=False)
        print(json.dumps([D.analyze_cell(a, s, mesh, "single_pod",
                                         TrainConfig()) for a, s in {cells}]))
    """, dict(_env(), JAX_PLATFORMS="cpu"))
    out = {}
    for name, proc in (("port", port), ("reference", ref)):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stdout[-2000:], stderr[-4000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return {cell: (p, r) for cell, p, r in zip(REF_CELLS, out["port"],
                                                out["reference"])}


def _kv_excess_flops(cfg, shape, tp: int = 16, n_data: int = 16) -> float:
    """The FLOPs a rank of the port's step spends on K/V projections that
    the reference's program does not: where the query heads split over
    ``model`` and the KV heads do not (fewer than ``tp``), every rank
    projects all KV heads (``Parallel``'s replicated ``wk``/``wv``) where
    GSPMD projects the one its query heads read: k and v, forward,
    recomputed (``remat``), and both gradients in a train step.  Prefill
    also runs ``project_kv`` for the cache after the attention projected
    the same K/V (the rank's q, k and v slices again); XLA merges the two.
    An SSM or an encoder-decoder (whose heads split) has none."""
    if cfg.family == "ssm" or cfg.is_encdec:
        return 0.0
    if cfg.n_heads % tp:                       # attention whole on a rank
        q_local, kv_port, kv_ref = cfg.n_heads, cfg.n_kv_heads, \
            cfg.n_kv_heads
    elif cfg.n_kv_heads % tp == 0:
        q_local, kv_port = cfg.n_heads // tp, cfg.n_kv_heads // tp
        kv_ref = kv_port
    else:
        q_local, kv_port, kv_ref = cfg.n_heads // tp, cfg.n_kv_heads, 1
    rows = shape.global_batch // n_data * (
        1 if shape.kind == "decode" else shape.seq_len)
    heads = {"decode": 2 * (kv_port - kv_ref),
             "train": 8 * (kv_port - kv_ref),
             "prefill": 2 * (kv_port - kv_ref) + q_local + 2 * kv_port
             }[shape.kind]
    return cfg.n_layers * heads * 2.0 * rows * cfg.d_model * cfg.head_dim


@pytest.mark.parametrize("arch,shape", REF_CELLS)
def test_dryrun_cell_matches_the_reference(both_dry_runs, arch, shape):
    """The port's record of a cell against the reference's own dry run of
    it: rank 0's argument bytes equal (the same layout of parameters,
    optimizer state, batch and cache), and its FLOPs, less the port's
    known K/V excess (``_kv_excess_flops``), within ``FLOP_TOL``.
    Collective and temporary bytes are not compared: the reference's XLA
    CPU backend all-reduces bf16 in float32, GSPMD picks its own
    collectives, and XLA's buffer assignment is no eager peak."""
    port, ref = both_dry_runs[(arch, shape)]
    assert port["status"] == ref["status"] == "ok", port.get("traceback")
    assert port["memory"]["argument_bytes"] == ref["memory"][
        "argument_bytes"]
    excess = _kv_excess_flops(get_config(arch), shape_by_name(shape))
    flops, want = port["hlo_cost"]["flops"], ref["hlo_cost"]["flops"]
    print(f"{arch} x {shape}: FLOPs port / reference {flops / want:.4f}, "
          f"{(flops - excess) / want:.4f} less the K/V excess; argument "
          f"bytes {port['memory']['argument_bytes']}")
    assert flops - excess == pytest.approx(want,
                                           rel=FLOP_TOL.get(arch, 0.025))


@pytest.mark.parametrize("mesh", ["single_pod", "multi_pod"])
def test_cell_statuses_follow_the_reference(mesh):
    """All 80 cells: a cell is traced exactly where the reference's
    ``runnable`` lets it run, and skipped for the same reason."""
    assert [s.name for s in SHAPES] == [s.name for s in REF_SHAPES]
    n = 0
    for arch in ARCH_IDS:
        for shape, ref_shape in zip(SHAPES, REF_SHAPES):
            assert runnable(get_config(arch), shape) == ref_runnable(
                ref_get_config(arch), ref_shape), (mesh, arch, shape.name)
            n += 1
    assert n == 40


def test_depth_extrapolation_equals_a_full_trace():
    """A cell's counts extrapolated from its 1- and 2-layer traces equal a
    trace at 3 layers (each side of an encoder-decoder): a train step, a
    dense and an MoE prefill, a hybrid's and an encoder-decoder's
    decode."""
    code = textwrap.dedent("""
        import dataclasses, json
        from repro_torch.configs import get_config
        from repro_torch.configs.base import TrainConfig
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_production_mesh
        D.init_fake_group(False)
        mesh = make_production_mesh(device="cpu")
        out = []
        for arch, shape in (("h2o_danube3_4b", "train_4k"),
                            ("llama3_2_1b", "prefill_32k"),
                            ("kimi_k2_1t_a32b", "prefill_32k"),
                            ("hymba_1_5b", "decode_32k"),
                            ("seamless_m4t_medium", "decode_32k")):
            cfg = get_config(arch)
            depth = {"n_layers": 3}
            if cfg.is_encdec:
                depth["n_enc_layers"] = 3
            cut = dataclasses.replace(cfg, **depth)
            traces = [D.trace_cell(arch, shape, mesh, TrainConfig(), p)
                      for p in D.depth_points(cfg)]
            out.append([D.extrapolate(cut, traces),
                        D.trace_cell(arch, shape, mesh, TrainConfig(),
                                     depth)])
        print(json.dumps(out))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    for got, want in json.loads(p.stdout.splitlines()[-1]):
        for key in ("flops", "bytes", "bytes_naive", "collective_bytes",
                    "n_collectives", "argument_bytes", "output_bytes"):
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
        # a peak is not a sum: a layer's share of it is nearly, not
        # exactly, the same at every depth (0.44% off at hymba's decode)
        assert got["temp_bytes"] == pytest.approx(want["temp_bytes"],
                                                  rel=0.01)
