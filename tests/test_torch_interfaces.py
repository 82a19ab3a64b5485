"""The port's interfaces against the JAX package's.

For every public function and class of every ``src/repro/**/*.py``, the
port's counterpart (the same name in the same module under
``repro_torch``) must exist and take each of the reference's parameter
names, and the parameters the reference takes by position must sit in the
same places, so that a reference call runs on the port.  A class is held
by its constructor.  The exceptions are listed below, each with its
reason; a listed exception the port no longer needs fails the check too.

The signatures are read in a subprocess: importing every module of the JAX
package in the test process would set ``repro.launch.dryrun``'s
``XLA_FLAGS`` for whatever runs after it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"


def _module_name(path: Path) -> str:
    parts = path.relative_to(REF.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module_name(p) for p in REF.rglob("*.py"))

# Reference parameters the port does not take, by "module:name" (the module
# relative to the package).
NOT_TAKEN = {
    # The port picks the kernel or its plain version by the tensor's device
    # (``use_kernel``, ``backend``, ``impl``), and its launch geometry is
    # the autotuner's knob, not a Pallas block size (``block_*``).
    "core.engine:SketchConfig": {"use_kernel", "block_b", "block_d",
                                 "block_j"},
    "kernels.dispatch:select_dense_impl": {"use_kernel", "backend"},
    "kernels.dispatch:signatures_dense": {"use_kernel", "block_b",
                                          "block_d"},
    "kernels.dispatch:signatures_sparse": {"use_kernel", "impl", "block_b",
                                           "block_j"},
    "kernels.dispatch:select_probe_impl": {"backend"},
    "kernels.dispatch:lsh_probe": {"impl", "block_e"},
    "kernels.dispatch:fold_hashes": {"impl", "block_q", "autotune_measure"},
    "kernels.dispatch:query_fused": {"impl", "block_q", "block_e",
                                     "autotune_measure"},
    "kernels.ops:cminhash_signatures": {"use_kernel", "block_b", "block_d"},
    "kernels.ops:cminhash_signatures_packed": {"use_kernel"},
    "kernels.ops:collision_counts": {"use_kernel", "block_q", "block_n",
                                     "block_k"},
    "analysis.roofline:cminhash_kernel_roofline": {"block_b", "block_d"},
    # The port's cost analysis runs a function on meta tensors; the
    # reference's parses the HLO text of a compiled one.
    "analysis.hlo:analyze": {"text"},
}

# A JAX PRNG ``key`` is a ``torch.Generator`` or an int seed in the port.
RENAMED = {"key": ("generator", "gen", "seed")}

# Parameters only the port takes, placed among the reference's positional
# ones: where the bundle's tensors live.
PORT_ONLY = {"models.registry:ModelBundle": {"device"}}

# Names with no counterpart in the port.
NO_COUNTERPART = {
    # the HLO text parser's types (the port counts a trace instead)
    "analysis.hlo:Op", "analysis.hlo:Computation",
    "analysis.hlo:parse_module",
    # the choice between a Pallas kernel, its compiled-jnp twin and the
    # gather oracle; the port has one kernel and its plain version
    "kernels.dispatch:select_sparse_impl",
    "kernels.dispatch:select_query_impl",
    # the Pallas kernels' in-kernel packing epilogue
    "kernels.packfmt:pack_block",
    # the fold's two uint32 planes, for lanes without 64-bit integers; the
    # port folds in int64
    "kernels.query_fused:words_to_planes",
    "kernels.query_fused:sig_to_planes",
    "kernels.query_fused:planes_to_hashes",
}

_SCAN = r"""
import importlib, inspect, json, sys
sys.path.insert(0, "src")
out = {}
for name in json.loads(sys.argv[1]):
    ref = importlib.import_module(name)
    port = importlib.import_module("repro_torch" + name[len("repro"):])
    rows = out[name] = {}
    for attr, obj in vars(ref).items():
        if attr.startswith("_") or getattr(obj, "__module__", None) != name:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        try:
            want = inspect.signature(obj)
        except (TypeError, ValueError):
            continue
        have = getattr(port, attr, None)
        sig = lambda s: [(p.name, p.kind.name) for p in s.parameters.values()]
        rows[attr] = {"ref": sig(want),
                      "port": None if have is None else sig(
                          inspect.signature(have))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def signatures() -> dict:
    """``{module: {name: {"ref": [(param, kind)], "port": [...] | None}}}``
    for every reference module."""
    p = subprocess.run([sys.executable, "-c", _SCAN, json.dumps(MODULES)],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout)


_POSITIONAL = ("POSITIONAL_ONLY", "POSITIONAL_OR_KEYWORD")
_VARIADIC = ("VAR_POSITIONAL", "VAR_KEYWORD")


def mismatches(key: str, ref: list, port: list | None) -> list[str]:
    """What keeps a reference call of ``key`` from running on the port."""
    if port is None:
        return [] if key in NO_COUNTERPART else [f"{key}: no counterpart"]
    skip = NOT_TAKEN.get(key, set())
    names = {n for n, _ in port}
    out = []
    for n, kind in ref:
        if kind in _VARIADIC or n in skip:
            continue
        if n not in names and not names & set(RENAMED.get(n, ())):
            out.append(f"{key}: no parameter {n!r}")
    want = [n for n, kind in ref if kind in _POSITIONAL and n not in skip]
    have = [n for n, kind in port if kind in _POSITIONAL
            and n not in PORT_ONLY.get(key, ())]
    for i, n in enumerate(want):
        if i >= len(have) or (have[i] != n
                              and have[i] not in RENAMED.get(n, ())):
            out.append(f"{key}: {n!r} is not positional parameter {i}")
            break
    return out


@pytest.mark.parametrize("module", MODULES)
def test_port_takes_the_reference_parameters(signatures, module):
    """Each public function and class of ``module`` has a counterpart that
    takes the reference's parameters, the positional ones in place."""
    bad = [m for attr, sig in signatures[module].items()
           for m in mismatches(f"{module[len('repro.'):]}:{attr}",
                               sig["ref"], sig["port"])]
    assert not bad, bad


def test_every_exception_is_still_needed(signatures):
    """Each listed exception names a reference function or class whose port
    counterpart still lacks what the list excuses."""
    found = {f"{m[len('repro.'):]}:{a}": s for m, rows in signatures.items()
             for a, s in rows.items()}
    for key, params in NOT_TAKEN.items():
        ref = {n for n, _ in found[key]["ref"]}
        port = {n for n, _ in found[key]["port"]}
        assert params <= ref and not params & port, key
    for key in NO_COUNTERPART:
        assert found[key]["port"] is None, key
    for key, params in PORT_ONLY.items():
        assert not params & {n for n, _ in found[key]["ref"]}, key
        assert params <= {n for n, _ in found[key]["port"]}, key


@pytest.mark.parametrize("key,ref,port,want", [
    ("serve.decode:generate",
     [("bundle", "POSITIONAL_OR_KEYWORD"), ("mesh", "KEYWORD_ONLY")],
     [("bundle", "POSITIONAL_OR_KEYWORD")], ["no parameter 'mesh'"]),
    ("core.engine:SketchEngine",
     [("cfg", "POSITIONAL_OR_KEYWORD"), ("mesh", "POSITIONAL_OR_KEYWORD")],
     [("cfg", "POSITIONAL_OR_KEYWORD"), ("mesh", "KEYWORD_ONLY")],
     ["'mesh' is not positional parameter 1"]),
    ("models.layers:normal_init", [("key", "POSITIONAL_OR_KEYWORD")],
     [("gen", "POSITIONAL_OR_KEYWORD")], []),
    ("kernels.dispatch:select_sparse_impl", [], None, []),
    ("kernels.dispatch:signatures_dense", [], None, ["no counterpart"]),
])
def test_the_check_sees_a_lost_parameter(key, ref, port, want):
    """The rule itself: a parameter the port lacks, or takes only by
    keyword where the reference takes it by position, is reported; a
    renamed key and a listed absence are not."""
    got = mismatches(key, ref, port)
    assert [g.split(": ", 1)[1] for g in got] == want
