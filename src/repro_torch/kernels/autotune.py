"""Launch-geometry autotuner for the port's CUDA kernels.

The counterpart of ``repro.kernels.autotune``, over the knobs these
kernels compile (the reference tunes Pallas block sizes, which have no
twin here).  Keys: ``kind:backend:B<pow2>:D<pow2>:K<pow2>`` (``:N<pow2>``
added for sparse signing, where ``nnz`` is the dimension a row's work
follows), with ``backend`` the tensors' device type, ``cuda`` or ``cpu``.
Kinds and their knobs (every value an int, so a cache file that the JAX
package writes too holds both packages' entries; the kinds' names differ
from the reference's, whose ``dense_int8`` and ``dense_packed`` hold other
knobs):

* ``sparse``     -> {placement}      (kernels.cminhash_sparse)
* ``dense_rows`` -> {placement}      (kernels.cminhash_kernel, int8 rows)
* ``dense_bits`` -> {placement}      (kernels.cminhash_packed, bit rows)
                    placement: where pi lives (``PLACEMENTS``), -1 for the
                    launch's own pick from occupancy (the default)
* ``fold``       -> {threads}        (kernels.query_fused fold; keyed
                                      B=queries, D=n_bands, K=rows a band)
* ``probe``      -> {group, steps}   (kernels.lsh_probe, from the fold's
                                      hashes; keyed B=entries, D=n_slots,
                                      K=record width W)
* ``collision``  -> {block_q}        (kernels.collision_kernel; keyed B=Q,
                                      D=N, K=words a row)

The defaults (``_DEFAULTS``) are the geometry each kernel had before it
took a knob, so a process with no cache launches exactly that.

Cache semantics (the reference's contract):

* ``recommend()`` never measures.  It returns the cached winner when one
  exists (``autotune.hit``), else the default (``autotune.heuristic``),
  clamped to the shape.  Every kernel wrapper calls it once a launch for
  the knobs it is not given (a CPU tensor's plain version has no knobs
  and asks nothing).
* ``measure()`` times every valid candidate on synthetic data of the
  request shape, interleaved, the min of ``iters`` rounds, stores the
  winner in the in-process cache and writes it to the JSON file at
  ``$REPRO_AUTOTUNE_CACHE`` (if set) so later processes start warm.  On a
  card each timing is of the device: CUDA events around the call, after a
  ~0.25 ms spin that hides the host's launch work, with the card
  synchronised before and after.
* Default sweeps (``candidates=None``) always include the default and
  re-duel the would-be winner against it: a winner that cannot beat the
  default in the duel is rejected (``autotune.guard_rejects``) and the
  default is cached instead.  The signing kinds' default (-1) launches
  the kernel of one of the explicit placements, so it meets the winner
  only in the duel, which the winner must take by more than the duel's
  own spread.  Explicit ``candidates=`` are trusted as given: no default
  injection, no duel.  ``force=True`` re-sweeps a shape class already
  cached.  A cached winner, from any shape of its class, is clamped to
  the shape asked for, by ``measure`` as by ``recommend``.
* The JSON file is loaded lazily once per path and merged under the
  in-process entries; ``clear_cache()`` forgets both (the file is
  untouched).

``SketchConfig(autotune_measure=True)`` and ``chip_smoke.py``'s tuning
phase run ``measure``; everything else rides the cache.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Callable

import torch

from ..obs import metrics as obs_metrics

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"

KINDS = ("sparse", "dense_rows", "dense_bits", "fold", "probe", "collision")
SIGNING = ("sparse", "dense_rows", "dense_bits")

# csrc/window_fold.cuh's placements
PLACEMENTS = {"shared16": 0, "global32": 1, "pairs": 2}

_DEFAULTS: dict[str, dict[str, int]] = {
    "sparse": {"placement": -1},
    "dense_rows": {"placement": -1},
    "dense_bits": {"placement": -1},
    "fold": {"threads": 256},
    "probe": {"group": 4, "steps": 4},
    "collision": {"block_q": 64},
}

# the instances each source compiles (a value outside them is refused)
_PLACEMENT_CANDIDATES = tuple({"placement": PLACEMENTS[p]}
                              for p in ("pairs", "shared16", "global32"))
_CANDIDATES: dict[str, tuple[dict[str, int], ...]] = {
    "sparse": _PLACEMENT_CANDIDATES,
    "dense_rows": _PLACEMENT_CANDIDATES,
    "dense_bits": _PLACEMENT_CANDIDATES,
    "fold": tuple({"threads": t} for t in (128, 256, 512)),
    "probe": tuple({"group": g, "steps": s}
                   for g, s in ((2, 2), (4, 2), (4, 4), (8, 4), (8, 8),
                                (16, 8))),
    "collision": tuple({"block_q": q} for q in (16, 32, 64)),
}

PROBE_DEPTH = 16           # the sweep's max_probes: BandedLSHTable's default
PROBE_BANDS = 32           # bands of the sweep's table, where they divide B
SPIN_CYCLES = 500_000      # ~0.25 ms at the H100's 1.98 GHz boost clock

# csrc/window_fold.cuh's shared-memory budget on an H100 (the opt-in limit
# a block may use, and the warps' lists beside the table)
_SMEM_OPTIN = 232_448
_LIST_BYTES = 16 * 1028 * 4

_cache: dict[str, dict[str, int]] = {}
_loaded_paths: set[str] = set()


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def cache_key(kind: str, b: int, d: int, k: int, backend: str,
              nnz: int = 0) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (want one of {KINDS})")
    key = f"{kind}:{backend}:B{_pow2(b)}:D{_pow2(d)}:K{_pow2(k)}"
    if kind == "sparse":
        # a row's work follows its nnz: a winner at one density is not a
        # winner at another, so it belongs in the key
        key += f":N{_pow2(max(nnz, 1))}"
    return key


def _cache_path() -> str | None:
    return os.environ.get(CACHE_ENV) or None


def _load_file(path: str) -> None:
    if path in _loaded_paths:
        return
    _loaded_paths.add(path)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return
    for key, knobs in data.items():
        _cache.setdefault(key, {str(n): int(v) for n, v in knobs.items()})


def _save_file(path: str) -> None:
    try:
        existing: dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
        existing.update(_cache)
        with open(path, "w") as f:
            json.dump(existing, f, indent=1, sort_keys=True)
    except (OSError, ValueError):
        pass                        # cache persistence is best-effort


def clear_cache() -> None:
    """Forget in-process entries and loaded-file markers (file untouched)."""
    _cache.clear()
    _loaded_paths.clear()


def cached(kind: str, b: int, d: int, k: int, backend: str | None = None,
           nnz: int = 0) -> dict[str, int] | None:
    backend = backend or default_backend()
    path = _cache_path()
    if path:
        _load_file(path)
    hit = _cache.get(cache_key(kind, b, d, k, backend, nnz))
    return dict(hit) if hit else None


def placement_fits(placement: int, d: int, k: int) -> bool:
    """Whether csrc/window_fold.cuh offers ``placement`` at (D, K) and its
    table fits a block's shared memory on an H100 (the pair table only at
    K > 64, the uint16 table only for D <= 65,536), at shift_offset 1
    (0 takes one entry less)."""
    if placement == PLACEMENTS["global32"]:
        return True
    span = 32 * (2 if k <= 64 else 8 if k <= 256 else 16 if k <= 512
                 else 32)
    n = d + -(-k // span) * span + 1            # the table with its front
    if placement == PLACEMENTS["shared16"]:
        return d <= 65_536 and n * 2 + _LIST_BYTES <= _SMEM_OPTIN
    if placement == PLACEMENTS["pairs"]:
        return k > 64 and (n // 2 + 1) * 8 + _LIST_BYTES <= _SMEM_OPTIN
    return False


def _clamp(kind: str, knobs: dict[str, int], b: int, d: int,
           k: int) -> dict[str, int]:
    out = dict(knobs)
    if kind in SIGNING and out["placement"] >= 0 and \
            not placement_fits(out["placement"], d, k):
        # a winner of another shape of the same class that does not fit
        # this one: the launch's own pick
        out["placement"] = -1
    if kind == "probe":
        out["steps"] = min(out["steps"], out["group"])
    return out


def default(kind: str, b: int, d: int, k: int) -> dict[str, int]:
    """The default knobs of ``kind`` at this shape (what ``recommend``
    returns with no cache)."""
    return _clamp(kind, _DEFAULTS[kind], b, d, k)


def recommend(kind: str, b: int, d: int, k: int,
              backend: str | None = None, nnz: int = 0) -> dict[str, int]:
    """Cached winner if one exists, else the default, clamped to the
    shape.  Never measures."""
    backend = backend or default_backend()
    hit = cached(kind, b, d, k, backend, nnz)
    if hit is not None:
        obs_metrics.default().counter("autotune.hit").inc()
        return _clamp(kind, hit, b, d, k)
    obs_metrics.default().counter("autotune.heuristic").inc()
    return default(kind, b, d, k)


class _Runner:
    """Synthetic inputs of one request shape on one device; ``runner(knobs)``
    is a thunk that launches the kind's wrapper with those knobs,
    ``plain()`` the kind's plain version on the same inputs (what a winner
    is held against), and ``inputs`` the inputs by name (to count the
    work)."""

    def __init__(self, device: torch.device,
                 call: Callable[[dict[str, int]], Any],
                 plain: Callable[[], Any], **inputs: torch.Tensor):
        self.device = device
        self._call = call
        self.plain = plain
        self.inputs = inputs

    def __call__(self, knobs: dict[str, int]) -> Callable[[], Any]:
        return lambda: self._call(knobs)


def _probe_inputs(gen: torch.Generator, entries: int, n_slots: int, w: int,
                  dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A table of ``n_bands`` x ``n_slots`` records, each band holding
    n_slots / 2 keys at distinct home slots, and ``entries`` band hashes,
    half of them stored keys, half absent: a stored key's walk ends at
    step 0, as most do at serving load, and a miss walks to an unused
    slot."""
    n_bands = PROBE_BANDS if entries % PROBE_BANDS == 0 else 1
    n_keys = max(1, n_slots // 2)
    slots = torch.rand((n_bands, n_slots), generator=gen,
                       device=dev).argsort(dim=1)[:, :n_keys]
    keys = slots + n_slots * torch.randint(
        0, 2 ** 62 // n_slots, (n_bands, n_keys), generator=gen, device=dev)
    records = torch.full((n_bands * n_slots, 2 + w), -1, dtype=torch.int32,
                         device=dev)
    band = torch.arange(n_bands, device=dev)[:, None]
    rows = (band * n_slots + slots).reshape(-1)
    lo = keys & 0xFFFFFFFF
    records[rows, 0] = torch.where(lo >= 2 ** 31, lo - 2 ** 32,
                                   lo).reshape(-1).to(torch.int32)
    records[rows, 1] = (keys >> 32).reshape(-1).to(torch.int32)
    records[rows, 2:] = torch.randint(0, 2 ** 31 - 1, (rows.numel(), w),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
    q = -(-entries // n_bands)
    pick = torch.randint(0, n_keys, (q, n_bands), generator=gen, device=dev)
    stored = keys.t().gather(0, pick)                        # (q, n_bands)
    absent = torch.randint(0, 2 ** 62, (q, n_bands), generator=gen,
                           device=dev)
    present = torch.rand((q, n_bands), generator=gen, device=dev) < 0.5
    hashes = torch.where(present, stored, absent)
    return records, hashes


def _make_runner(kind: str, b: int, d: int, k: int, nnz: int, seed: int,
                 backend: str) -> _Runner:
    """Build synthetic inputs once on ``backend``; return knobs -> thunk."""
    from ..core.permutations import make_two_permutations
    from . import (cminhash_kernel, cminhash_packed, cminhash_sparse,
                   collision_kernel, lsh_probe, query_fused)

    dev = torch.device(backend)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, d, k = max(b, 1), max(d, 1), max(k, 1)

    def ints(shape, lo=-2 ** 31, hi=2 ** 31 - 1):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if kind == "fold":
        rows = ints((b, d, k))
        return _Runner(dev, lambda kn: query_fused.fold_rows_kernel(
            rows, **kn), lambda: query_fused.fold_rows_plain(rows),
            rows=rows)
    if kind == "probe":
        records, hashes = _probe_inputs(gen, b, d, k, dev)
        return _Runner(dev, lambda kn: lsh_probe.lsh_probe_hashes_kernel(
            records, hashes, n_slots=d, max_probes=PROBE_DEPTH, **kn),
            lambda: lsh_probe.lsh_probe_hashes_plain(
                records, hashes, n_slots=d, max_probes=PROBE_DEPTH),
            records=records, hashes=hashes)
    if kind == "collision":
        wq, wn = ints((b, k)), ints((d, k))
        return _Runner(dev, lambda kn: collision_kernel.
                       packed_collision_counts_kernel(wq, wn, k, 32, **kn),
                       lambda: torch.cat([   # in blocks: bounded temporaries
                           collision_kernel.collision_counts_plain(
                               wq, wn[lo: lo + 16384])
                           for lo in range(0, d, 16384)], dim=1),
                       words_q=wq, words_n=wn)

    _, pi = make_two_permutations(torch.Generator().manual_seed(seed), d,
                                  device=dev)
    if kind == "sparse":
        nnz = max(1, nnz or int(0.05 * d))
        idx = ints((b, nnz), 0, d).sort(dim=1).values.contiguous()
        return _Runner(dev, lambda kn: cminhash_sparse.cminhash_sparse_kernel(
            idx, pi, k, **kn), lambda: cminhash_sparse.cminhash_sparse_plain(
            idx, pi, k), idx=idx, pi=pi)
    dens = nnz / d if nnz else 0.05
    v = (torch.rand((b, d), generator=gen, device=dev) < dens).to(torch.int8)
    if kind == "dense_rows":
        return _Runner(dev, lambda kn: cminhash_kernel.cminhash_dense_kernel(
            v, pi, k, **kn), lambda: cminhash_kernel.cminhash_dense_plain(
            v, pi, k), v=v, pi=pi)
    words = cminhash_packed.pack_bits(v)
    del v
    return _Runner(dev, lambda kn: cminhash_packed.cminhash_packed_kernel(
        words, pi, k, **kn), lambda: cminhash_packed.cminhash_packed_plain(
        words, pi, k), words=words, pi=pi)


def _valid(kind: str, knobs: dict[str, int], b: int, d: int, k: int) -> bool:
    if kind in SIGNING:
        return knobs["placement"] < 0 or placement_fits(knobs["placement"],
                                                        d, k)
    if kind == "probe":
        return knobs["steps"] <= knobs["group"]
    return True


def _seconds(fn: Callable[[], Any], device: torch.device) -> float:
    """One timed run of ``fn``: the device's time on a card (CUDA events
    after a spin that hides the host's launch work), the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _times(runner: _Runner, cands: list[dict[str, int]], warmup: int,
           iters: int) -> list[tuple[dict[str, int], list[float]]]:
    """Time candidates INTERLEAVED (round-robin, ``iters`` rounds): drift
    and noise bursts then hit every candidate equally instead of
    penalizing whichever ran during the burst.  A candidate that raises
    during warmup is dropped (invalid on this device or shape); one that
    raises mid-round keeps its earlier times.  Returns each candidate
    that ran with its times, in the order given."""
    dev = runner.device
    live: list[tuple[dict[str, int], Any, list[float]]] = []
    for knobs in cands:
        fn = runner(knobs)
        try:
            for _ in range(max(warmup, 1)):
                fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except (RuntimeError, ValueError):
            continue                       # candidate invalid here
        live.append((knobs, fn, []))
    for _ in range(max(iters, 1)):
        for knobs, fn, t in live:
            try:
                t.append(_seconds(fn, dev))
            except (RuntimeError, ValueError):
                pass
    return [(knobs, t) for knobs, _, t in live if t]


def _sweep(runner: _Runner, cands: list[dict[str, int]], warmup: int,
           iters: int) -> tuple[float, dict[str, int]] | None:
    """The fastest ``(seconds, knobs)`` of ``_times`` by each candidate's
    min, or None when nothing ran."""
    timed = _times(runner, cands, warmup, iters)
    if not timed:
        return None
    knobs, t = min(timed, key=lambda e: min(e[1]))
    return (min(t), knobs)


def _duel(runner: _Runner, winner: dict[str, int], default: dict[str, int],
          warmup: int, iters: int, margin: bool = False) -> bool:
    """Head-to-head re-measurement of the sweep winner against the default.
    True iff the winner is faster, i.e. the sweep result survives
    confirmation and deserves the cache slot.  With ``margin`` it must be
    faster by more than the duel's own spread (the larger of the two
    candidates' max - min): the signing kinds' default, the launch's own
    pick, runs the same kernel as one of the explicit placements, and
    between those two only noise decides."""
    if not margin:
        best = _sweep(runner, [winner, default], warmup, iters)
        return best is not None and best[1] == winner
    timed = dict((tuple(sorted(kn.items())), t) for kn, t in _times(
        runner, [winner, default], warmup, iters))
    tw = timed.get(tuple(sorted(winner.items())))
    td = timed.get(tuple(sorted(default.items())))
    if not tw or not td:
        return bool(tw)
    spread = max(max(tw) - min(tw), max(td) - min(td))
    return min(tw) + spread < min(td)


def measure(kind: str, b: int, d: int, k: int, *, backend: str | None = None,
            nnz: int = 0, warmup: int = 1, iters: int = 3,
            candidates: tuple[dict[str, int], ...] | None = None,
            seed: int = 0, force: bool = False) -> dict[str, int]:
    """Sweep-and-cache on a miss: time every valid candidate at this shape
    and cache the winner; a cached winner is returned at once
    (``force=True`` re-sweeps), so an engine with ``autotune_measure`` pays
    for the sweep once a shape class, not once a batch.

    Default sweeps (``candidates=None``) put the default in the field (the
    signing kinds': in the duel only, taken by more than its spread) and
    re-duel the winner against it before caching; a winner that loses the
    duel is rejected (``autotune.guard_rejects``) and the default is cached
    instead.  Explicit ``candidates=`` bypass both the injection and the
    guard (the caller pins the field).  A cached winner comes back clamped
    to this shape (``_clamp``).

    ``nnz`` is the set positions a row: it sizes the synthetic signing
    inputs (0: 5% of D) and enters the sparse cache key."""
    backend = backend or default_backend()
    if not force:
        hit = cached(kind, b, d, k, backend, nnz)
        if hit is not None:
            obs_metrics.default().counter("autotune.hit").inc()
            return _clamp(kind, hit, b, d, k)
    obs_metrics.default().counter("autotune.sweeps").inc()
    sweep_t0 = time.perf_counter()
    runner = _make_runner(kind, b, d, k, nnz, seed, backend)
    guard = candidates is None
    dflt = default(kind, b, d, k)
    field: list[dict[str, int]] = []
    seen: set[tuple] = set()     # clamping can collapse candidates; time once
    # the signing default (-1) runs the kernel of one explicit placement:
    # it is not swept beside it, only held against the winner in the duel
    pool = candidates if not guard else _CANDIDATES[kind] if \
        kind in SIGNING else _CANDIDATES[kind] + (dflt,)
    for cand in pool:
        if not _valid(kind, cand, b, d, k):
            continue                 # not offered at this shape: not timed
        knobs = _clamp(kind, cand, b, d, k)
        key = tuple(sorted(knobs.items()))
        if key in seen:
            continue
        seen.add(key)
        field.append(knobs)
    best = _sweep(runner, field, warmup, iters)
    if best is not None:
        knobs = best[1]
        if guard and knobs != dflt and not _duel(
                runner, knobs, dflt, warmup, max(iters, 3),
                margin=kind in SIGNING):
            obs_metrics.default().counter("autotune.guard_rejects").inc()
            knobs = dflt
        best = (best[0], knobs)
    obs_metrics.default().histogram("autotune.sweep").observe(
        time.perf_counter() - sweep_t0)
    if best is None:
        return recommend(kind, b, d, k, backend, nnz)
    _cache[cache_key(kind, b, d, k, backend, nnz)] = dict(best[1])
    path = _cache_path()
    if path:
        _save_file(path)
    return dict(best[1])


def resolve(kind: str, b: int, d: int, k: int, backend: str, nnz: int = 0,
            **given: int | None) -> dict[str, int]:
    """The knobs of one launch: those ``given`` (not None) as they are, the
    rest from ``recommend`` (asked only when one is missing), as the
    reference's ``dispatch._resolve_blocks`` resolves block sizes."""
    if given and all(v is not None for v in given.values()):
        return {n: int(v) for n, v in given.items()}
    knobs = recommend(kind, b, d, k, backend, nnz)
    knobs.update({n: int(v) for n, v in given.items() if v is not None})
    return knobs
