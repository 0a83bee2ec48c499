"""Segment tables of the fused adjoint kernels' per-cell sums.

The fused adjoints (``csrc/fused_lw_bwd.cu``, ``csrc/fused_sw_bwd.cu``) run
one thread per g-point of a column. Every descriptor of a cell is read by
many g-points, so its cotangent is a sum over g-points: by band (the
cloud inputs), by flavor (feta and col_mix: a g-point's flavor is its
band's in the cell's atmosphere), by minor window (the minor scaling,
and each minor's share of feta at the minor's flavor), or over all of
them (ftemp, fpress, the SW Rayleigh scale). The kernels sum each
g-point's terms with segmented warp scans (``gas_optics_bwd.cuh::
CellSums``) over runs of consecutive g-points inside one warp, then add
the run sums of each output in a fixed order. This module builds, once
per k-distribution, the tables that say which runs there are and which
runs each output adds; any band layout works (ragged, reordered, or not
aligned with the 32-lane warps), and a minor window may cross a warp.

Table layout (one int32 array, read by ``CellSums::init``):

  * header (``HEADER`` ints): nslot, nrun_band, nrun_minor, span_band,
    span_minor, nband, threads, csr_len;
  * per thread (``threads`` = ngpt rounded up to 32): the band-run code,
    then for each minor slot k its run code and its minor (-1: none);
    a code is ``back | (run + 1) << 5`` on the last lane of a run and
    ``back`` elsewhere, ``back`` the lanes back to the run's first;
  * the output lists (``csr_len`` ints, offsets relative to their
    start): band_first (nband + 1), flav_first per atmosphere (nflav + 1
    each), minor_flav_first (nflav + 1), minor_first (nminor + 1), then
    the run ids they delimit.

A band run is a maximal run of consecutive g-points in one warp with the
same band and the same flavor in both atmospheres. Slot k of a g-point
holds the k-th minor (in minor order) whose window holds it, so its
minors are visited in the order the forward kernels add them; a minor
run is a maximal run of one minor in one slot and one warp.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["WARP", "HEADER", "Segments", "build_segments", "segments_on"]

WARP = 32
HEADER = 8


class Segments(NamedTuple):
    table: np.ndarray      # int32, layout in the module docstring
    nslot: int             # minor slots
    nrun_band: int
    nrun_minor: int


def _runs(keys, threads, valid):
    """Runs of equal keys among consecutive valid g-points inside one
    warp: per thread its code (``back | (run + 1) << 5`` on a run's last
    lane) and the runs' (first, last, key)."""
    codes = np.zeros(threads, np.int64)
    runs = []
    start = None
    for g in range(threads):
        if not valid[g]:
            start = None
            continue
        if start is None or g % WARP == 0 or keys[g] != keys[g - 1]:
            start = g
        back = g - start
        last = (g + 1 == threads or (g + 1) % WARP == 0 or not valid[g + 1]
                or keys[g + 1] != keys[g])
        codes[g] = back
        if last:
            codes[g] |= (len(runs) + 1) << 5
            runs.append((start, g, keys[g]))
    return codes, runs


def _csr(groups):
    """first (len(groups) + 1 offsets) and the concatenated members."""
    first = np.cumsum([0] + [len(x) for x in groups])
    members = [r for x in groups for r in x]
    return first, members


def build_segments(gpt2band, gflav, minors, nflav: int) -> Segments:
    """The tables of one k-distribution: ``gpt2band`` (ngpt,), ``gflav``
    (2, ngpt) (the flavor of each g-point in the lower and upper
    atmosphere), ``minors`` the rows (lower, flavor, g0, width, start) of
    ``minor_meta``, ``nflav`` the flavors of the descriptors."""
    g2b = np.asarray(gpt2band, np.int64).reshape(-1)
    gfl = np.asarray(gflav, np.int64).reshape(2, -1)
    ngpt = g2b.size
    if gfl.shape[1] != ngpt:
        raise ValueError(f"gflav has {gfl.shape[1]} g-points, gpt2band "
                         f"{ngpt}")
    threads = (ngpt + WARP - 1) // WARP * WARP
    nband = int(g2b.max()) + 1 if ngpt else 0
    if ngpt and (g2b.min() < 0 or gfl.min() < 0 or gfl.max() >= nflav):
        raise ValueError("gpt2band or gflav out of range")
    valid = np.arange(threads) < ngpt
    key = [(int(g2b[g]), int(gfl[0, g]), int(gfl[1, g])) if valid[g]
           else None for g in range(threads)]
    band_code, band_runs = _runs(key, threads, valid)

    # minor slots: the minors whose window holds g, in minor order
    cover = [[] for _ in range(threads)]
    for m, (_, f, g0, w, _) in enumerate(minors):
        if not 0 <= f < nflav or g0 < 0 or g0 + w > ngpt:
            raise ValueError(f"minor {m} (flavor {f}, g-points {g0}.."
                             f"{g0 + w - 1}) out of range")
        for g in range(g0, g0 + w):
            cover[g].append(m)
    nslot = max((len(c) for c in cover), default=0)
    slot_code, slot_minor, minor_runs = [], [], []
    for k in range(nslot):
        mk = np.array([c[k] if len(c) > k else -1 for c in cover])
        codes, runs = _runs(list(mk), threads, mk >= 0)
        # this slot's run ids follow the earlier slots'
        last = codes >> 5
        codes = np.where(last > 0, (codes & 31) | ((last + len(minor_runs))
                                                   << 5), codes)
        slot_code.append(codes)
        slot_minor.append(mk)
        minor_runs += runs

    nminor = len(minors)
    band_lists = [[r for r, (_, _, k) in enumerate(band_runs) if k[0] == b]
                  for b in range(nband)]
    flav_lists = [[[r for r, (_, _, k) in enumerate(band_runs)
                    if k[1 + a] == f] for f in range(nflav)]
                  for a in range(2)]
    mflav_lists = [[r for r, (_, _, m) in enumerate(minor_runs)
                    if minors[m][1] == f] for f in range(nflav)]
    minor_lists = [[r for r, (_, _, mm) in enumerate(minor_runs) if mm == m]
                   for m in range(nminor)]
    parts = [_csr(band_lists), _csr(flav_lists[0]), _csr(flav_lists[1]),
             _csr(mflav_lists), _csr(minor_lists)]
    nfirst = sum(len(first) for first, _ in parts)
    firsts, members, at = [], [], nfirst
    for first, mem in parts:
        firsts.append(first + at)
        members += mem
        at += len(mem)
    csr = np.concatenate(firsts + [np.asarray(members, np.int64)])
    span = lambda runs: max((b - a + 1 for a, b, _ in runs), default=1)
    header = [nslot, len(band_runs), len(minor_runs), span(band_runs),
              span(minor_runs), nband, threads, csr.size]
    per_thread = [band_code]
    for k in range(nslot):
        per_thread += [slot_code[k], slot_minor[k]]
    table = np.concatenate([np.asarray(header, np.int64)] + per_thread
                           + [csr]).astype(np.int32)
    return Segments(table, nslot, len(band_runs), len(minor_runs))


# tables by k-distribution: keyed by the id of its gpoint_flavor tensor,
# checked against weak references to it and to the gpt2band tensor, and
# dropped when the gpoint_flavor tensor is
_CACHE = {}


def segments_on(gpt2band: torch.Tensor, gflav: torch.Tensor, minors,
                nflav: int):
    """(:class:`Segments`, its table as an int32 tensor on the tensors'
    device), built on first use for this k-distribution's tensors (one
    copy of gpt2band and gflav to the host) and kept while they live."""
    key = id(gflav)
    hit = _CACHE.get(key)
    if hit is not None:
        fref, bref, mins, nf, segs, dev_table = hit
        if (fref() is gflav and bref() is gpt2band and mins == tuple(minors)
                and nf == nflav):
            return segs, dev_table
    segs = build_segments(gpt2band.cpu().numpy(), gflav.cpu().numpy(),
                          tuple(minors), nflav)
    dev_table = torch.as_tensor(segs.table, device=gflav.device)
    _CACHE[key] = (weakref.ref(gflav), weakref.ref(gpt2band), tuple(minors),
                   nflav, segs, dev_table)
    weakref.finalize(gflav, _CACHE.pop, key, None)
    return segs, dev_table
