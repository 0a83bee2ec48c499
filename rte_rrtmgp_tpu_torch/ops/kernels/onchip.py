"""The on-chip geometry of the kernels that hold their transport in shared
memory: the fused LW and SW steps (``csrc/fused_lw.cu``,
``csrc/fused_sw.cu``), the LW no-scattering solve of the public and
staged paths (``csrc/solver_lw.cu``, all three launchers), the LW
two-stream solve (``csrc/solver_lw_2str.cu``), the SW two-stream solve of
the public and staged paths (``csrc/solver_sw.cu``, all three launchers)
and its adjoint (``csrc/solver_sw_bwd.cu``), and the LW no-scattering
solve's adjoint (``csrc/solver_lw_bwd.cu``).

A column's g-points are cut into chunks of ``chunk`` g-points, one thread
block per chunk, and the column's chunks form one thread-block cluster
(at most 8 blocks, the portable cluster size; the LW adjoint's blocks
share nothing and launch without one). A block keeps its chunk's layer
fields and its partial sums in shared memory, at most
:data:`SMEM_LIMIT` bytes, so the column height is bounded: past it
:func:`onchip_geometry` raises, and no other kernel takes over.

The sums are fixed-order: per level (the adjoint: per layer), each block
sums its chunk's g-points (broadband: warp by warp; by band: each band's
g-points of the chunk in ascending order), and the cluster adds the
blocks' partials in rank order (``transport.cuh::ClusterSums``).
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["SMEM_LIMIT", "MAX_CHUNKS", "THREADS", "Geometry",
           "onchip_geometry"]

# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# the portable thread-block cluster size
MAX_CHUNKS = 8
# threads per block: chunk g-points x layer lanes
THREADS = 256
# fields each kernel sums: SW up, diffuse dn, dir; LW up, dn (the LW
# no-scattering solve also its broadband Jacobian where asked for); the SW
# adjoint the mu0 cotangent of each layer and the beam's seed at the top;
# the LW adjoint none
_FIELDS = {"fused_lw": 2, "fused_sw": 3, "lw_2stream": 2, "solver_lw": 2,
           "solver_sw": 3, "solver_sw_bwd": 2, "solver_lw_bwd": 0}
# layers the ring sweeps load ahead (transport.cuh::kRingAhead)
_RING_AHEAD = 4


class Geometry(NamedTuple):
    chunk: int       # g-points per block (32, 64 or 128)
    nchunk: int      # blocks per column: the cluster size
    threads: int     # threads per block
    smem: int        # bytes of shared memory per block


def _sums_bytes(nf: int, lanes: int, nlev: int, nband: int) -> int:
    """transport.cuh::ClusterSums::bytes: by band the chunk's band sums
    of each field and level and its band lists (members, each g-point's
    band, the bands' offsets), broadband each warp's level sums."""
    if nband > 0:
        return 4 * (nf * nband * nlev + 2 * lanes + nband + 1)
    return 4 * nf * (lanes // 32) * nlev


def _smem(kernel: str, nlay: int, chunk: int, nband: int, nminor: int,
          rescale: bool = False, jacobian: bool = False,
          pfrac: bool = False) -> int:
    """The launchers' smem_bytes (csrc/fused_lw.cu, fused_sw.cu,
    solver_lw.cu, solver_lw_2str.cu, solver_sw.cu, solver_sw_bwd.cu,
    solver_lw_bwd.cu)."""
    if kernel == "solver_lw_bwd":
        # per (layer, g-point) tau * ds (then the top level's term), the
        # down source (then the forward down radiance), the up source
        # (then the up radiance, then the bottom level's coefficient) and
        # the sweeps' two cotangents R and D, after _RING_AHEAD padding
        # rows, and lev (nlay + 1 rows); per level the column's two flux
        # cotangents
        return 4 * (chunk * (6 * nlay + 1 + _RING_AHEAD) + 2 * (nlay + 1))
    if kernel == "solver_lw":
        # per (layer, g-point) the transmittance (then the Jacobian's
        # flux), the down source (then the down flux) and the up source
        # (then the up flux); with rescaling Tang's cn and the radiance at
        # the layer top (then the up flux); with pfrac the Planck
        # fraction; each layer's row padded by one, each field padded by
        # 4 rows at either end (the sweeps' loads 4 layers ahead); per
        # g-point the top level's down flux, the surface's up flux and
        # Jacobian and the surface source; the sums: up and dn (by band),
        # the Jacobian broadband
        nlev = nlay + 1
        fields = (5 if rescale else 4 if pfrac else 3) * (
            nlay + 2 * _RING_AHEAD)
        if nband > 0:
            sums = _sums_bytes(2, chunk, nlev, nband) + (
                _sums_bytes(1, chunk, nlev, 0) if jacobian else 0)
        else:
            sums = _sums_bytes(2 + jacobian, chunk, nlev, 0)
        return 4 * (fields * (chunk + 1) + 4 * chunk) + sums
    if kernel == "solver_sw_bwd":
        # per (layer, g-point) rdif, tdif, rdir, tdir as a float4 and tns
        # (then their cotangents), the adding denominator and the A-F
        # cotangent; per (level, g-point) the beam, the adding albedo and
        # source and the diffuse flux (then the A-U cotangents); per level
        # the column's three flux cotangents; the warp sums of the mu0
        # cotangent and of the beam's seed, per layer
        return (28 * nlay * chunk + 16 * (nlay + 1) * chunk
                + 12 * (nlay + 1)
                + _sums_bytes(_FIELDS[kernel], chunk, nlay, 0))
    sums = _sums_bytes(_FIELDS[kernel], chunk, nlay + 1, nband)
    # per g-point a bit mask of the minors over it; the minors' metadata
    minors = 4 * (-(-nminor // 32)) * chunk + 4 * 5 * nminor
    if kernel == "fused_lw":
        # per (layer, g-point) tau then the transmittance, the Planck
        # fraction then the down source then the down flux, and the up
        # source; per (level, g-point) the Planck level source then the up
        # flux; per g-point the top level's down flux and the surface
        # source; the column's totplnk positions of its levels, layers and
        # surface
        return (16 * nlay * chunk + 4 * chunk + 8 * chunk
                + 4 * (2 * nlay + 2) + minors + sums)
    # the top level's fluxes of each g-point
    top = 4 * _FIELDS[kernel] * chunk
    if kernel == "fused_sw":
        # per (layer, g-point) rdif, tdif, rdir, tdir as a float4 and tns
        return 20 * nlay * chunk + top + minors + sums
    if kernel == "solver_sw":
        # per (layer, g-point) rdif, tdif, rdir, tdir as a float4 and tns
        return 20 * nlay * chunk + top + sums
    # per (layer, g-point) the four values of the adding build
    return 16 * nlay * chunk + top + sums


def onchip_geometry(kernel: str, nlay: int, ngpt: int, nband: int = 0,
                    nminor: int = 0, *, rescale: bool = False,
                    jacobian: bool = False, pfrac: bool = False) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    ``kernel`` ("fused_lw", "fused_sw", "solver_lw", "lw_2stream",
    "solver_sw", "solver_sw_bwd" or "solver_lw_bwd") at nlay layers and
    ngpt g-points, with per-band sums over ``nband`` bands (0: broadband;
    the adjoints take broadband cotangents only), for the fused steps
    nminor minor gases,
    and for "solver_lw" its variant: Tang ``rescale``-ing, the surface
    ``jacobian``, the in-kernel Planck sources (``pfrac``).
    The chunk is the narrowest power of two from 32 up with at most
    :data:`MAX_CHUNKS` chunks. Raises ValueError where the g-points
    exceed 8 chunks of 128 or a block's fields exceed :data:`SMEM_LIMIT`,
    naming the tallest column that fits."""
    if kernel not in _FIELDS:
        raise ValueError(f"onchip_geometry: unknown kernel {kernel!r}")
    if nlay < 1 or ngpt < 1:
        raise ValueError(f"{kernel}: needs nlay >= 1 and ngpt >= 1, got "
                         f"{nlay} and {ngpt}")
    chunk = 32
    while chunk * MAX_CHUNKS < ngpt:
        chunk *= 2
    if chunk > 128:
        raise ValueError(f"{kernel}: {ngpt} g-points exceed {MAX_CHUNKS} "
                         "blocks of 128")
    if kernel != "solver_lw" and (rescale or jacobian or pfrac):
        raise ValueError(f"onchip_geometry: {kernel} has no variants")
    variant = dict(rescale=rescale, jacobian=jacobian, pfrac=pfrac)
    smem = _smem(kernel, nlay, chunk, nband, nminor, **variant)
    if smem > SMEM_LIMIT:
        s0 = _smem(kernel, 0, chunk, nband, nminor, **variant)
        per = _smem(kernel, 1, chunk, nband, nminor, **variant) - s0
        raise ValueError(
            f"{kernel}: {nlay} layers need {smem} B of shared memory per "
            f"block, more than the {SMEM_LIMIT} B a block may use; at "
            f"{ngpt} g-points (chunks of {chunk})"
            + (f" and {nband} bands" if nband else "")
            + f" the kernel takes at most {(SMEM_LIMIT - s0) // per} layers")
    return Geometry(chunk, -(-ngpt // chunk), THREADS, smem)
