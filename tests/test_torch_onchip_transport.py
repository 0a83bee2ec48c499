"""The on-chip geometry and summation order of the kernels that hold their
transport in shared memory (``ops/kernels/onchip.py``): the fused LW and
SW kernels, the LW no-scattering solver of the public and staged paths
(its three launchers and their variants) and its adjoint, the LW
two-stream kernel, the SW two-stream solver of the public and staged
paths and its adjoint, on the CPU.

The kernels cut a column's g-points into chunks, one thread block per
chunk and the column's chunks one thread-block cluster, keep the layer
fields in shared memory and sum over g-points in a fixed order: per level
(the adjoint's mu0 cotangent: per layer) each block's warps (broadband)
or each band's g-points of the chunk in ascending order (by band), then
the blocks in rank order. Here: the chunk widths, cluster sizes and
shared memory at the paths' widths, the limits (ValueError past them,
naming the tallest column), a numpy float32 replay of the summation
orders against a straight sum over g-points and, for the adjoint's mu0
cotangent, against the one-block warp order it had with its state in
device memory, and the wrappers' device scratch (none: the launchers get
their inputs and outputs only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_lw_inputs, build_allsky)
from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import solver_lanes  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused_scratch_bytes)
from rte_rrtmgp_tpu_torch.ops.kernels.onchip import (  # noqa: E402
    MAX_CHUNKS, SMEM_LIMIT, onchip_geometry)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (  # noqa: E402
    lw_2stream, lw_2stream_plain, lw_2stream_scratch_bytes)
from rte_rrtmgp_tpu_torch.optical_props import OpticalProps2str  # noqa: E402
from rte_rrtmgp_tpu_torch.rte import rte_sw  # noqa: E402
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402

# (kernel, nlay, ngpt, nband, nminor) -> (chunk, nchunk, threads, smem):
# the flagship widths (SW 224 g-points / 28 minors, LW 256), by band
# (14 / 16 bands), the non-banded widths (168 / 192) and 1024 g-points.
# smem by hand: SW 20 B x nlay x chunk (rdif, tdif, rdir, tdir, tns) +
# 12 B x chunk (the top level's fluxes) + 4 B x chunk per 32 minors (the
# g-points' minor masks) + 20 B per minor + the sums; LW
# 16 B x nlay x chunk + 8 B x chunk + the sums; sums broadband 4 B x
# fields x warps x levels, by band 4 B x (fields x bands x levels + 2 x
# chunk + bands + 1); the SW solver as the fused SW kernel without the
# minors; its adjoint 28 B x nlay x chunk (rdif, tdif, rdir, tdir, tns,
# the adding denominator, the A-F cotangent) + 16 B x (nlay + 1) x chunk
# (the beam, adding albedo and source and diffuse flux at each level) +
# 12 B x (nlay + 1) (the column's flux cotangents) + 4 B x 2 fields (the
# mu0 cotangent, the beam's seed) x warps x layers (the sums); the fused
# LW kernel 16 B x nlay x chunk (tau then trans, the Planck fraction then
# sdn then the down flux, sup, and per level the Planck source then the up
# flux) + 4 B x chunk (the bottom level) + 8 B x chunk (the top level's
# down flux, the surface source) + 4 B x (2 nlay + 2) (the column's totplnk
# positions) + the minors' masks and metadata as the fused SW kernel + the
# sums (2 fields)
GEOMETRY = {
    ("fused_lw", 72, 256, 0, 28): (
        32, 8, 256, 36864 + 128 + 256 + 584 + 128 + 560 + 4 * 2 * 73),
    ("fused_lw", 72, 256, 16, 28): (
        32, 8, 256,
        36864 + 128 + 256 + 584 + 128 + 560 + 4 * (2 * 16 * 73 + 81)),
    ("fused_lw", 72, 192, 0, 28): (
        32, 6, 256, 36864 + 128 + 256 + 584 + 128 + 560 + 4 * 2 * 73),
    ("fused_lw", 72, 192, 16, 28): (
        32, 6, 256,
        36864 + 128 + 256 + 584 + 128 + 560 + 4 * (2 * 16 * 73 + 81)),
    ("fused_lw", 72, 1024, 0, 28): (
        128, 8, 256,
        147456 + 512 + 1024 + 584 + 512 + 560 + 4 * 2 * 4 * 73),
    ("fused_sw", 72, 224, 0, 28): (32, 7, 256,
                                   46080 + 384 + 128 + 560 + 876),
    ("fused_sw", 72, 224, 14, 28): (
        32, 7, 256, 46080 + 384 + 128 + 560 + 4 * (3 * 14 * 73 + 79)),
    ("fused_sw", 72, 168, 0, 28): (32, 6, 256,
                                   46080 + 384 + 128 + 560 + 876),
    ("fused_sw", 72, 1024, 0, 28): (
        128, 8, 256, 184320 + 1536 + 512 + 560 + 4 * 3 * 4 * 73),
    ("lw_2stream", 72, 256, 0, 0): (32, 8, 256, 36864 + 256 + 584),
    ("lw_2stream", 72, 256, 16, 0): (
        32, 8, 256, 36864 + 256 + 4 * (2 * 16 * 73 + 81)),
    ("lw_2stream", 72, 192, 0, 0): (32, 6, 256, 36864 + 256 + 584),
    ("lw_2stream", 72, 257, 0, 0): (64, 5, 256,
                                    73728 + 512 + 4 * 2 * 2 * 73),
    ("lw_2stream", 72, 1024, 0, 0): (128, 8, 256,
                                     147456 + 1024 + 4 * 2 * 4 * 73),
    ("lw_2stream", 9, 24, 3, 0): (32, 1, 256,
                                  4608 + 256 + 4 * (2 * 3 * 10 + 68)),
    ("solver_sw", 72, 224, 0, 0): (32, 7, 256, 46080 + 384 + 876),
    ("solver_sw", 72, 224, 14, 0): (
        32, 7, 256, 46080 + 384 + 4 * (3 * 14 * 73 + 79)),
    ("solver_sw", 72, 168, 0, 0): (32, 6, 256, 46080 + 384 + 876),
    ("solver_sw", 72, 168, 14, 0): (
        32, 6, 256, 46080 + 384 + 4 * (3 * 14 * 73 + 79)),
    ("solver_sw", 72, 1024, 0, 0): (128, 8, 256,
                                    184320 + 1536 + 4 * 3 * 4 * 73),
    ("solver_sw_bwd", 72, 224, 0, 0): (32, 7, 256,
                                       64512 + 37376 + 876 + 576),
    ("solver_sw_bwd", 72, 168, 0, 0): (32, 6, 256,
                                       64512 + 37376 + 876 + 576),
    ("solver_sw_bwd", 40, 1024, 0, 0): (128, 8, 256,
                                        143360 + 83968 + 492 + 1280),
}
# the tallest column that fits: (kernel, ngpt, nband, nminor) -> nlay
TALLEST = {("fused_lw", 256, 0, 28): 438,      # 528 nlay + 1088 B
           ("fused_lw", 256, 16, 28): 356,     # 648 nlay + 1532 B
           ("fused_lw", 192, 0, 28): 438,      # 528 nlay + 1088 B
           ("fused_lw", 1024, 0, 28): 110,     # 2088 nlay + 2648 B
           ("fused_sw", 224, 0, 28): 354,      # 652 nlay + 1084 B
           ("fused_sw", 224, 14, 28): 285,     # 808 nlay + 1556 B
           ("lw_2stream", 256, 0, 0): 446,     # 520 nlay + 264 B
           ("lw_2stream", 256, 16, 0): 362,    # 640 nlay + 708 B
           ("lw_2stream", 1024, 0, 0): 111,    # 2080 nlay + 1056 B
           ("solver_sw", 224, 0, 0): 355,      # 652 nlay + 396 B
           ("solver_sw", 224, 14, 0): 286,     # 808 nlay + 868 B
           ("solver_sw", 1024, 0, 0): 88,      # 2608 nlay + 1548 B
           ("solver_sw_bwd", 224, 0, 0): 162,  # 1428 nlay + 524 B
           ("solver_sw_bwd", 1024, 0, 0): 40}  # 5676 nlay + 2060 B


# the LW no-scattering solver, (nlay, ngpt, nband, rescale, jacobian,
# pfrac) -> (chunk, nchunk, threads, smem): the flagship's 256 g-points /
# 16 bands, the SW width 224, the non-banded 192, 1024 and the g24 case.
# smem by hand: 12 B x (nlay + 8) x (chunk + 1) (the transmittance, the
# down and up sources, then the fluxes; each layer's row padded by one,
# each field by 4 rows at either end for the sweeps' loads 4 layers
# ahead), 20 B with rescaling (Tang's cn, the radiance at the layer top),
# 16 B with pfrac (the Planck fraction); 16 B x chunk (the top level's
# down flux, the surface's up flux and Jacobian, the surface source); the
# sums of up and dn, and the Jacobian's broadband: broadband 4 B x fields
# x warps x levels, by band 4 B x (2 x bands x levels + 2 x chunk + bands
# + 1) + the Jacobian's 4 B x warps x levels
SOLVER_LW = {
    (72, 256, 0, False, False, False): (32, 8, 256, 31680 + 512 + 584),
    (72, 256, 16, False, False, False): (
        32, 8, 256, 31680 + 512 + 4 * (2 * 16 * 73 + 81)),
    (72, 256, 0, False, True, False): (32, 8, 256, 31680 + 512 + 876),
    (72, 256, 16, False, True, False): (
        32, 8, 256, 31680 + 512 + 4 * (2 * 16 * 73 + 81) + 292),
    (72, 256, 0, True, False, False): (32, 8, 256, 52800 + 512 + 584),
    (72, 256, 0, True, True, False): (32, 8, 256, 52800 + 512 + 876),
    (72, 256, 16, True, True, False): (
        32, 8, 256, 52800 + 512 + 4 * (2 * 16 * 73 + 81) + 292),
    (72, 256, 0, False, False, True): (32, 8, 256, 42240 + 512 + 584),
    (72, 224, 0, False, False, False): (32, 7, 256, 31680 + 512 + 584),
    (72, 192, 0, False, False, False): (32, 6, 256, 31680 + 512 + 584),
    (72, 192, 16, False, False, False): (
        32, 6, 256, 31680 + 512 + 4 * (2 * 16 * 73 + 81)),
    (72, 192, 0, True, True, False): (32, 6, 256, 52800 + 512 + 876),
    (72, 192, 0, False, False, True): (32, 6, 256, 42240 + 512 + 584),
    (72, 1024, 0, False, False, False): (128, 8, 256,
                                         123840 + 2048 + 4 * 2 * 4 * 73),
    (9, 24, 3, False, False, False): (32, 1, 256,
                                      6732 + 512 + 4 * (2 * 3 * 10 + 68)),
}
# its tallest column: (ngpt, nband, rescale, jacobian, pfrac) -> nlay
SOLVER_LW_TALLEST = {
    (256, 0, False, False, False): 566,    # 404 nlay + 3688 B
    (256, 16, False, False, False): 435,   # 524 nlay + 4132 B
    (256, 0, False, True, False): 560,     # 408 nlay + 3692 B
    (256, 0, True, True, False): 337,      # 672 nlay + 5804 B
    (256, 16, True, True, False): 285,     # 792 nlay + 6248 B
    (256, 0, False, False, True): 424,     # 536 nlay + 4744 B
    (1024, 0, False, False, False): 137,   # 1580 nlay + 14464 B
}


# the LW solve's adjoint, (nlay, ngpt) -> (chunk, nchunk, threads, smem):
# the flagship's 256 g-points, the SW width 224, the g24 case and 1024.
# smem by hand: 4 B x chunk x (6 nlay + 1 + 4) (tau * ds, the down and up
# sources and the sweeps' two cotangents, nlay rows each; lev, nlay + 1;
# 4 padding rows before the swept fields for the up sweep's loads 4
# layers ahead) + 8 B x (nlay + 1) (the column's two flux cotangents); no
# sums, no cluster
SOLVER_LW_BWD = {(72, 256): (32, 8, 256, 128 * 437 + 584),
                 (72, 224): (32, 7, 256, 128 * 437 + 584),
                 (12, 24): (32, 1, 256, 128 * 77 + 104),
                 (72, 1024): (128, 8, 256, 512 * 437 + 584)}
# its tallest column: ngpt -> nlay
SOLVER_LW_BWD_TALLEST = {256: 298,     # 776 nlay + 648 B
                         1024: 74}     # 3080 nlay + 2568 B


@pytest.mark.parametrize("case", sorted(SOLVER_LW_BWD), ids=str)
def test_solver_lw_bwd_geometry(case):
    """onchip_geometry("solver_lw_bwd", ...): the narrowest chunk with at
    most 8 per column, no idle block, and the launcher's shared memory
    (smem_solver_lw_bwd, whose count chip_smoke.py holds this one to on
    the card), pinned by hand."""
    nlay, ngpt = case
    geo = onchip_geometry("solver_lw_bwd", nlay, ngpt)
    assert tuple(geo) == SOLVER_LW_BWD[case]
    assert geo == solver_lw_bwd.lw_noscat_bwd_geometry(nlay, ngpt)
    assert geo.nchunk <= MAX_CHUNKS and geo.chunk * geo.nchunk >= ngpt
    assert geo.chunk * (geo.nchunk - 1) < ngpt
    assert geo.smem <= SMEM_LIMIT


@pytest.mark.parametrize("ngpt", sorted(SOLVER_LW_BWD_TALLEST))
def test_solver_lw_bwd_tallest_column_and_past_it(ngpt):
    """The tallest column the adjoint holds, at least 200 layers at the
    flagship's 256 g-points (the repository's configurations have 61-72);
    one layer more raises, naming the limit. It has no variants."""
    nlay = SOLVER_LW_BWD_TALLEST[ngpt]
    geo = onchip_geometry("solver_lw_bwd", nlay, ngpt)
    assert geo.smem <= SMEM_LIMIT
    assert SOLVER_LW_BWD_TALLEST[256] >= 200
    with pytest.raises(ValueError, match=f"at most {nlay} layers"):
        onchip_geometry("solver_lw_bwd", nlay + 1, ngpt)
    with pytest.raises(ValueError, match="no variants"):
        onchip_geometry("solver_lw_bwd", 72, ngpt, rescale=True)


def _lw_bwd_args(rng, ncol, nlay, ngpt):
    """lw_noscat_bwd's arguments on seeded inputs: optical depths from
    1e-6 to 10, sources, surface, incident flux and flux cotangents."""
    u = lambda lo, hi, *s: torch.from_numpy(rng.uniform(lo, hi, s).astype(
        np.float32))
    lay3, bc = (ncol, nlay, ngpt), (ncol, ngpt)
    tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3)).astype(
        np.float32))
    return (tau, u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, nlay + 1, ngpt),
            u(0.8, 1.0, *bc), u(0.5, 1.5, *bc), u(0.0, 0.5, *bc),
            u(0.5, 1.5, ncol, nlay + 1), u(0.5, 1.5, ncol, nlay + 1))


def _lw_bwd_cuda_branch(monkeypatch, calls):
    monkeypatch.setattr(solver_lw_bwd, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(solver_lw_bwd, "launch",
                        lambda *a: calls.append(a[3:]))


def test_lw_noscat_bwd_passes_no_scratch(monkeypatch):
    """The adjoint's wrapper hands its launcher the inputs, the six
    cotangents it returns and sizes only: no device scratch (the
    one-block kernel kept its forward radiance and up-sweep cotangent in
    the outputs' memory), and the chunk onchip_geometry gives it."""
    calls = []
    _lw_bwd_cuda_branch(monkeypatch, calls)
    ncol, nlay, ngpt = 3, 9, 40
    args = _lw_bwd_args(np.random.default_rng(10), ncol, nlay, ngpt)
    out = solver_lw_bwd.lw_noscat_bwd(*args, ds=1.66, weight=0.5)
    assert len(calls) == 1 and len(out) == 6
    given = {t.data_ptr() for t in args}
    returned = {o.data_ptr() for o in out}
    tensors = [a for a in calls[0] if isinstance(a, torch.Tensor)]
    assert len(tensors) == 14
    assert all(t.data_ptr() in given | returned for t in tensors)
    assert returned <= {t.data_ptr() for t in tensors}
    ints = [a for a in calls[0] if isinstance(a, int)]
    assert ints == [ncol, nlay, ngpt,
                    onchip_geometry("solver_lw_bwd", nlay, ngpt).chunk]
    assert solver_lw_bwd.lw_noscat_bwd_scratch_bytes(4096, 72, 256) == 0


def test_lw_noscat_bwd_raises_past_the_limit(monkeypatch):
    """On the CUDA branch a column one layer taller than the adjoint's
    block holds raises ValueError naming the limit, and nothing is
    launched; at the limit the launch goes ahead. On CPU tensors the twin
    of the taller call runs (no height limit), launching nothing, with
    finite cotangents of the inputs' shapes."""
    ngpt, ncol = 32, 2
    rng = np.random.default_rng(11)
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry("solver_lw_bwd", 10 ** 6, ngpt)
    top = int(str(e.value).split("at most ")[1].split()[0])
    fn = solver_lw_bwd.lw_noscat_bwd
    args = _lw_bwd_args(rng, ncol, top + 1, ngpt)
    n0 = fn.launches
    out = fn(*args, ds=1.66, weight=0.5)
    assert fn.launches == n0
    for o, a in zip(out, args):
        assert o.shape == a.shape and bool(torch.isfinite(o).all())
    calls = []
    _lw_bwd_cuda_branch(monkeypatch, calls)
    with pytest.raises(ValueError, match=f"at most {top} layers"):
        fn(*args, ds=1.66, weight=0.5)
    assert calls == []
    fn(*_lw_bwd_args(rng, ncol, top, ngpt), ds=1.66, weight=0.5)
    assert len(calls) == 1


def _lw_variant(rescale, jacobian, pfrac):
    return dict(rescale=rescale, jacobian=jacobian, pfrac=pfrac)


@pytest.mark.parametrize("case", sorted(SOLVER_LW), ids=str)
def test_solver_lw_geometry(case):
    """onchip_geometry("solver_lw", ...) of each variant: the narrowest
    chunk with at most 8 per column, no idle block, and the launcher's
    shared memory (smem_solver_lw, whose count chip_smoke.py holds this
    one to on the card), pinned by hand."""
    nlay, ngpt, nband = case[:3]
    geo = onchip_geometry("solver_lw", nlay, ngpt, nband,
                          **_lw_variant(*case[3:]))
    assert tuple(geo) == SOLVER_LW[case]
    assert geo == solver_lw.lw_noscat_geometry(nlay, ngpt, nband,
                                               **_lw_variant(*case[3:]))
    assert geo.nchunk <= MAX_CHUNKS and geo.chunk * geo.nchunk >= ngpt
    assert geo.chunk * (geo.nchunk - 1) < ngpt
    assert geo.smem <= SMEM_LIMIT


@pytest.mark.parametrize("case", sorted(SOLVER_LW_TALLEST), ids=str)
def test_solver_lw_tallest_column_and_past_it(case):
    """The tallest column each variant's narrowest chunk holds; one layer
    more raises, naming the limit. The variants' flags belong to
    solver_lw alone."""
    ngpt, nband = case[:2]
    v = _lw_variant(*case[2:])
    nlay = SOLVER_LW_TALLEST[case]
    geo = onchip_geometry("solver_lw", nlay, ngpt, nband, **v)
    assert geo.smem <= SMEM_LIMIT
    with pytest.raises(ValueError, match=f"at most {nlay} layers"):
        onchip_geometry("solver_lw", nlay + 1, ngpt, nband, **v)
    with pytest.raises(ValueError, match="no variants"):
        onchip_geometry("solver_sw", 72, ngpt, rescale=True)


@pytest.mark.parametrize("case", sorted(GEOMETRY), ids=str)
def test_geometry_at_path_widths(case):
    geo = onchip_geometry(*case)
    assert tuple(geo) == GEOMETRY[case]
    kernel, _, ngpt = case[:3]
    assert geo.nchunk <= MAX_CHUNKS and geo.chunk * geo.nchunk >= ngpt
    assert geo.chunk * (geo.nchunk - 1) < ngpt    # no idle block
    assert geo.smem <= SMEM_LIMIT


@pytest.mark.parametrize("case", sorted(TALLEST), ids=str)
def test_tallest_column_and_past_it(case):
    """The narrowest chunk holds the tallest column; one layer more
    raises, naming the limit."""
    kernel, ngpt, nband, nminor = case
    nlay = TALLEST[case]
    geo = onchip_geometry(kernel, nlay, ngpt, nband, nminor)
    assert geo.smem <= SMEM_LIMIT
    assert geo.chunk == onchip_geometry(kernel, 1, ngpt, nband,
                                        nminor).chunk
    with pytest.raises(ValueError, match=f"at most {nlay} layers"):
        onchip_geometry(kernel, nlay + 1, ngpt, nband, nminor)


@pytest.mark.parametrize("ngpt", [1025, 2048])
def test_too_many_gpoints_raise(ngpt):
    for kernel in ("fused_lw", "fused_sw", "lw_2stream", "solver_sw",
                   "solver_sw_bwd", "solver_lw_bwd"):
        with pytest.raises(ValueError, match="g-points exceed"):
            onchip_geometry(kernel, 72, ngpt)


def test_wrappers_allocate_no_scratch():
    """The fused SW step and the LW two-stream solve keep their layer
    fields on chip: no device scratch (in device memory they would take
    6 x (nlay + 1) x ngpt floats per column, 1.61 and 1.84 GB at 4096 x
    72)."""
    assert sw_fused_scratch_bytes(4096, 72, 224) == 0
    assert lw_2stream_scratch_bytes(4096, 72, 256) == 0
    assert solver_sw.sw_2stream_scratch_bytes(4096, 72, 224) == 0
    assert solver_sw_bwd.sw_2stream_bwd_scratch_bytes(4096, 72, 224) == 0


def _lw_fused_inputs(variant, nlay=9, ncol=3):
    """The fused LW step's inputs on the CPU (the allsky problem at LW 40
    g-points / 5 bands, SW 32 / 4), broadband, by band, with a non-zero
    incident flux or without clouds."""
    p = build_allsky(ncol, nlay, 40, 5, 32, 4, 6, 11, device="cpu")
    x = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
    if variant == "byband":
        x = x._replace(byband=True)
    elif variant == "inc":
        x = x._replace(inc=torch.from_numpy(np.random.default_rng(4).uniform(
            0.5, 1.5, tuple(x.inc.shape)).astype(np.float32)))
    elif variant == "clear":
        x = x._replace(cloud_tau_abs=None)
    return x


@pytest.mark.parametrize("variant", ["broadband", "byband", "inc", "clear"])
def test_fused_lw_wrapper_passes_no_scratch(variant, monkeypatch):
    """The fused LW step's wrapper hands its launcher the inputs, the
    outputs it returns and sizes only: no device scratch (the parent took a
    (2, ncol, nlay, ngpt) scratch, 0.60 GB at 4096 x 72). The CUDA branch
    is taken on CPU tensors with the launch replaced by a record of its
    arguments; the chunk passed is onchip_geometry's."""
    calls = []
    monkeypatch.setattr(fused_lw, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(fused_lw, "launch", lambda *a: calls.append(a[3:]))
    x = _lw_fused_inputs(variant)
    up, dn = fused_lw._lw_fused_kernel(x)
    assert len(calls) == 1
    given = {t.data_ptr() for t in x + tuple(x.co)
             if isinstance(t, torch.Tensor)}
    returned = {up.data_ptr(), dn.data_ptr()}
    tensors = [a for a in calls[0] if isinstance(a, torch.Tensor)]
    tropo = x.co.tropo.to(torch.int32)     # the launcher's copy of a mask
    assert all(t.data_ptr() in given | returned
               or (t.dtype == torch.int32 and torch.equal(t, tropo))
               for t in tensors)
    assert returned <= {t.data_ptr() for t in tensors}
    nlay, ngpt = x.tlay.shape[0], x.kmajor.shape[3]
    nband = x.totplnk.shape[1] if x.byband else 0
    ints = [a for a in calls[0] if isinstance(a, int)]
    assert ints[-1] == onchip_geometry("fused_lw", nlay, ngpt, nband,
                                       len(x.minors)).chunk
    assert fused_lw.lw_fused_scratch_bytes(4096, 72, 256) == 0


@pytest.mark.parametrize("given", [True, False], ids=["built", "missing"])
def test_fused_lw_gather_table(given, monkeypatch):
    """The forward kernel gathers from kmajor and planck_frac interleaved
    as one table of pairs, built once per k-distribution by the gas optics
    (``GasOpticsRRTMGP.kmajor_pfrac``, reaching the inputs through
    ``allsky_lw_inputs``); the launcher gets it in place of the two. Inputs
    that carry no table raise on the CUDA branch, and nothing is
    launched."""
    calls = []
    monkeypatch.setattr(fused_lw, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(fused_lw, "launch", lambda *a: calls.append(a[3:]))
    x = _lw_fused_inputs("broadband")
    kp = x.kmajor_pfrac
    assert kp is not None and kp.is_contiguous()
    assert torch.equal(kp[..., 0], x.kmajor)
    assert torch.equal(kp[..., 1], x.planck_frac)
    if not given:
        with pytest.raises(ValueError, match="kmajor_pfrac is missing"):
            fused_lw._lw_fused_kernel(x._replace(kmajor_pfrac=None))
        assert calls == []
        return
    fused_lw._lw_fused_kernel(x)
    table = calls[0][10]
    assert table.data_ptr() == kp.data_ptr()
    assert table.shape == tuple(x.kmajor.shape) + (2,)
    assert not any(a is x.kmajor or a is x.planck_frac for a in calls[0])


@pytest.mark.parametrize("byband", [False, True], ids=["broadband", "byband"])
def test_fused_lw_raises_past_the_limit(byband, monkeypatch):
    """On the CUDA branch (taken here on CPU tensors, the launch replaced by
    a record) a column one layer taller than a block holds raises
    ValueError naming the limit, and nothing is launched; at the limit the
    launch goes ahead. The CPU twin of the taller call runs (no height
    limit) and gives finite fluxes of the right shape."""
    ngpt = 40
    x = _lw_fused_inputs("byband" if byband else "broadband", nlay=1,
                         ncol=2)
    nminor = len(x.minors)
    nband = x.totplnk.shape[1] if byband else 0
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry("fused_lw", 10 ** 6, ngpt, nband, nminor)
    top = int(str(e.value).split("at most ")[1].split()[0])
    taller = _lw_fused_inputs("byband" if byband else "broadband",
                              nlay=top + 1, ncol=2)
    n0 = fused_lw.lw_fused.launches
    up, dn = fused_lw.lw_fused(taller)        # the twin, at any height
    assert fused_lw.lw_fused.launches == n0
    shape = ((nband,) if byband else ()) + (top + 2, 2)
    assert up.shape == dn.shape == shape
    assert bool(torch.isfinite(up).all() and torch.isfinite(dn).all())
    calls = []
    monkeypatch.setattr(fused_lw, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(fused_lw, "launch", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match=f"at most {top} layers"):
        fused_lw.lw_fused(taller)
    assert calls == []
    fused_lw._lw_fused_kernel(_lw_fused_inputs(
        "byband" if byband else "broadband", nlay=top, ncol=2))
    assert len(calls) == 1


def _sw_args(rng, ncol, nlay, ngpt, lanes=False):
    """Seeded SW solver inputs, public layout (column, layer, g-point), or
    with ``lanes`` the lane layout (g-point, layer, column)."""
    u = lambda lo, hi, *s: torch.from_numpy(rng.uniform(lo, hi, s).astype(
        np.float32))
    lay = (ngpt, nlay, ncol) if lanes else (ncol, nlay, ngpt)
    bc = (ngpt, ncol) if lanes else (ncol, ngpt)
    mu = (nlay, ncol) if lanes else (ncol, nlay)
    inc = u(0.5, 2.0, *bc)
    return (u(0.0, 0.2, *lay), u(0.0, 0.9, *lay), u(0.0, 0.8, *lay),
            u(0.2, 0.9, *mu), u(0.0, 0.3, *bc), u(0.0, 0.3, *bc), inc,
            0.05 * inc)


@pytest.mark.parametrize("which", ["sw_2stream", "sw_2stream byband",
                                   "sw_2stream_lanes",
                                   "sw_2stream_lanes_combined",
                                   "sw_2stream_bwd"])
def test_sw_wrappers_pass_no_scratch(which, monkeypatch):
    """The SW solver's three wrappers and its adjoint's hand their
    launcher the inputs, the outputs they return and sizes only: no
    device scratch (the parent kernels took a (6, ncol, nlay + 1, ngpt)
    and a five-field scratch, 1.61 and 1.34 GB at 4096 x 72). The CUDA
    branch is taken on CPU tensors with the launch replaced by a record
    of its arguments; the chunk passed is onchip_geometry's."""
    calls = []
    for mod in (solver_sw, solver_lanes, solver_sw_bwd):
        monkeypatch.setattr(mod, "on_cpu", lambda t, what: False)
        monkeypatch.setattr(mod, "launch",
                            lambda *a: calls.append(a[3:]))
    rng = np.random.default_rng(5)
    ncol, nlay, ngpt = 3, 9, 40
    lanes = "lanes" in which
    args = _sw_args(rng, ncol, nlay, ngpt, lanes)
    kw = {}
    if which == "sw_2stream":
        out = solver_sw.sw_2stream(*args)
    elif which == "sw_2stream byband":
        args += (torch.arange(ngpt, dtype=torch.int32) // 10,)
        kw = dict(nband=4)
        out = solver_sw.sw_2stream(*args, **kw)
    elif which == "sw_2stream_lanes":
        out = solver_lanes.sw_2stream_lanes(*args)
    elif which == "sw_2stream_lanes_combined":
        cloud = tuple(torch.from_numpy(rng.uniform(0.0, 0.5, (4, nlay, ncol))
                                       .astype(np.float32)) for _ in range(3))
        args = args[:2] + (cloud,) + args[3:]
        kw = dict(gpt2band=torch.arange(ngpt, dtype=torch.int32) // 10)
        out = solver_lanes.sw_2stream_lanes_combined(*args, **kw)
        args += (kw.pop("gpt2band"),)
    else:
        args += tuple(torch.ones(ncol, nlay + 1) for _ in range(3))
        out = solver_sw_bwd.sw_2stream_bwd(*args)
    assert len(calls) == 1
    given = {t.data_ptr() for t in args if isinstance(t, torch.Tensor)}
    given |= {t.data_ptr() for a in args if isinstance(a, tuple)
              for t in a}
    returned = {o.untyped_storage().data_ptr() for o in out}
    for a in calls[0]:
        if isinstance(a, torch.Tensor):
            assert (a.data_ptr() in given
                    or a.untyped_storage().data_ptr() in returned)
    kernel = "solver_sw_bwd" if which == "sw_2stream_bwd" else "solver_sw"
    ints = [a for a in calls[0] if isinstance(a, int)]
    assert ints[-1] == onchip_geometry(kernel, nlay, ngpt,
                                       kw.get("nband", 0)).chunk


def test_cpu_twin_has_no_height_limit():
    """The limit is the kernel's: CPU tensors go to the twin at any
    height, and the kernel is not launched."""
    rng = np.random.default_rng(0)
    ncol, nlay, ngpt = 2, 500, 8
    t = lambda *s: torch.from_numpy(rng.uniform(0.0, 1.0, s).astype(
        np.float32))
    args = (0.1 * t(ncol, nlay, ngpt), 0.5 * t(ncol, nlay, ngpt),
            0.5 * t(ncol, nlay, ngpt), t(ncol, nlay, ngpt),
            t(ncol, nlay + 1, ngpt), t(ncol, ngpt), t(ncol, ngpt),
            t(ncol, ngpt))
    with pytest.raises(ValueError, match="at most"):
        onchip_geometry("lw_2stream", nlay, 256)
    n0 = lw_2stream.launches
    up, dn = lw_2stream(*args)
    assert lw_2stream.launches == n0
    ref = lw_2stream_plain(*args)
    assert torch.equal(up, ref[0]) and torch.equal(dn, ref[1])


@pytest.mark.parametrize("which", ["sw_2stream", "sw_2stream_lanes",
                                   "sw_2stream_lanes_combined",
                                   "sw_2stream_bwd"])
def test_sw_wrappers_raise_past_the_limit(which, monkeypatch):
    """On the CUDA branch (taken here on CPU tensors, the launch replaced
    by a record) a column one layer taller than a block holds raises
    ValueError naming the limit, and nothing is launched; the CPU twin of
    the same call runs."""
    calls = []
    ngpt = 32
    kernel = "solver_sw_bwd" if which == "sw_2stream_bwd" else "solver_sw"
    nlay = TALLEST[(kernel, 224, 0, 0)] + 1
    rng = np.random.default_rng(6)
    lanes = "lanes" in which
    args = _sw_args(rng, 2, nlay, ngpt, lanes)
    kw = {}
    if which == "sw_2stream_lanes_combined":
        args = args[:2] + (None,) + args[3:]
        kw = dict(gpt2band=torch.zeros(ngpt, dtype=torch.int32))
    if which == "sw_2stream_bwd":
        args += tuple(torch.ones(2, nlay + 1) for _ in range(3))
    mod = {"sw_2stream": solver_sw, "sw_2stream_bwd": solver_sw_bwd}.get(
        which, solver_lanes)
    fn = getattr(mod, which)
    assert len(fn(*args, **kw)) in (3, 8)      # the twin runs
    for m in (solver_sw, solver_lanes, solver_sw_bwd):
        monkeypatch.setattr(m, "on_cpu", lambda t, what: False)
        monkeypatch.setattr(m, "launch", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match=f"at most {nlay - 1} layers"):
        fn(*args, **kw)
    assert calls == []


def _lw_call(which, rng, ncol, nlay, ngpt):
    """(wrapper, args, kw, (rescale, jacobian, pfrac, nband)) of one LW
    no-scattering launcher and variant on seeded inputs: the public
    layout (``lw_noscat`` as the public path calls it, by band, rescaled
    with the Jacobian and a secant field) or the lane layout (plain,
    rescaled with the Jacobian, with in-kernel Planck sources)."""
    u = lambda lo, hi, *s: torch.from_numpy(rng.uniform(lo, hi, s).astype(
        np.float32))
    lay3, bc = (ncol, nlay, ngpt), (ncol, ngpt)
    tau, lay, lev = (u(0.0, 2.0, *lay3), u(0.5, 1.5, *lay3),
                     u(0.5, 1.5, ncol, nlay + 1, ngpt))
    emis, sfc, inc = u(0.8, 1.0, *bc), u(0.5, 1.5, *bc), u(0.0, 0.5, *bc)
    g2b = torch.arange(ngpt, dtype=torch.int32) * 4 // ngpt
    t3 = lambda x: x.permute(2, 1, 0)
    resc = dict(ssa=u(0.0, 0.6, *lay3), g=u(0.0, 0.9, *lay3))
    if which == "lw_noscat":
        return (solver_lw.lw_noscat, (tau, lay, lev, emis, sfc, inc),
                dict(ds=1.66, weight=0.5), (False, False, False, 0))
    if which == "lw_noscat byband":
        return (solver_lw.lw_noscat, (tau, lay, lev, emis, sfc, inc),
                dict(ds=1.66, weight=0.5, gpt2band=g2b, nband=4),
                (False, False, False, 4))
    if which == "lw_noscat rescaled":
        return (solver_lw.lw_noscat, (tau, lay, lev, emis, sfc, inc),
                dict(ds=u(1.0, 2.0, *bc), weight=0.5,
                     sfc_src_jac=u(0.0, 0.1, *bc), **resc),
                (True, True, False, 0))
    lanes = (t3(tau), t3(lay), t3(lev), emis.T, sfc.T, inc.T)
    if which == "lw_noscat_lanes":
        return (solver_lanes.lw_noscat_lanes, lanes,
                dict(ds=1.66, weight=0.5), (False, False, False, 0))
    if which == "lw_noscat_lanes rescaled":
        return (solver_lanes.lw_noscat_lanes, lanes,
                dict(ds=1.66, weight=0.5, ssa=t3(resc["ssa"]),
                     g=t3(resc["g"]), sfc_src_jac=u(0.0, 0.1, *bc).T,
                     do_rescaling=True, do_jacobians=True),
                (True, True, False, 0))
    return (solver_lanes.lw_noscat_lanes_pfrac,
            (t3(tau), t3(u(0.0, 1.0, *lay3)), u(0.5, 1.5, 4, nlay, ncol),
             u(0.5, 1.5, 4, nlay + 1, ncol), u(0.5, 1.5, 4, ncol), emis.T,
             inc.T),
            dict(ds=1.66, weight=0.5, gpt2band=g2b,
                 cloud_tau_abs=u(0.0, 0.5, 4, nlay, ncol)),
            (False, False, True, 0))


LW_CALLS = ["lw_noscat", "lw_noscat byband", "lw_noscat rescaled",
            "lw_noscat_lanes", "lw_noscat_lanes rescaled",
            "lw_noscat_lanes_pfrac"]


def _cuda_branch(monkeypatch, calls):
    """The wrappers' CUDA branch on CPU tensors, each launch replaced by a
    record of its arguments."""
    for mod in (solver_lw, solver_lanes):
        monkeypatch.setattr(mod, "on_cpu", lambda t, what: False)
        monkeypatch.setattr(mod, "launch", lambda *a: calls.append(a[3:]))


@pytest.mark.parametrize("which", LW_CALLS)
def test_lw_wrappers_pass_no_scratch(which, monkeypatch):
    """The LW no-scattering solver's three wrappers hand their launcher
    the inputs, the outputs they return and sizes only: no device scratch
    (the parent's rescaled variant took an (ncol, nlay, ngpt) scratch,
    0.30 GB at 4096 x 72), and the chunk onchip_geometry gives the
    variant."""
    calls = []
    _cuda_branch(monkeypatch, calls)
    ncol, nlay, ngpt = 3, 9, 40
    fn, args, kw, (rescale, jacobian, pfrac, nband) = _lw_call(
        which, np.random.default_rng(8), ncol, nlay, ngpt)
    out = fn(*args, **kw)
    assert len(calls) == 1
    given = {t.data_ptr() for t in list(args) + list(kw.values())
             if isinstance(t, torch.Tensor)}
    returned = {o.data_ptr() for o in out if o is not None}
    tensors = [a for a in calls[0] if isinstance(a, torch.Tensor)]
    assert all(t.data_ptr() in given | returned for t in tensors)
    assert returned <= {t.data_ptr() for t in tensors}
    ints = [a for a in calls[0] if isinstance(a, int)]
    assert ints[-1] == onchip_geometry(
        "solver_lw", nlay, ngpt, nband, rescale=rescale, jacobian=jacobian,
        pfrac=pfrac).chunk
    assert solver_lw.lw_noscat_scratch_bytes(4096, 72, 256) == 0


@pytest.mark.parametrize("which", LW_CALLS)
def test_lw_wrappers_raise_past_the_limit(which, monkeypatch):
    """On the CUDA branch a column one layer taller than the variant's
    block holds raises ValueError naming the limit, and nothing is
    launched; at the limit the launch goes ahead. On CPU tensors the twin
    of the taller call runs (no height limit), launching nothing, with
    finite fluxes of the right shape."""
    ngpt, ncol = 32, 2
    rng = np.random.default_rng(9)
    _, _, _, (rescale, jacobian, pfrac, nband) = _lw_call(which, rng, 1, 1,
                                                          ngpt)
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry("solver_lw", 10 ** 6, ngpt, nband, rescale=rescale,
                        jacobian=jacobian, pfrac=pfrac)
    top = int(str(e.value).split("at most ")[1].split()[0])
    fn, args, kw, _ = _lw_call(which, rng, ncol, top + 1, ngpt)
    n0 = fn.launches
    out = [o for o in fn(*args, **kw) if o is not None]
    assert fn.launches == n0
    lanes = "lanes" in which
    for o in out:
        assert o.shape[:2] == ((top + 2, ncol) if lanes else (ncol, top + 2))
        assert bool(torch.isfinite(o).all())
    calls = []
    _cuda_branch(monkeypatch, calls)
    with pytest.raises(ValueError, match=f"at most {top} layers"):
        fn(*args, **kw)
    assert calls == []
    fn, args, kw, _ = _lw_call(which, rng, ncol, top, ngpt)
    fn(*args, **kw)
    assert len(calls) == 1


def test_rte_sw_twin_has_no_height_limit():
    """rte_sw on CPU tensors at 500 layers, past both SW kernels' limits:
    the twins run (fluxes and their gradient with respect to tau), no
    kernel is launched."""
    with pytest.raises(ValueError, match="at most"):
        onchip_geometry("solver_sw", 500, 16)
    with pytest.raises(ValueError, match="at most"):
        onchip_geometry("solver_sw_bwd", 500, 16)
    rng = np.random.default_rng(7)
    ncol, nlay, ngpt = 2, 500, 16
    grid = SpectralGrid.from_arrays([[3250.0, 10000.0]], [[1, ngpt]])
    f = lambda lo, hi, *s: torch.from_numpy(rng.uniform(lo, hi, s).astype(
        np.float32))
    tau = f(0.0, 0.02, ncol, nlay, ngpt).requires_grad_()
    props = OpticalProps2str(tau=tau, ssa=f(0.0, 0.9, ncol, nlay, ngpt),
                             g=f(0.0, 0.8, ncol, nlay, ngpt), grid=grid)
    n0 = (solver_sw.sw_2stream.launches,
          solver_sw_bwd.sw_2stream_bwd.launches)
    inc = f(0.5, 1.5, ncol, ngpt)
    alb = f(0.0, 0.3, ncol, ngpt)
    fl = rte_sw(props, np.array([0.7, 0.3]), inc, alb, alb)
    ref = solver_sw.sw_2stream_plain(
        tau.detach(), props.ssa, props.g,
        torch.tensor([[0.7], [0.3]]).expand(ncol, nlay).contiguous(), alb,
        alb, inc)
    for got, want in zip((fl.flux_up, fl.flux_dn, fl.flux_dn_dir), ref):
        assert got.shape == (ncol, nlay + 1)
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    grad, = torch.autograd.grad(fl.flux_up.sum(), tau)
    assert grad.shape == tau.shape and bool(torch.isfinite(grad).all())
    assert (solver_sw.sw_2stream.launches,
            solver_sw_bwd.sw_2stream_bwd.launches) == n0


# ---- the summation order, replayed in float32 ----

def chunk_bands(gpt2band, chunk, nband):
    """The kernels' by-band summation order (transport.cuh::ClusterSums):
    for each chunk (cluster rank), for each band, the chunk's g-points of
    that band in ascending order. A band's sum is the sum over ranks, in
    rank order, of its chunk sums."""
    ngpt = gpt2band.shape[0]
    out = []
    for g0 in range(0, ngpt, chunk):
        gs = np.arange(g0, min(g0 + chunk, ngpt))
        out.append([gs[gpt2band[gs] == b].tolist() for b in range(nband)])
    return out


def _warp_sum(v):
    """common.cuh::warp_sum: the xor butterfly over 32 lanes (every lane
    ends with the same sum)."""
    v = v.copy()
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[lane ^ off]).astype(np.float32)
    assert np.all(v == v[0])
    return v[0]


def _broadband_chunked(vals, chunk):
    """The cluster's broadband sum of one level: each block's warps'
    butterfly sums, then the ranks in order and within a rank its warps
    in order, from 0 (transport.cuh::ClusterSums::finalize)."""
    ngpt = vals.shape[0]
    nchunk = -(-ngpt // chunk)
    pad = np.zeros(nchunk * chunk, np.float32)
    pad[:ngpt] = vals
    s = np.float32(0.0)
    for r in range(nchunk):
        for w in range(chunk // 32):
            s = np.float32(s + _warp_sum(pad[r * chunk + 32 * w:
                                             r * chunk + 32 * (w + 1)]))
    return s


def _byband_chunked(vals, gpt2band, chunk, nband):
    """The cluster's by-band sums of one level: each chunk's band sums in
    ascending g-point order, then the ranks in order, from 0."""
    out = np.zeros(nband, np.float32)
    for lists in chunk_bands(gpt2band, chunk, nband):
        for b, gs in enumerate(lists):
            t = np.float32(0.0)
            for g in gs:
                t = np.float32(t + vals[g])
            out[b] = np.float32(out[b] + t)
    return out


def _bands(kind, ngpt, nband):
    if kind == "uniform":
        return np.arange(ngpt) // (ngpt // nband), nband
    if kind == "ragged":           # widths 1, 2, 3, ... then the rest
        edges = np.cumsum(np.arange(1, ngpt))
        b = np.searchsorted(edges, np.arange(ngpt), side="right")
        b = np.minimum(b, 6)
        return b, 7
    # reordered: g-points of three bands interleave (as the cuda tests)
    return np.array([(g * g + g // 5) % 3 for g in range(ngpt)]), 3


@pytest.mark.parametrize("kind", ["uniform", "ragged", "reordered"])
@pytest.mark.parametrize("ngpt,nband", [(224, 14), (256, 16), (168, 14),
                                        (192, 16), (24, 3), (1024, 16)])
def test_chunked_sums_replay(ngpt, nband, kind):
    gpt2band, nband = _bands(kind, ngpt, nband)
    chunk = onchip_geometry("lw_2stream", 72, ngpt).chunk
    rng = np.random.default_rng(ngpt)
    vals = rng.uniform(0.0, 400.0, ngpt).astype(np.float32)
    # every g-point in exactly one (rank, band) list, its own band, the
    # lists ascending and within their chunk
    lists = chunk_bands(gpt2band, chunk, nband)
    seen = []
    for r, per_band in enumerate(lists):
        for b, gs in enumerate(per_band):
            assert gs == sorted(gs)
            assert all(gpt2band[g] == b and g // chunk == r for g in gs)
            seen += gs
    assert sorted(seen) == list(range(ngpt))
    # against a straight sum over g-points (float64)
    # (float32 rounding: well inside 1e-5 of the total for <= 1024 terms)
    total = vals.astype(np.float64).sum()
    bb = _broadband_chunked(vals, chunk)
    assert abs(float(bb) - total) <= 1e-5 * total
    byb = _byband_chunked(vals, gpt2band, chunk, nband)
    ref = np.zeros(nband)
    np.add.at(ref, gpt2band, vals.astype(np.float64))
    assert np.all(np.abs(byb - ref) <= 1e-5 * total)
    # broadband with 32-wide chunks: the warp order of one block that
    # held the whole column (the PR 6 kernels' level_total), bit for bit
    if chunk == 32:
        one = np.float32(0.0)
        for w in range(0, ngpt, 32):
            warp = np.zeros(32, np.float32)
            warp[:min(32, ngpt - w)] = vals[w:w + 32]
            one = np.float32(one + _warp_sum(warp))
        assert bb == one
    # a band that no chunk boundary cuts: the one-block BandSums order
    for b in range(nband):
        gs = np.flatnonzero(gpt2band == b)
        if len(gs) and gs[0] // chunk == gs[-1] // chunk:
            t = np.float32(0.0)
            for g in gs:
                t = np.float32(t + vals[g])
            assert byb[b] == t


@pytest.mark.parametrize("ngpt,nlay", [(224, 72), (168, 72), (256, 72),
                                       (24, 9), (1024, 40)])
def test_mu0_cotangent_sum_replay(ngpt, nlay):
    """The SW adjoint's mu0 cotangent of each layer: the cluster's sum
    (each chunk's warps' butterfly sums, ranks in order; layer 0 then adds
    the beam's seed summed the same way) is bit for bit the sum the
    kernel took when it held the whole column in one block (the warps'
    butterfly sums in warp order, then the seed's), at the chunk widths
    onchip_geometry gives the adjoint, idle lanes zero."""
    chunk = onchip_geometry("solver_sw_bwd", nlay, ngpt).chunk
    rng = np.random.default_rng(ngpt + nlay)
    # per (layer, g-point) mu0 cotangents of both signs and magnitudes
    vals = (rng.standard_normal((nlay, ngpt))
            * 10.0 ** rng.uniform(-3, 3, (nlay, ngpt))).astype(np.float32)
    seed = rng.standard_normal(ngpt).astype(np.float32)

    def one_block(v):
        s = np.float32(0.0)
        for w in range(0, ngpt, 32):
            warp = np.zeros(32, np.float32)
            warp[:min(32, ngpt - w)] = v[w:w + 32]
            s = np.float32(s + _warp_sum(warp))
        return s

    for l in range(nlay):
        got = _broadband_chunked(vals[l], chunk)
        want = one_block(vals[l])
        if l == 0:
            got = np.float32(got + _broadband_chunked(seed, chunk))
            want = np.float32(want + one_block(seed))
        assert got.tobytes() == want.tobytes()
        ref = float(vals[l].astype(np.float64).sum())
        assert abs(float(_broadband_chunked(vals[l], chunk)) - ref) <= (
            1e-5 * float(np.abs(vals[l]).astype(np.float64).sum()))


@pytest.mark.parametrize("ngpt,nband", [(256, 16), (192, 16)])
def test_fused_lw_sums_replay(ngpt, nband):
    """The fused LW kernel's sums at its chunk width (onchip_geometry's):
    broadband bit for bit the one-block warp order the kernel had when a
    column was one block (common.cuh::level_total), by band with uniform
    bands bit for bit the one-block ascending order (common.cuh::BandSums)
    for each band inside one chunk (every band at 256 g-points / 16 bands)
    and within float32 rounding of a straight sum for a band that two
    chunks share (bands of 12 at 192 g-points); the scaling by pi *
    weight comes after either sum."""
    _one_block_order(onchip_geometry("fused_lw", 72, ngpt, nband, 28).chunk,
                     ngpt, nband)


@pytest.mark.parametrize("ngpt,nband", [(256, 16), (192, 16)])
def test_solver_lw_sums_replay(ngpt, nband):
    """The LW no-scattering solver's sums, in the order of the fused LW
    kernel's at the same chunk width: bit for bit the one-block orders it
    had when a column was one block, broadband and, for each band inside
    one chunk, by band (so rows 7, 10 and 11 keep their outputs at the
    flagship's 256 g-points), within float32 rounding of a straight sum
    for a band two chunks share."""
    for v in (dict(), dict(rescale=True, jacobian=True), dict(pfrac=True)):
        _one_block_order(onchip_geometry("solver_lw", 72, ngpt, nband,
                                         **v).chunk, ngpt, nband)


def _one_block_order(chunk, ngpt, nband):
    """The chunked sums at ``chunk`` against the one-block orders (see
    test_fused_lw_sums_replay)."""
    assert chunk == 32
    gpt2band = np.arange(ngpt) // (ngpt // nband)
    rng = np.random.default_rng(ngpt + 1)
    for _ in range(8):
        vals = rng.uniform(0.0, 400.0, ngpt).astype(np.float32)
        one = np.float32(0.0)
        for w in range(0, ngpt, 32):
            one = np.float32(one + _warp_sum(vals[w:w + 32]))
        assert _broadband_chunked(vals, chunk) == one
        byb = _byband_chunked(vals, gpt2band, chunk, nband)
        for b in range(nband):
            gs = np.flatnonzero(gpt2band == b)
            t = np.float32(0.0)
            for g in gs:
                t = np.float32(t + vals[g])
            if gs[0] // chunk == gs[-1] // chunk:
                assert byb[b] == t
            else:
                ref = float(vals[gs].astype(np.float64).sum())
                assert abs(float(byb[b]) - ref) <= 1e-6 * ref
        split = [b for b in range(nband)
                 if np.flatnonzero(gpt2band == b)[0] // chunk
                 != np.flatnonzero(gpt2band == b)[-1] // chunk]
        assert (split == []) == (ngpt == 256)
