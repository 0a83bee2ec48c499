"""The whole-grid stream's copies between host and card per sweep
(``parallel/scaling.AllSkyStream``), from the cell's shapes, float32.
Up: the fields the fused all-sky step reads for every column (play,
tlay, lwp, iwp, rel, dei and h2o per layer; plev and tlev per level;
tsfc, sfc_emis, sfc_alb and mu0 one each), the all-sky state's o3
profile and its 17 other gases' single values once a sweep
(``traffic/allsky.state``), and the int32 indices of the day
columns of every chunk that holds both day and night columns (each chunk
of 4096 columns under a sun uniform in mu0 on [-1, 1]). Down: five flux
profiles per column. No operations.

The link's peak per direction, ``LINK_BYTES_PER_S``: the H100 SXM5
data sheet's PCIe Gen 5 x16 host link, 128 GB/s both ways, 64 GB/s a
direction. ``nvidia-smi -q`` on the benchmark's card (NVIDIA H100 80GB
HBM3, board 692-2G520-0200-000, 700 W power limit) reads N/A for the
link's generation and width, so the data sheet's link is taken."""
from torch_bench.traffic.generator import GASES

LINK_BYTES_PER_S = 64e9


def day_share(cell) -> float:
    """The expected share of day columns under the cell's sun: mu0
    uniform on [lo, hi], day where mu0 > 0."""
    lo, hi = cell["traffic"]["mu0"]
    return (hi - max(lo, 0.0)) / (hi - lo)


def copy_bytes(s, nday: int):
    """(bytes up, bytes down) of one sweep with ``nday`` day indices."""
    ncol, nlay = s["ncol"], s["nlay"]
    per_column = 7 * nlay + 2 * (nlay + 1) + 4
    once = nlay + len(GASES) - 2
    return 4 * (ncol * per_column + once + nday), 4 * 5 * ncol * (nlay + 1)


def day_indices(mu0, chunk: int) -> int:
    """The day indices a sweep of a grid with host ``mu0`` sends up: the
    day columns of each chunk that also holds night columns."""
    n = 0
    for c0 in range(0, mu0.shape[0], chunk):
        lit = int((mu0[c0:c0 + chunk] > 0).sum())
        n += lit if lit < mu0[c0:c0 + chunk].shape[0] else 0
    return n


def copy_seconds(run) -> float:
    """Device seconds of the traced window's host-to-device and
    device-to-host copies."""
    return sum(t for name, (t, _) in run.kernels.items()
               if name.startswith(("Memcpy HtoD", "Memcpy DtoH")))


def work(s, cell):
    up, down = copy_bytes(s, round(day_share(cell) * s["ncol"]))
    return up + down, 0
