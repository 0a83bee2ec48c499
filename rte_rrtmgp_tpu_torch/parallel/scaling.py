"""A whole grid's all-sky radiation streamed through one device, and the
pod-scale all-sky configuration built on the same stream.

:class:`AllSkyStream` is the entry point for a host model that keeps its
grid in host memory and hands the device the whole grid once per
radiation time step: ``AllSkyStream(gas_lw, gas_sw, cloud_lw, cloud_sw,
chunk=4096).run(grid)`` runs the fused all-sky step (``drivers/allsky.
allsky_step_lw`` on every column, ``allsky_step_sw`` on the day columns
alone, ``mu0 > 0``) over the grid in chunks of ``chunk`` columns and
returns the five flux profiles in host memory. Given aerosol optics
(``aerosol_lw=``, ``aerosol_sw=``), the step runs with them
(``use_aerosols``), and the grid's aerosol fields (type, size, mass,
relative humidity) join the fields that go up and that the day gather
takes. Per sweep:

  * chunk k's fields (those the step reads) are copied from the host grid
    into one of two device buffers (buffer k % 2), on a copy stream on a
    CUDA device, beside chunk k-1's step: the step waits for its upload
    through an event, and an upload waits for the step that last read its
    buffer. The last chunk may be ragged: it fills the first rows of its
    buffer, and no padding column is computed, returned or counted;
  * the day columns of each chunk are found from the host's ``mu0``, so
    the host never waits on the device to learn them; their indices go up
    with the chunk, and the SW step runs on those columns gathered on the
    device (on the chunk itself where every column is lit, not at all
    where none is). SW fluxes of night columns are exactly 0, as GCM
    radiation interfaces gather their day columns and solve SW on them
    alone;
  * the fluxes go down into pinned host buffers, on a second copy stream,
    as each chunk's step ends; the host waits once per sweep, for the
    last of those copies. The returned buffers are reused by the next
    sweep.

On the CPU (``device="cpu"``) the same loop runs with plain copies into
the two buffers and out of them. The stream leaves the value checks at
the program's setting (``config.checks_disabled`` turns them off, as the
reference's timed loop does, rrtmgp_allsky.F90:332-335); each check
reads the device from the host once per chunk.

Inside ``trace.collect()`` a sweep records the spans ``stream.sweep``,
``stream.upload`` (the host's enqueue of one chunk's copies),
``stream.chunk``, ``stream.day_gather``, ``stream.readback`` and
``wait.stream.readback``, and counts ``stream.chunks``,
``stream.sw_columns``, ``stream.bytes_up`` and ``stream.bytes_down``.

``podscale_allsky`` (counterpart of ``rte_rrtmgp_tpu.parallel.scaling.
podscale_allsky``, JAX :106-210) streams the all-sky step (the fused
branch, with synthetic optics) over a large number of columns and reports
columns/s. Two regimes:

  * ``stream=True``: a pool of ``host_pool`` host chunks is cycled
    through the run and every chunk is uploaded during it, through the
    stream's uploads. The entries differ (:func:`_pool_entry`; the JAX
    package's pool holds copies of one chunk), so a step that reads the
    wrong entry changes its outputs;
  * ``stream=False``: one resident chunk is reused, the compute rate with
    no input traffic.

Its timed loop runs without the value checks, as the JAX package's
jitted step does (its checks skip under jit); the untimed first step runs
them. ``weak_scaling`` and the placement over several devices wait for
the port of ``parallel/mesh.py``.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from .. import trace
from ..config import checks_disabled, resolve_device
from ..drivers.allsky import (AllSkyInputs, allsky_step_lw, allsky_step_sw,
                              make_allsky_inputs)
from ..gas_concs import GasConcs
from ..models.rrtmgp.gas_optics import GasOpticsRRTMGP
from ..utils.synthetic import synthetic_cloud_optics, synthetic_kdist

__all__ = ["AllSkyStream", "StreamFluxes", "podscale_allsky"]

# the per-column fields the fused all-sky step reads without aerosols,
# and those of them its SW half reads, which the day gather takes; with
# aerosols both take the aerosol fields too
STEP_FIELDS = ("play", "plev", "tlay", "tlev", "tsfc", "lwp", "iwp", "rel",
               "dei", "sfc_emis", "sfc_alb", "mu0")
SW_FIELDS = ("play", "plev", "tlay", "lwp", "iwp", "rel", "dei", "sfc_alb",
             "mu0")
AEROSOL_FIELDS = ("aero_type", "aero_size", "aero_mass", "relhum")


class StreamFluxes(NamedTuple):
    """One sweep's fluxes, each (ncol, nlay+1) in host memory."""
    lw_up: torch.Tensor
    lw_dn: torch.Tensor
    sw_up: torch.Tensor
    sw_dn: torch.Tensor
    sw_dir: torch.Tensor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _columns(inputs: AllSkyInputs, c0: int, c1: int,
             fields=STEP_FIELDS) -> AllSkyInputs:
    """Columns [c0, c1) of the step's ``fields`` (views); the gas store's
    fields sliced, its scalars and profiles whole; the fields the step
    does not read None."""
    gas = inputs.gas_concs.get_subset(c0, c1 - c0)
    return AllSkyInputs(**{f: None for f in AllSkyInputs._fields})._replace(
        gas_concs=gas, **{f: getattr(inputs, f)[c0:c1] for f in fields})


def _layout(inputs: AllSkyInputs, fields: tuple) -> tuple:
    """What the device buffers depend on: the fields, each one's width
    and dtype, the gas names and which gas values are per-column
    fields."""
    w = lambda t: (t.ndim, tuple(t.shape[1:]), t.dtype)
    gas = inputs.gas_concs
    return (fields, tuple(w(getattr(inputs, f)) for f in fields), gas.names,
            tuple(w(v) for v in gas.values))


class _Uploads:
    """Chunk k's fields copied from host memory into one of two device
    buffers (buffer k % 2), each ``chunk`` columns wide. ``put(k, src,
    day)`` enqueues the copies of ``src`` (the step's ``fields`` of at
    most ``chunk`` columns, as :func:`_columns` gives them) and of its day
    columns' indices ``day`` (int32, or None) after the last step that
    read that buffer; ``get(k)`` makes the current stream wait for them and
    returns (the chunk's inputs, the indices), views of the buffer's
    first rows; ``release(k)`` marks the buffer's step as enqueued. A gas
    value that is not a per-column field (a scalar or a profile) goes up
    once per host tensor and stays until :meth:`clear`. On a CUDA device
    the copies run on the stream ``copy``; on the CPU they are plain
    copies."""

    def __init__(self, like: AllSkyInputs, chunk: int, device,
                 fields: tuple):
        self.device, self.cuda = device, device.type == "cuda"
        self.fields = fields
        self.layout = _layout(like, fields)
        cols = lambda t: torch.empty((chunk,) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device=device)
        gas = like.gas_concs
        self.bufs = [dict({f: cols(getattr(like, f)) for f in fields},
                          day=torch.empty(chunk, dtype=torch.int32,
                                          device=device),
                          **{"gas." + n: cols(v)
                             for n, v in zip(gas.names, gas.values)
                             if v.ndim == 2})
                     for _ in range(2)]
        self.chunks = [None, None]
        self.shared = {}
        if self.cuda:
            self.copy = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]

    def clear(self) -> None:
        self.shared = {}

    def put(self, k: int, src: AllSkyInputs, day=None) -> None:
        b = k % 2
        buf = self.bufs[b]
        n = src.play.shape[0]
        with trace.span("stream.upload"):
            copies = [(buf[f][:n], getattr(src, f)) for f in self.fields]
            values = []
            for name, v in zip(src.gas_concs.names, src.gas_concs.values):
                if v.ndim == 2:
                    dst = buf["gas." + name][:n]
                    copies.append((dst, v))
                elif id(v) in self.shared:
                    dst = self.shared[id(v)][1]
                else:
                    # made on the current stream, which reads it; the host
                    # tensor is kept so that its id stays its own
                    dst = torch.empty_like(v, device=self.device)
                    if self.cuda:
                        dst.record_stream(self.copy)
                    self.shared[id(v)] = (v, dst)
                    copies.append((dst, v))
                values.append(dst)
            idx = None
            if day is not None:
                idx = buf["day"][:day.numel()]
                copies.append((idx, day))
            if self.cuda:
                self.copy.wait_event(self.freed[b])
                with torch.cuda.stream(self.copy):
                    for dst, s in copies:
                        dst.copy_(s, non_blocking=True)
                    self.ready[b].record(self.copy)
            else:
                for dst, s in copies:
                    dst.copy_(s)
            trace.count("stream.bytes_up", sum(s.numel() * s.element_size()
                                               for _, s in copies))
        x = src._replace(
            gas_concs=GasConcs(names=src.gas_concs.names,
                               values=tuple(values)),
            **{f: buf[f][:n] for f in self.fields})
        self.chunks[b] = (x, idx)

    def get(self, k: int):
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.ready[k % 2])
        return self.chunks[k % 2]

    def release(self, k: int) -> None:
        if self.cuda:
            self.freed[k % 2].record(torch.cuda.current_stream(self.device))


class AllSkyStream:
    """A whole grid's all-sky step, streamed from host memory through one
    device in chunks of ``chunk`` columns (see the module's notes):
    ``run(grid)`` takes an ``AllSkyInputs`` of CPU tensors and returns its
    :class:`StreamFluxes` in host buffers (pinned on a CUDA device) that
    the next sweep overwrites. ``gas_lw``, ``gas_sw``, ``cloud_lw`` and
    ``cloud_sw`` are the optics objects ``allsky_step_lw`` and
    ``allsky_step_sw`` take, on ``device`` (default: the CUDA device);
    ``aerosol_lw`` and ``aerosol_sw``, both or neither, their aerosol
    optics: given, the grid's aerosol fields are read, else they are
    not."""

    def __init__(self, gas_lw: GasOpticsRRTMGP, gas_sw: GasOpticsRRTMGP,
                 cloud_lw, cloud_sw, chunk: int = 4096, device=None, *,
                 aerosol_lw=None, aerosol_sw=None):
        if int(chunk) < 1:
            raise ValueError(f"AllSkyStream: chunk must be positive, got "
                             f"{chunk}")
        if (aerosol_lw is None) != (aerosol_sw is None):
            raise ValueError("AllSkyStream: give both aerosol_lw and "
                             "aerosol_sw, or neither")
        self.gas_lw, self.gas_sw = gas_lw, gas_sw
        self.cloud_lw, self.cloud_sw = cloud_lw, cloud_sw
        self.aerosol_lw, self.aerosol_sw = aerosol_lw, aerosol_sw
        self.aerosols = aerosol_lw is not None
        self.fields = STEP_FIELDS + (AEROSOL_FIELDS if self.aerosols else ())
        self.sw_fields = SW_FIELDS + (AEROSOL_FIELDS if self.aerosols
                                      else ())
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self._uploads = None
        self._out = None
        self._stage = None
        if self.device.type == "cuda":
            self._down = torch.cuda.Stream(self.device)

    def pin(self, grid: AllSkyInputs) -> AllSkyInputs:
        """``grid`` with the fields the step reads in pinned host memory,
        so that their uploads run beside the device's work (a grid not
        pinned is pinned by each sweep); on the CPU, ``grid``."""
        if self.device.type != "cuda":
            return grid
        p = lambda t: t if t.is_pinned() else t.pin_memory()
        gas = grid.gas_concs
        return grid._replace(
            gas_concs=GasConcs(names=gas.names,
                               values=tuple(p(v) for v in gas.values)),
            **{f: p(getattr(grid, f)) for f in self.fields})

    def _bounds(self, ncol: int) -> list:
        """Each chunk's columns [c0, c1): whole chunks, then the rest."""
        return [(c0, min(c0 + self.chunk, ncol))
                for c0 in range(0, ncol, self.chunk)]

    @staticmethod
    def _day_columns(mu0: torch.Tensor) -> torch.Tensor:
        """The lit columns of one chunk, from the host's ``mu0``."""
        return torch.nonzero(mu0 > 0).flatten()

    def _stream(self, n: int, source: Callable, like: AllSkyInputs):
        """Yields (k, (device inputs, day indices)) for chunks k < n,
        ``source(k)`` giving chunk k's host fields and day indices;
        chunk k+1 goes up beside chunk k's step, and chunk k's buffer is
        released when the next chunk is asked for."""
        fields = self.fields
        if self._uploads is None \
                or self._uploads.layout != _layout(like, fields):
            self._uploads = _Uploads(like, self.chunk, self.device, fields)
        up = self._uploads
        up.clear()
        if n:
            up.put(0, *source(0))
        for k in range(n):
            if k + 1 < n:
                up.put(k + 1, *source(k + 1))
            trace.count("stream.chunks")
            yield k, up.get(k)
            up.release(k)

    def _chunk(self, x: AllSkyInputs, idx, nday: int) -> list:
        """One chunk's five fluxes on the device, each (n, nlay+1)
        contiguous: LW on every column, SW on the ``nday`` lit ones (the
        columns ``idx``, or all of them), 0 on the others."""
        n, nlev = x.play.shape[0], x.plev.shape[1]
        aer = dict(use_aerosols=True) if self.aerosols else {}
        lw = allsky_step_lw(x, self.gas_lw, cloud_optics=self.cloud_lw,
                            aerosol_optics=self.aerosol_lw, **aer)
        out = [lw.flux_up.contiguous(), lw.flux_dn.contiguous()]
        if nday == 0:
            zero = x.play.new_zeros((n, nlev))
            return out + [zero, zero, zero]
        sw_step = lambda y: allsky_step_sw(
            y, self.gas_sw, cloud_optics=self.cloud_sw,
            aerosol_optics=self.aerosol_sw, **aer)
        if idx is None:
            sw = sw_step(x)
            return out + [f.contiguous() for f in (sw.flux_up, sw.flux_dn,
                                                   sw.flux_dn_dir)]
        with trace.span("stream.day_gather"):
            i = idx.long()
            pick = lambda t: t.index_select(0, i)
            gas = x.gas_concs
            day = x._replace(
                tlev=None, tsfc=None, sfc_emis=None,
                gas_concs=GasConcs(names=gas.names, values=tuple(
                    pick(v) if v.ndim == 2 else v for v in gas.values)),
                **{f: pick(getattr(x, f)) for f in self.sw_fields})
        sw = sw_step(day)
        with trace.span("stream.day_gather"):
            for f in (sw.flux_up, sw.flux_dn, sw.flux_dn_dir):
                out.append(x.play.new_zeros((n, nlev)).index_copy_(0, i, f))
        return out

    def _outputs(self, ncol: int, nlev: int, dtype) -> StreamFluxes:
        shape = (ncol, nlev)
        if self._out is None or self._out[0].shape != shape \
                or self._out[0].dtype != dtype:
            pin = self.device.type == "cuda"
            self._out = StreamFluxes(*(torch.zeros(shape, dtype=dtype,
                                                   pin_memory=pin)
                                       for _ in StreamFluxes._fields))
        return self._out

    def _readback(self, out: StreamFluxes, c0: int, c1: int,
                  fluxes: list) -> None:
        with trace.span("stream.readback"):
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._down.wait_event(done)
                with torch.cuda.stream(self._down):
                    for o, f in zip(out, fluxes):
                        o[c0:c1].copy_(f, non_blocking=True)
                        f.record_stream(self._down)
            else:
                for o, f in zip(out, fluxes):
                    o[c0:c1].copy_(f)
            trace.count("stream.bytes_down",
                        sum(f.numel() * f.element_size() for f in fluxes))

    def _day_stage(self, ncol: int) -> torch.Tensor:
        """Host int32 room for a sweep's day indices (pinned on a CUDA
        device); the last sweep's copies out of it have ended."""
        if self._stage is None or self._stage.numel() < ncol:
            self._stage = torch.empty(ncol, dtype=torch.int32,
                                      pin_memory=self.device.type == "cuda")
        return self._stage

    @trace.spanned("stream.sweep")
    def run(self, grid: AllSkyInputs) -> StreamFluxes:
        """One sweep of the whole grid: LW on every column, SW on the
        columns with ``mu0 > 0`` (0 on the others); returns the five flux
        profiles, each (ncol, nlay+1), in host memory, valid until the
        next sweep."""
        if any(getattr(grid, f).device.type != "cpu" for f in self.fields):
            raise ValueError("AllSkyStream.run: the grid must be in host "
                             "memory (CPU tensors)")
        grid = self.pin(grid)
        ncol, nlay = grid.play.shape
        out = self._outputs(ncol, nlay + 1, grid.play.dtype)
        bounds = self._bounds(ncol)
        stage = self._day_stage(ncol)
        sources, a = [], 0
        for c0, c1 in bounds:
            day = self._day_columns(grid.mu0[c0:c1])
            m = day.numel()
            idx = None
            if 0 < m < c1 - c0:
                idx = stage[a:a + m]
                idx.copy_(day)
                a += m
            sources.append((_columns(grid, c0, c1, self.fields), idx, m))
        trace.count("stream.sw_columns", sum(s[2] for s in sources))
        for k, (x, idx) in self._stream(len(bounds),
                                         lambda k: sources[k][:2], grid):
            with trace.span("stream.chunk"):
                fluxes = self._chunk(x, idx, sources[k][2])
            self._readback(out, *bounds[k], fluxes)
        if self.device.type == "cuda":
            end = torch.cuda.Event()
            end.record(self._down)
            with trace.wait("stream.readback"):
                end.synchronize()
        return out


def _pool_entry(inputs: AllSkyInputs, j: int) -> AllSkyInputs:
    """Entry j of the streamed run's host pool: ``inputs`` with every
    temperature raised by j/2 K and the water paths scaled by 1 + j/4
    (exact in float32, on any device). Entry 0 is ``inputs``. Both steps
    read these fields, so a chunk read from the wrong buffer, or before
    its upload ends, changes the outputs."""
    if j == 0:
        return inputs
    warm = lambda t: t + 0.5 * j
    wet = lambda t: t * (1.0 + 0.25 * j)
    return inputs._replace(tlay=warm(inputs.tlay), tlev=warm(inputs.tlev),
                           tsfc=warm(inputs.tsfc), lwp=wet(inputs.lwp),
                           iwp=wet(inputs.iwp))


def _podscale(total_columns: int, nlay: int, *, chunk_cols_per_device,
              ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp, npres,
              reps_per_chunk, stream, host_pool, verbose, device,
              keep=False):
    """:func:`podscale_allsky`'s loop: (its result, the outputs (TOA LW
    up, TOA SW up), each (chunk,), of each chunk's last step: every
    chunk's with ``keep``, else the last chunk's alone). Chunk k reads
    pool entry k % host_pool when streamed, through
    :class:`AllSkyStream`'s uploads."""
    device = resolve_device(device)
    chunk = chunk_cols_per_device or 4096
    n_chunks = -(-total_columns // chunk)

    kw = dict(ntemp=ntemp, npres=npres, device=device)
    gas_lw = GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=ngpt_lw,
                                             nbnd=nbnd_lw, **kw))
    gas_sw = GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=ngpt_sw,
                                             nbnd=nbnd_sw, **kw))
    cld_lw, cld_sw = (synthetic_cloud_optics(
        nbnd=n, band_lims_wvn=g.grid.band_lims_wvn_array, device=device)
        for n, g in ((nbnd_lw, gas_lw), (nbnd_sw, gas_sw)))

    def step(i):
        lw = allsky_step_lw(i, gas_lw, cloud_optics=cld_lw)
        sw = allsky_step_sw(i, gas_sw, cloud_optics=cld_sw)
        return lw.flux_up[:, 0], sw.flux_up[:, 0]   # keep outputs small

    resident = make_allsky_inputs(chunk, nlay, cloud_optics=cld_lw,
                                  device=device)
    if stream:
        # distinct host chunks cycled through the run: every chunk pays an
        # upload of every field the step reads, as a production ingest
        # loop would
        sweep = AllSkyStream(gas_lw, gas_sw, cld_lw, cld_sw, chunk=chunk,
                             device=device)
        host = make_allsky_inputs(chunk, nlay, cloud_optics=cld_lw,
                                  device=torch.device("cpu"))
        pool = [sweep.pin(_columns(_pool_entry(host, j), 0, chunk))
                for j in range(max(1, host_pool))]
        chunks = ((k, x) for k, (x, _) in sweep._stream(
            n_chunks, lambda k: (pool[k % len(pool)], None), pool[0]))
    else:
        chunks = ((k, resident) for k in range(n_chunks))

    out = step(resident)                             # builds the kernels
    _sync(device)
    outs = []
    t0 = time.perf_counter()
    with checks_disabled():
        for k, cur in chunks:
            with trace.span("stream.chunk"):
                for _ in range(reps_per_chunk):
                    out = step(cur)
            if keep:
                outs.append(out)
            if verbose and k % max(1, n_chunks // 10) == 0:
                _sync(device)
                done = (k + 1) * chunk * reps_per_chunk
                dt = time.perf_counter() - t0
                print(f"  chunk {k + 1}/{n_chunks}: {done:,} cols in "
                      f"{dt:.1f} s ({done / dt:,.0f} cols/s aggregate)")
    _sync(device)
    dt = time.perf_counter() - t0
    total = n_chunks * chunk * reps_per_chunk
    return {
        "n_devices": 1,
        "chunk_columns": chunk,
        "n_chunks": n_chunks,
        "total_columns": total,
        "streamed_inputs": bool(stream),
        "seconds": dt,
        "cols_per_s": total / dt,
        "cols_per_s_per_device": total / dt,
    }, (outs if keep else [out])


def podscale_allsky(total_columns: int = 10_000_000, nlay: int = 72,
                    *, chunk_cols_per_device: Optional[int] = None,
                    ngpt_lw: int = 256, nbnd_lw: int = 16,
                    ngpt_sw: int = 224, nbnd_sw: int = 14,
                    ntemp: int = 14, npres: int = 59,
                    reps_per_chunk: int = 1, stream: bool = True,
                    host_pool: int = 2, verbose: bool = True,
                    device=None) -> dict:
    """The 10M-column all-sky configuration (BASELINE.md) on one device
    (default: the CUDA device), streamed through in chunks of
    ``chunk_cols_per_device`` columns (4096 by default): columns/s and the
    chunking, as the JAX package's dict (``n_devices`` is 1)."""
    return _podscale(total_columns, nlay,
                     chunk_cols_per_device=chunk_cols_per_device,
                     ngpt_lw=ngpt_lw, nbnd_lw=nbnd_lw, ngpt_sw=ngpt_sw,
                     nbnd_sw=nbnd_sw, ntemp=ntemp, npres=npres,
                     reps_per_chunk=reps_per_chunk, stream=stream,
                     host_pool=host_pool, verbose=verbose, device=device)[0]
