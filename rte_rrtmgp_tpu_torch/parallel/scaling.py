"""The pod-scale all-sky configuration on one device.

Counterpart of ``rte_rrtmgp_tpu.parallel.scaling.podscale_allsky``
(JAX :106-210): the all-sky step (the fused branch, with synthetic cloud
optics) streamed over a large number of columns in chunks sized to the
device's memory, reporting columns/s. Two regimes:

  * ``stream=True``: a pool of ``host_pool`` host chunks is cycled
    through the run and every chunk is uploaded during it. The entries
    differ (:func:`_pool_entry`; the JAX package's pool holds copies of
    one chunk), so a step that reads the wrong entry changes its
    outputs. On a CUDA
    device the pool is pinned, the uploads run on their own stream into
    two device buffers in turn, chunk k+1's upload beside chunk k's step:
    the step waits for its upload through an event, and an upload waits
    for the step that last read its buffer. On the CPU each chunk is
    copied from the pool;
  * ``stream=False``: one resident chunk is reused, the compute rate with
    no input traffic.

The timed loop runs without the value checks (``config.
checks_disabled``), as the reference's timed loop does
(rrtmgp_allsky.F90:332-335) and as the JAX package's jitted step does
(its checks skip under jit); each check would read the device from the
host once per chunk. The untimed first step runs them.

``weak_scaling`` and the placement over several devices wait for the
port of ``parallel/mesh.py``.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import checks_disabled, resolve_device
from ..drivers.allsky import (AllSkyInputs, allsky_step_lw, allsky_step_sw,
                              make_allsky_inputs)
from ..gas_concs import GasConcs
from ..models.rrtmgp.gas_optics import GasOpticsRRTMGP
from ..utils.synthetic import synthetic_cloud_optics, synthetic_kdist

__all__ = ["podscale_allsky"]


def _map(fn, inputs: AllSkyInputs) -> AllSkyInputs:
    """``fn`` applied to every tensor of the inputs, the gas store's
    included."""
    gc = inputs.gas_concs
    return AllSkyInputs(**{
        f: (GasConcs(names=gc.names, values=tuple(fn(v) for v in gc.values))
            if f == "gas_concs" else fn(getattr(inputs, f)))
        for f in AllSkyInputs._fields})


def _tensors(inputs: AllSkyInputs) -> list:
    return [getattr(inputs, f) for f in AllSkyInputs._fields
            if f != "gas_concs"] + list(inputs.gas_concs.values)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Uploads:
    """Chunk k's inputs from a host pool, copied to the device on a copy
    stream into one of two device buffers (buffer k % 2). ``put(k)``
    enqueues the copy after the last step that read that buffer;
    ``get(k)`` makes the current stream wait for it and returns the
    buffer; ``release(k)`` marks the buffer's step as enqueued."""

    def __init__(self, pool, device):
        self.pool, self.device = pool, device
        self.bufs = [_map(lambda t: torch.empty_like(t, device=device),
                          pool[0]) for _ in range(2)]
        self.copy = torch.cuda.Stream(device)
        self.ready = [torch.cuda.Event() for _ in range(2)]
        self.freed = [torch.cuda.Event() for _ in range(2)]

    def put(self, k):
        b = k % 2
        self.copy.wait_event(self.freed[b])
        with torch.cuda.stream(self.copy):
            for d, s in zip(_tensors(self.bufs[b]),
                            _tensors(self.pool[k % len(self.pool)])):
                d.copy_(s, non_blocking=True)
            self.ready[b].record(self.copy)

    def get(self, k):
        torch.cuda.current_stream(self.device).wait_event(self.ready[k % 2])
        return self.bufs[k % 2]

    def release(self, k):
        self.freed[k % 2].record(torch.cuda.current_stream(self.device))


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
    pool entry k % host_pool when streamed."""
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

    put = get = release = lambda k: None
    if stream:
        # distinct host chunks cycled through the run: every chunk pays an
        # upload of every field, as a production ingest loop would
        host = make_allsky_inputs(chunk, nlay, cloud_optics=cld_lw,
                                  device=torch.device("cpu"))
        pool = [_pool_entry(host, j) for j in range(max(1, host_pool))]
        if device.type == "cuda":
            uploads = _Uploads([_map(torch.Tensor.pin_memory, p)
                                for p in pool], device)
            put, get, release = uploads.put, uploads.get, uploads.release
        else:
            get = lambda k: _map(torch.clone, pool[k % len(pool)])
    else:
        resident = make_allsky_inputs(chunk, nlay, cloud_optics=cld_lw,
                                      device=device)
        get = lambda k: resident

    put(0)
    cur = get(0)
    out = step(cur)                                  # builds the kernels
    _sync(device)
    outs = []
    t0 = time.perf_counter()
    with checks_disabled():
        for k in range(n_chunks):
            if k + 1 < n_chunks:
                put(k + 1)        # beside this chunk's step on the device
            for _ in range(reps_per_chunk):
                out = step(cur)
            if keep:
                outs.append(out)
            release(k)
            if k + 1 < n_chunks:
                cur = get(k + 1)
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
