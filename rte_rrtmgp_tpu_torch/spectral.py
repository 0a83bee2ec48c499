"""Spectral discretization metadata.

A copy of ``rte_rrtmgp_tpu.spectral`` (numpy only): the reference's
``ty_optical_props`` *base class* state (rte/frontend/mo_optical_props.F90:
78-104): wavenumber limits per band and the band -> g-point map, as a small
hashable object whose band <-> g-point indices are host numpy arrays.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["SpectralGrid"]


@dataclasses.dataclass(frozen=True)
class SpectralGrid:
    """Band structure: ``band_lims_wvn[b] = (wvn_lo, wvn_hi)`` in cm^-1 and
    ``band_lims_gpt[b] = (gpt_lo, gpt_hi)`` as *1-based inclusive* g-point
    limits (matching the reference's data files / conventions, e.g.
    mo_optical_props.F90:112 ``init``)."""

    band_lims_wvn: tuple  # ((lo, hi), ...) length nband
    band_lims_gpt: tuple  # ((lo, hi), ...) length nband, 1-based inclusive

    @staticmethod
    def from_arrays(band_lims_wvn, band_lims_gpt=None) -> "SpectralGrid":
        wvn = np.asarray(band_lims_wvn, dtype=np.float64).reshape(-1, 2)
        if band_lims_gpt is None:
            # one g-point per band (reference default when band2gpt absent)
            n = wvn.shape[0]
            gpt = np.stack([np.arange(1, n + 1), np.arange(1, n + 1)], axis=-1)
        else:
            gpt = np.asarray(band_lims_gpt, dtype=np.int64).reshape(-1, 2)
        return SpectralGrid(
            band_lims_wvn=tuple(map(tuple, wvn.tolist())),
            band_lims_gpt=tuple(map(tuple, gpt.tolist())),
        )

    @property
    def nband(self) -> int:
        return len(self.band_lims_gpt)

    @property
    def ngpt(self) -> int:
        return max(hi for _, hi in self.band_lims_gpt)

    @cached_property
    def gpt2band(self) -> np.ndarray:
        """0-based band index for each g-point, shape (ngpt,)."""
        out = np.zeros(self.ngpt, dtype=np.int32)
        for b, (lo, hi) in enumerate(self.band_lims_gpt):
            out[lo - 1 : hi] = b
        return out

    @cached_property
    def band_lims_wvn_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_wvn, dtype=np.float64)

    @cached_property
    def band_lims_gpt_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_gpt, dtype=np.int64)

    def bands_are_equal(self, other: "SpectralGrid") -> bool:
        """Same wavenumber bands (reference mo_optical_props.F90:1233-1246)."""
        if self.nband != other.nband:
            return False
        a = self.band_lims_wvn_array
        b = other.band_lims_wvn_array
        return bool(np.allclose(a, b, rtol=0.0, atol=1e-5 * np.abs(a).max()))

    def gpoints_are_equal(self, other: "SpectralGrid") -> bool:
        """Same bands *and* same g-point map (mo_optical_props.F90:1248-1258)."""
        return (
            self.bands_are_equal(other)
            and self.ngpt == other.ngpt
            and self.band_lims_gpt == other.band_lims_gpt
        )

    def expand(self, band_values):
        """Expand per-band values (..., nband) to per-g-point (..., ngpt)
        (reference ``expand`` mo_optical_props.F90:1218-1228)."""
        return np.take(band_values, self.gpt2band, axis=-1) if isinstance(
            band_values, np.ndarray
        ) else band_values[..., self.gpt2band]
