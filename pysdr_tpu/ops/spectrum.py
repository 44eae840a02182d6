"""On-device PSD / waterfall engine.

Equivalent of the reference `dsp.spectrum` + the plotting-side PSD math
(reference Plotting.py:376-467: `periodogram` with windowing and overlap;
waterfall as a rolling (NFFT, rows) array, Plotting.py:539-626 with median
background estimate and dynamic-range clamp). Everything runs on device;
only the final uint8 image / float rows cross to the host for display.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu.ops import cplx


@dataclasses.dataclass(frozen=True)
class SpectrumDesign:
    fs: float
    nfft: int = 1024
    overlap: float = 0.5        # reference OVERLAP=0.5 (Plotting.py:618)
    window: str = "hann"
    average: bool = True        # average all segments in the block

    @property
    def hop(self) -> int:
        return max(1, int(self.nfft * (1.0 - self.overlap)))

    def freqs_hz(self, fc: float = 0.0) -> np.ndarray:
        return np.fft.fftshift(np.fft.fftfreq(self.nfft, 1.0 / self.fs)) + fc

    def window_array(self) -> np.ndarray:
        n = self.nfft
        if self.window == "hann":
            w = np.hanning(n)
        elif self.window == "kaiser":
            w = np.kaiser(n, 8.6)   # reference RTTY window (rtty.py:834-845)
        else:
            w = np.ones(n)
        return (w / np.sqrt(np.mean(w ** 2))).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "average"))
def periodogram(x, window, *, nfft: int, hop: int, average: bool = True):
    """Welch-style PSD of one block, fftshifted, in dB.

    x: complex64 (n,) or packed float32 (n, 2) (the packed boundary
    format, ops/cplx.py). Returns (nfft,) float32 if average else
    (nseg, nfft). Two-sided (complex input), matching the reference RF/BB
    panes; AF panes pass real audio cast to complex.
    """
    if not jnp.iscomplexobj(x) and x.ndim == 2:
        x = cplx.unpack(x)
    n = x.shape[0]
    if n < nfft:
        # short block: zero-pad to one full segment (the old gather
        # clamped out-of-bounds indices, silently replicating the last
        # sample hundreds of times into a bogus spectrum)
        x = jnp.pad(x, (0, nfft - n))
        n = nfft
    nseg = max(1, (n - nfft) // hop + 1)
    idx = jnp.arange(nseg)[:, None] * hop + jnp.arange(nfft)[None, :]
    segs = x[idx] * window[None, :]
    spec = jnp.fft.fft(segs, axis=-1)
    p = (spec.real ** 2 + spec.imag ** 2) / nfft
    if average:
        p = jnp.mean(p, axis=0)
    p = jnp.fft.fftshift(p, axes=-1)
    return 10.0 * jnp.log10(jnp.maximum(p, 1e-20))


@functools.partial(jax.jit, static_argnames=())
def waterfall_push(wf, row):
    """Roll the waterfall and insert the newest PSD row at index 0.
    wf: (rows, nfft); reference keeps (NFFT, 100) via concat
    (Plotting.py:543)."""
    return jnp.concatenate([row[None, :], wf[:-1]], axis=0)


@jax.jit
def waterfall_shift(wf, bins):
    """Frequency-shift realignment on retune — reference `shift_waterfall`
    np.roll (Plotting.py:688-695). bins: traced int32 (+right)."""
    return jnp.roll(wf, bins, axis=1)


@jax.jit
def background_median(psd_row):
    """Median background estimate used before peak picking
    (Plotting.py:583-600)."""
    return jnp.median(psd_row)


@functools.partial(jax.jit, static_argnames=("max_peaks", "min_dist"))
def find_peaks(psd_row, height_db, *, max_peaks: int = 32, min_dist: int = 8):
    """Local-maxima peak picker with minimum height and spacing — the
    on-device analogue of scipy.signal.find_peaks as used for pan-adaptor
    spot markers (reference Plotting.py:583-600). Returns (indices (max_peaks,)
    int32 — -1 padded, values (max_peaks,) float32), sorted by height desc.
    min_dist is enforced by suppressing non-maxima within a ±min_dist window.
    """
    n = psd_row.shape[0]
    pad = jnp.full((min_dist,), -jnp.inf, psd_row.dtype)
    xp = jnp.concatenate([pad, psd_row, pad])
    windows = jnp.stack([xp[i:i + n] for i in range(2 * min_dist + 1)])
    # strict-left / loose-right: exactly ONE flag per equal-valued
    # plateau (>= against the whole window flagged every tied bin,
    # defeating min_dist for ties)
    left_max = jnp.max(windows[:min_dist], axis=0)
    right_max = jnp.max(windows[min_dist + 1:], axis=0)
    is_max = (psd_row > left_max) & (psd_row >= right_max)
    ok = is_max & (psd_row >= height_db)
    score = jnp.where(ok, psd_row, -jnp.inf)
    vals, idx = jax.lax.top_k(score, max_peaks)
    idx = jnp.where(jnp.isfinite(vals), idx, -1)
    return idx.astype(jnp.int32), vals


@functools.partial(jax.jit, static_argnames=())
def clamp_dynamic_range(wf, dr_db):
    """Dynamic-range clamp `max(zz, zmax - PAN_DR)` (Plotting.py:618-626)."""
    zmax = jnp.max(wf)
    return jnp.maximum(wf, zmax - dr_db)


def to_image_u8(wf, dr_db=60.0):
    """Quantize a waterfall to uint8 rows for the host viewer (the imager/
    colormap-LUT path, Plotting.py:115-276, stays host-side)."""
    zmax = jnp.max(wf)
    z = jnp.clip((wf - (zmax - dr_db)) / dr_db, 0.0, 1.0)
    return (z * 255.0).astype(jnp.uint8)
