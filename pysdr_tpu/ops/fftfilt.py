"""Overlap-save FFT convolution: streaming FIR in the frequency domain.

The reference's `convolver.convolve_fast` (external sig_proc; used for the
aux bandpass at reference receiver.py:207,861-862) is a classic
overlap-save FFT filter. Equivalent here, for the audio-rate filters
(AF / carrier / pilot / L-R, 256 complex taps each): one whole-block FFT
per filter instead of a 256-tap direct convolution — O(log n) work per
sample vs O(T). Bit-compatibility with the direct
path is float-level, verified in tests/test_fftfilt.py; the choice is a
static DemodDesign flag so both lower to fixed shapes.

Streaming contract matches ops/resample.fir_block_cmpx exactly:
y[i] = sum_t taps[t] * xp[i + T - 1 - t] over xp = [hist | x], with the
new history being the last T-1 input samples.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def fft_fir_block(x, hist, taps_c):
    """Streaming complex-taps FIR via one circular FFT per block.

    x: complex64 (n,); hist: complex64 (T-1,); taps_c: complex64 (T,)
    (traced — a filter-bank row swap does not recompile).
    Returns (y complex64 (n,), new_hist). The FFT length is the static
    next power of two >= n + T - 1, which keeps the linear-convolution
    region alias-free for the n output samples starting at T-1.
    """
    n = x.shape[0]
    t = taps_c.shape[0]
    xp = jnp.concatenate([hist, x])          # (n + T - 1,)
    nfft = _next_pow2(n + t - 1)
    xf = jnp.fft.fft(xp, n=nfft)
    hf = jnp.fft.fft(taps_c, n=nfft)
    y_full = jnp.fft.ifft(xf * hf)
    y = y_full[t - 1:t - 1 + n].astype(jnp.complex64)
    new_hist = xp[n:] if t > 1 else hist
    return y, new_hist
