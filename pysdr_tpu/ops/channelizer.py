"""Critically-sampled polyphase filterbank (PFB) channelizer.

The reference caps out at MAX_RX=6 independently-mixed receivers inside one
passband (reference params.py:33, receiver.py:825-835) because each RX pays
a full mix+decimate chain in Python. The generalization here is a
polyphase channelizer: ONE filter + ONE FFT splits the passband into N
uniform channels at fs/N each — the standard radio-astronomy F-engine
structure (see PAPERS.md) — giving the 64+-channel configuration of
BASELINE.json config 5. Per-channel fine tuning/demod then runs on the
channel streams via the ordinary receiver chain.

Math (weighted overlap-add, critically sampled):
    v[m, r] = sum_k h[r + k*N] * x[(m-k)*N + r]      (branch filtering)
    y[m, c] = sum_r v[m, r] * exp(-j 2*pi c r / N)   (= DFT over r)
so channel c is x mixed down by c*fs/N and decimated by N. Branch filtering
is K shifted elementwise multiply-adds over the (M, N) block view; the
channel transform is a DFT matmul in the banks (channel_transform) and a
batched FFT in channelize_block.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu.ops import cplx, fir, precision


@dataclasses.dataclass(frozen=True)
class ChannelizerDesign:
    fs_in: float
    n_channels: int
    taps_per_branch: int = 12
    atten_db: float = 70.0

    @property
    def fs_channel(self) -> float:
        return self.fs_in / self.n_channels

    def prototype(self) -> np.ndarray:
        """Lowpass prototype, cutoff at half the channel spacing, unity DC
        gain (so a unit tone at a channel center comes out at unit
        amplitude after the channel DFT)."""
        n, k = self.n_channels, self.taps_per_branch
        return fir.lowpass(n * k, 0.5 * self.fs_channel, self.fs_in,
                           self.atten_db)

    def center_freqs_hz(self) -> np.ndarray:
        """Channel center frequencies (fftfreq order: 0, +, ..., -)."""
        return np.fft.fftfreq(self.n_channels, 1.0 / self.fs_in)


def pack_branch_weights(h: np.ndarray, n_channels: int) -> np.ndarray:
    """(N*K,) prototype -> per-branch taps (N, K): h_pp[r, k] = h[r + k*N]."""
    n = n_channels
    k = len(h) // n
    return np.ascontiguousarray(
        np.asarray(h, np.float32).reshape(k, n).T)        # (N, K)


def history_len(design: ChannelizerDesign) -> int:
    """Input samples carried across blocks: (K-1)*N."""
    return (design.taps_per_branch - 1) * design.n_channels


def dft_matrix(n_channels: int, cols: np.ndarray | None = None):
    """DFT matrix W[r, c] = exp(-2j pi c r / N) packed as two float32
    (N, C) real/imag factors. As a matmul the channel transform's column
    dimension shards cleanly over a 'ch' mesh axis: each device computes
    only its own channels' DFT columns with NO collectives (an FFT along
    the sharded axis would force an all-to-all). It costs O(N) work per
    sample against the FFT's O(log N)."""
    n = n_channels
    if cols is None:
        cols = np.arange(n)
    r = np.arange(n)[:, None]
    w = np.exp(-2j * np.pi * r * np.asarray(cols)[None, :] / n)
    return (np.ascontiguousarray(w.real, dtype=np.float32),
            np.ascontiguousarray(w.imag, dtype=np.float32))


def branch_filter(x, hist, weights, n_channels: int):
    """Polyphase branch filtering only (no channel transform): complex64
    in, returns (v (M, N) complex64, new_hist). v[m, r] is branch r at
    decimated time m.

    v[m, r] = sum_k h_pp[r, k] * xb[m + K-1-k, r]: K shifted elementwise
    multiply-adds over the (M, N) block view, which XLA fuses into one
    elementwise pass (a diagonal-feature conv form would spend N times
    the useful multiply-adds and pay transpose/pad copies)."""
    n = x.shape[0]
    nch = n_channels
    xp = jnp.concatenate([hist, x])
    mk = xp.shape[0] // nch
    xb = xp.reshape(mk, nch)
    w = jnp.asarray(weights)                         # (N, K)
    kk = w.shape[-1]
    m = mk - (kk - 1)
    v = xb[kk - 1:kk - 1 + m] * w[:, 0][None, :]
    for t in range(1, kk):
        v = v + xb[kk - 1 - t:kk - 1 - t + m] * w[:, t][None, :]
    return v, xp[n:]


def channel_transform(v, w_re, w_im):
    """v (M, N) complex64 @ DFT (N, C) -> (M, C) complex64 channel
    streams, as four real matmuls."""
    yr = (precision.dot(v.real, w_re) - precision.dot(v.imag, w_im))
    yi = (precision.dot(v.real, w_im) + precision.dot(v.imag, w_re))
    return jax.lax.complex(yr, yi)


@functools.partial(jax.jit, static_argnames=("n_channels",))
def channelize_block(x, hist, weights, *, n_channels: int):
    """Split one block into N channel streams.

    x: complex64 (n,) or packed float32 (n, 2); hist likewise; weights:
    float32 (N, K) per-branch taps from pack_branch_weights. Packed in
    -> packed out (the packed re/im boundary format, ops/cplx.py).
    Returns (y (n//N, N) — row m, channel c in fftfreq order, new_hist).
    """
    packed = not jnp.iscomplexobj(x)
    if packed:
        x = cplx.unpack(x)
        hist = cplx.unpack(hist)
    assert x.shape[0] % n_channels == 0
    vc, new_hist = branch_filter(x, hist, weights, n_channels)
    y = jnp.fft.fft(vc, axis=-1).astype(jnp.complex64)
    if packed:
        return cplx.pack(y), cplx.pack(new_hist)
    return y, new_hist
