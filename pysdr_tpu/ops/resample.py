"""Streaming polyphase rational resampler / decimator (pure JAX).

The reference's decimator (`rx.dec`, external sig_proc; driven at reference
receiver.py:553 and rate-planned at params.py:405-444) resamples each
channel from the RF rate to the audio rate by a rational UP/DOWN with a
selectable anti-alias ("video") filter. Here the whole polyphase computation
is one framed product, a window of L = down + Kp - 1 inputs at stride
`down` against all `up` phases at once:

  y[j*up + u] = sum_t  h_pp[p_u, t] * x[j*down + off_u - t]
      with p_u = (u*down) % up,  off_u = floor(u*down/up)

(the weights are the phase taps scattered to their per-phase alignment,
pack_weights), evaluated as shifted-slab matmuls (_slab_matmul). Real and
imaginary parts are separate operands. Streaming state is the last Kp-1
input samples, so chunked processing is bit-identical to whole-signal
processing (the state-carry pattern the reference proves in
sigs/iir.py:83-105).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu.ops import precision


def taps_per_phase(ntaps: int, up: int) -> int:
    return -(-ntaps // up)  # ceil


def pack_weights(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """Pack prototype taps h (ntaps,) into conv weights (up, 1, L) float32.

    W[u, 0, off_u + Kp - 1 - t] = h[p_u + up*t]   (zero elsewhere)
    so that a VALID conv with stride `down` over [hist | x] yields the
    polyphase outputs in interleaved order. Host-side (numpy).
    """
    h = np.asarray(h, np.float32)
    ntaps = h.shape[0]
    kp = taps_per_phase(ntaps, up)
    h_pad = np.zeros(up * kp, np.float32)
    h_pad[:ntaps] = h
    h_pp = h_pad.reshape(kp, up).T  # (up, kp): h_pp[p, t] = h[p + up*t]
    L = down + kp - 1
    W = np.zeros((up, 1, L), np.float32)
    for u in range(up):
        p_u = (u * down) % up
        off_u = (u * down) // up
        s = off_u + kp - 1 - np.arange(kp)
        W[u, 0, s] = h_pp[p_u]
    return W


def pack_weight_bank(bank: np.ndarray, up: int, down: int) -> np.ndarray:
    """Pack a filter bank (n_bw, ntaps) -> (n_bw, up, 1, L)."""
    return np.stack([pack_weights(h, up, down) for h in bank])


def history_len(ntaps: int, up: int) -> int:
    """Input-rate history samples carried across blocks: Kp - 1."""
    return taps_per_phase(ntaps, up) - 1


def _slab_matmul(xp, weights, m: int, down: int, up: int):
    """y[j, u] = sum_s xp[j*down + s] * W[u, s]  without materializing
    the (m, L) frame matrix.

    The sliding window F[j, s] = xp[j*down + s] decomposes over
    s = t*down + d into q row-shifted VIEWS of the (m+q, down) reshape
    of the input, so the framed matmul is exactly

        y = sum_t  X[t:t+m] @ W[:, t*down:(t+1)*down].T

    q (= ceil(L/down)) skinny matmuls over shifted views of ONE buffer.
    Concatenating the views into an explicit (m, L) frame matrix first
    would make XLA materialize it, ~L/down times the input read and
    written per step; this form touches the input q times and writes
    only the (m, up) output. Works for real xp (complex splits into
    re/im in the caller)."""
    L = weights.shape[-1]
    q = -(-L // down)  # ceil
    need = (m + q) * down
    xp = jnp.concatenate([xp, jnp.zeros(need - xp.shape[0], xp.dtype)])
    X = xp.reshape(m + q, down)
    # pad W (up, L) out to (up, q*down), then slab t is (down, up)
    w = weights[:, 0, :]
    w = jnp.pad(w, ((0, 0), (0, q * down - L)))
    wq = w.reshape(w.shape[0], q, down)        # (up, q, down)
    y = precision.dot(X[0:m], wq[:, 0, :].T)
    for t in range(1, q):
        y = y + precision.dot(X[t:t + m], wq[:, t, :].T)
    return y                                   # (m, up)


@functools.partial(jax.jit, static_argnames=("up", "down"))
def resample_block(x, hist, weights, *, up: int, down: int):
    """Resample one block.

    x       : complex64 (n,)  with n % down == 0
    hist    : complex64 (Kp-1,)  previous block's tail (zeros at start)
    weights : float32 (up, 1, L) from pack_weights (traced — bank row swap
              does not recompile)
    returns : (y complex64 (n*up//down,), new_hist (Kp-1,))

    Implementation note: formulated as q shifted-slab matmuls
    (_slab_matmul) rather than a strided window=down+Kp-1 conv or one
    framed matmul over a materialized frame matrix (see _slab_matmul).
    """
    n = x.shape[0]
    assert n % down == 0, (n, down)
    kp_m1 = hist.shape[0]
    xp = jnp.concatenate([hist, x])           # (n + Kp - 1,)
    m = n // down
    yr = _slab_matmul(xp.real, weights, m, down, up)
    yi = _slab_matmul(xp.imag, weights, m, down, up)
    y = jax.lax.complex(yr, yi).reshape(m * up)
    new_hist = xp[n:] if kp_m1 > 0 else hist
    return y, new_hist


@functools.partial(jax.jit, static_argnames=("up", "down"))
def resample_block_real(x, hist, weights, *, up: int, down: int):
    """Real-input variant (float32 x) — used for WFM audio decimation."""
    n = x.shape[0]
    assert n % down == 0
    kp_m1 = hist.shape[0]
    xp = jnp.concatenate([hist, x])
    m = n // down
    y = _slab_matmul(xp, weights, m, down, up).reshape(m * up)
    new_hist = xp[n:] if kp_m1 > 0 else hist
    return y, new_hist


@functools.partial(jax.jit, static_argnames=("up", "down"))
def mixed_resample_bank(x, hist, weights, k, p0, *, up: int, down: int):
    """Fused NCO mix + polyphase resample for a WHOLE channel bank from
    the SHARED raw RF block — no per-channel mixed stream is ever
    materialized.

    The per-channel pipeline is y_ch = resample(x * LO_ch). Both are
    linear, and on the polyphase index grid i = j*down + s the exact
    integer-phase LO (ops/nco.py) factors:

        LO[j*down + s] = exp(-j2π(p0 + k(j·down+s))/D)
                       = A[j] * C[t] * B[d]        (s = t*down + d)

    with A[j] = exp(-j2π(p0 + kd·j)/D), kd = (k*down) mod D,
    C[t] = exp(-j2π kd·t/D), B[d] = exp(-j2π k·d/D) — EXACT on the
    integer grid (phases add mod D; only float rounding differs from the
    per-sample form). Folding C·B into the (real) anti-alias taps makes
    the resample of the MIXED signal a matmul of the shared RAW slab
    matrix X against per-channel COMPLEX weights, followed by a cheap
    per-row scale by A:

        y_ch[j, u] = A_ch[j] · Σ_t (X[t:t+m] @ (wq[:,t,:]·C_ch[t]·B_ch).T)[j, u]

    Why: the per-channel form writes and rereads one mixed stream per
    channel (n_rx x 8 bytes per RF sample, per block). Here the slab
    matrix is built ONCE (2 components instead of 2·n_rx) and every
    channel rides the N dimension of the same matmuls (N = 2·n_rx·up
    instead of up).

    x: complex64 (n,) raw RF block, n % down == 0 (shared by the bank);
    hist: complex64 (Kp-1,) raw tail of the previous block;
    weights: float32 (n_rx, up, 1, L) per-channel packed video taps
    (traced — bank-row swaps don't recompile);
    k, p0: int32 (n_rx,) NCO numerators and phase indices at hist[0].
    Returns bb complex64 (n_rx, n*up//down).

    Equivalence with the per-channel mix_down + resample_block chain is
    pinned in tests/test_resample.py (float-rounding-level).
    """
    from pysdr_tpu.ops import nco

    n = x.shape[0]
    assert n % down == 0, (n, down)
    n_rx, up_w, _, L = weights.shape
    assert up_w == up
    q = -(-L // down)
    m = n // down
    # one concatenation (hist | x | zero tail) builds the slab buffer
    xp = jnp.concatenate(
        [hist, x,
         jnp.zeros((m + q) * down - n - hist.shape[0], x.dtype)])
    Xr = xp.real.reshape(m + q, down)
    Xi = xp.imag.reshape(m + q, down)

    kd = nco.mul_mod(k, down)                              # (n_rx,)
    B = jax.vmap(lambda kk: nco.phasor_table(kk, 0, down))(k)
    C = jax.vmap(lambda kk: nco.phasor_table(kk, 0, q))(kd)
    A = jax.vmap(lambda kk, pp: nco.phasor_table(kk, pp, m))(kd, p0)

    w = jnp.pad(weights[:, :, 0, :], ((0, 0), (0, 0), (0, q * down - L)))
    wq = w.reshape(n_rx, up, q, down)
    Wc = wq * (C[:, None, :, None] * B[:, None, None, :])  # complex

    nu = n_rx * up
    # RHS for slab t: (down, 2*nu) = [Re W_t | Im W_t]
    Wt = Wc.transpose(2, 3, 0, 1).reshape(q, down, nu)     # (q, down, nu)
    R = jnp.concatenate([Wt.real, Wt.imag], axis=2)
    Sr = precision.dot(Xr[0:m], R[0])
    Si = precision.dot(Xi[0:m], R[0])
    for t in range(1, q):
        Sr = Sr + precision.dot(Xr[t:t + m], R[t])
        Si = Si + precision.dot(Xi[t:t + m], R[t])
    # (Xr + jXi) @ (Wr + jWi): re = XrWr - XiWi, im = XrWi + XiWr
    y_re = Sr[:, :nu] - Si[:, nu:]
    y_im = Sr[:, nu:] + Si[:, :nu]
    y = jax.lax.complex(y_re, y_im).reshape(m, n_rx, up)
    y = y * A.T[:, :, None]
    return y.transpose(1, 0, 2).reshape(n_rx, m * up)


def fir_block(x, hist, taps):
    """Same-rate streaming FIR (up=down=1) for real float32 taps on a
    complex or real signal. taps: float32 (T,) in natural h[0..T-1] order;
    y[i] = sum_t taps[t] * x[i-t]. hist: (T-1,) previous tail."""
    t = taps.shape[0]
    xp = jnp.concatenate([hist, x])
    w = taps[::-1][None, None, :]
    if jnp.iscomplexobj(xp):
        lhs = jnp.stack([xp.real, xp.imag])[:, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, w, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=precision.matmul_precision(),
            preferred_element_type=jnp.float32)
        y = jax.lax.complex(out[0, 0], out[1, 0])
    else:
        out = jax.lax.conv_general_dilated(
            xp[None, None, :], w, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=precision.matmul_precision(),
            preferred_element_type=jnp.float32)
        y = out[0, 0]
    new_hist = xp[x.shape[0]:] if t > 1 else hist
    return y, new_hist


def fir_block_cmpx(x, hist, taps_c):
    """Same-rate streaming FIR with COMPLEX taps (one-sided SSB/CW filters,
    reference receiver.py:874). x complex64; taps_c complex64 (T,)."""
    t = taps_c.shape[0]
    xp = jnp.concatenate([hist, x])
    # (a+jb)*(c+jd): four real convs batched as one conv with 2 in-feats
    # and 2 out-channels.
    lhs = jnp.stack([xp.real, xp.imag])[None, :, :]        # (1, 2, n+T-1)
    hr, hi = taps_c.real[::-1], taps_c.imag[::-1]
    # out_real = hr*xr - hi*xi ; out_imag = hi*xr + hr*xi
    w = jnp.stack([jnp.stack([hr, -hi]), jnp.stack([hi, hr])])  # (2,2,T)
    out = jax.lax.conv_general_dilated(
        lhs, w, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=precision.matmul_precision(),
        preferred_element_type=jnp.float32)                 # (1, 2, n)
    y = jax.lax.complex(out[0, 0], out[0, 1])
    new_hist = xp[x.shape[0]:] if t > 1 else hist
    return y, new_hist
