"""Numerically-exact NCO (numerically controlled oscillator) / quadrature mixer.

Reference behavior: `dsp.signal_generator(f, chunk, fs).quad_mixer(x)` with
frequencies snapped to multiples of SRATE/RB_SIZE so a precomputed LO table is
periodic and phase never drifts (reference utils.py:277-289 `adjust_foffset`,
receiver.py:552-556,822).

Design: no table, no float phase accumulation. A frequency is an
integer numerator `k` of cycles/sample over a fixed power-of-two denominator
`DENOM`; the phase index is advanced with exact int32 modular arithmetic
(hierarchically decomposed so no product overflows int32 — int64 requires
jax x64 which we keep off). Phase error is therefore exactly zero over
arbitrarily long streams; the only approximation is the one-time frequency
snap of fs/DENOM (= 0.5 Hz at 2.048 Msps), strictly finer than the
reference's SRATE/RB_SIZE snap (≈ 62 Hz at 2.048 Msps / 32k buffer).

Angles are materialized per block as elementwise cos/sin of an
int-derived float32 that is exactly representable, so the mixer fuses
with downstream FIR work under XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Phase resolution: frequencies are k/DENOM cycles/sample, k int32.
DENOM_BITS = 22
DENOM = 1 << DENOM_BITS          # 4194304
_L1 = 1 << 8                     # hierarchical index split: i = q2*L2 + q1*L1 + r
_L2 = 1 << 16
_TWO_PI = 2.0 * np.pi


def snap_freq(freq_hz: float, fs: float) -> int:
    """Snap a frequency to the NCO grid; returns the int numerator k.

    Negative frequencies map to DENOM - |k| (mod arithmetic), so `k` is
    always in [0, DENOM). Host-side (python ints), used at config build.
    """
    k = int(round(freq_hz / fs * DENOM)) % DENOM
    return k


def snapped_freq_hz(k, fs: float):
    """Inverse of snap_freq (returns the realizable frequency in Hz)."""
    k = np.asarray(k)
    ks = np.where(k > DENOM // 2, k - DENOM, k)  # signed
    return ks / DENOM * fs


def phase_indices(k, p0, n: int):
    """Exact phase indices ((p0 + k*i) mod DENOM for i in [0, n)) as int32.

    `k`, `p0` may be traced int32 scalars; `n` is static. All intermediate
    products stay below 2^31: k < 2^22, r < 2^8, q1 < 2^8, and the
    level-stride numerators are reduced mod DENOM before multiplying.
    Supports n up to 2^24 samples per block.
    """
    assert n <= (1 << 24), "block too large for 3-level int32 phase decomposition"
    k = jnp.asarray(k, jnp.int32)
    p0 = jnp.asarray(p0, jnp.int32)
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    r = i % _L1
    q1 = (i // _L1) % (_L2 // _L1)
    q2 = i // _L2
    k_l1 = (k * _L1) % DENOM
    k_l2 = (k_l1 * (_L2 // _L1)) % DENOM
    term_r = (k * r) % DENOM
    term1 = (k_l1 * q1) % DENOM
    term2 = (k_l2 * q2) % DENOM
    return (p0 + term_r + term1 + term2) % DENOM


def advance(k, p0, n: int):
    """New phase index after n samples: (p0 + k*n) mod DENOM, exactly.

    Valid for arbitrarily large n (streaming super-blocks pass whole
    n_stream*segment totals here): k*n ≡ k*(n mod DENOM) (mod DENOM), so n
    is reduced first and the 3-level split then keeps every int32 product
    below 2^30 (q2 < 2^6 after the reduction).
    """
    k = jnp.asarray(k, jnp.int32)
    p0 = jnp.asarray(p0, jnp.int32)
    n = n % DENOM
    r = n % _L1
    q1 = (n // _L1) % (_L2 // _L1)
    q2 = n // _L2
    k_l1 = (k * _L1) % DENOM
    k_l2 = (k_l1 * (_L2 // _L1)) % DENOM
    return (p0 + (k * r) % DENOM + (k_l1 * q1) % DENOM
            + (k_l2 * q2) % DENOM) % DENOM


def mul_mod(k, c: int):
    """(k * c) mod DENOM for a STATIC python int c, int32-safe for traced
    k < DENOM: binary expansion of c keeps every product below 2^23
    (a bare k * c overflows int32 for c >= 512)."""
    k = jnp.asarray(k, jnp.int32)
    c = int(c) % DENOM
    res = jnp.zeros_like(k)
    while c:
        if c & 1:
            res = (res + k) % DENOM
        k = (k * 2) % DENOM
        c >>= 1
    return res


def phasor_table(k, p0, n: int, sign: float = -1.0):
    """exp(sign * j * 2π (p0 + k i)/DENOM) for i in [0, n), complex64 (n,).

    Small-n building block for phase factorizations (the LO over a
    strided index grid factors into products of these on the exact
    integer phase grid — ops/resample.mixed_resample_bank)."""
    th = phase_indices(k, p0, n).astype(jnp.float32) \
        * jnp.float32(_TWO_PI / DENOM)
    return jax.lax.complex(jnp.cos(th), jnp.float32(sign) * jnp.sin(th))


def lo_angles(k, p0, n: int):
    """Block of LO phase angles in radians, float32, shape (n,)."""
    idx = phase_indices(k, p0, n)
    # idx < 2^22 < 2^24 so the int->float32 conversion is exact.
    return idx.astype(jnp.float32) * jnp.float32(_TWO_PI / DENOM)


def _pick_factor(n: int) -> int:
    """Largest power-of-two B <= 2048 dividing n (1 if n is odd)."""
    B = 1
    while B < 2048 and n % (B * 2) == 0:
        B *= 2
    return B


def _lo_factored(k, p0, n: int, sign: float):
    """exp(sign * j * 2π (p0 + k i)/DENOM) for i in [0, n) as an
    (n//B, B) outer product of two unit-phasor tables.

    Splitting i = a*B + b gives θ_i = θ_hi[a] + θ_lo[b] with both parts
    on the exact integer phase grid, so the LO block is
    hi[a] * lo[b] — O(n/B + B) ≈ O(2√n) transcendentals instead of one
    cos+sin PER SAMPLE. On the real chip the per-sample form was ~90%
    of the whole bank4 device step (33.7M transcendentals at <1 Gop/s,
    two ~45 ms fusions — probes/results_r05/device_profile.json); the
    factored form is a pure elementwise multiply that XLA fuses into
    the mix. Phase accuracy: one extra complex rounding (~1e-7)
    vs direct cos(θ), same order as the direct form's own rounding."""
    B = _pick_factor(n)
    if B < 8 or n // B < 2:                    # tiny/odd block: direct
        return phasor_table(k, p0, n, sign)
    hi = phasor_table(mul_mod(k, B), p0, n // B, sign)
    lo = phasor_table(k, 0, B, sign)
    return hi[:, None] * lo[None, :]           # (n//B, B)


def tone(k, p0, n: int):
    """Complex LO block exp(+j 2π (p0 + k i)/DENOM), complex64 (n,).

    The `signal_generator` equivalent (reference receiver.py:822 BFO)."""
    return _lo_factored(k, p0, n, sign=1.0).reshape(n)


def mix_down(x, k, p0):
    """Quadrature downconvert: y[i] = x[i] * exp(-j 2π (p0 + k i)/DENOM).

    Shifts a signal component at +f_k down to 0 Hz — the reference's
    `lo.quad_mixer(x)` (receiver.py:553) with `lo.change_freq` folded into
    the integer k. Returns (y, new_p0).
    """
    n = x.shape[-1]
    lo = _lo_factored(k, p0, n, sign=-1.0)
    if lo.ndim == 2:
        a, B = lo.shape
        y = (x.reshape(*x.shape[:-1], a, B) * lo).reshape(x.shape)
    else:
        y = x * lo
    return y, advance(k, p0, n)
