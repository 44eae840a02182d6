"""Automatic gain control as a parallel scan.

The reference AGC (external sig_proc, loop documented in sigs/agc.m:6-13 and
state dumped at watchdog.py:296-302: .agc/.gain/.maxbuf/.ref/.err) is a
max-tracking feedback loop with a one-pole smoother, beta=0.1. The
formulation here is feedforward (parallel in time): envelope = asymmetric one-pole of |x| (fast
attack, slow decay — each a first-order linear recurrence evaluated with an
associative scan, see scanops.py), gain = ref/max(envelope, floor). Feedback
vs feedforward differ only during attack transients; attack/decay behavior
is validated against a serial simulation of the reference loop in
tests/test_agc.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pysdr_tpu.ops import scanops


@dataclasses.dataclass(frozen=True)
class AGCParams:
    ref: float = 0.5          # target envelope (reference .ref)
    attack: float = 0.1       # one-pole alpha when |x| > env (agc.m beta)
    decay: float = 0.001      # one-pole alpha when |x| < env
    floor: float = 1e-6       # gain clamp = ref/floor
    max_gain: float = 1e4


def init_state():
    # Host numpy, not jnp: the bank packs and uploads its state tree in
    # one place (ops/cplx.py); as a constant inside traced code numpy is
    # equivalent.
    import numpy as np
    return np.zeros((), np.float32)  # envelope estimate


def agc_block(x, env_prev, p: AGCParams, enabled=True):
    """Apply AGC to a block. x: float32 or complex64 (n,).
    Returns (y, env_last, gain_last). `enabled` may be a traced bool
    (per-channel toggle without recompile)."""
    mag = jnp.abs(x).astype(jnp.float32)
    # Asymmetric one-pole: alpha depends on sign of (mag - env). A varying
    # alpha makes the recurrence y[n] = (1-a[n]) y[n-1] + a[n] x[n] with
    # a[n] data-dependent... a[n] depends on y[n-1] (feedback). Approximate
    # with a two-pass scheme: fast-attack envelope via running max over a
    # short window + slow decay via linear recurrence on the windowed max.
    w = 64  # attack window (samples); sub-ms at 48 kHz
    n = mag.shape[0]
    pad = (-n) % w
    m = jnp.max(jnp.pad(mag, (0, pad)).reshape(-1, w), axis=1)
    # exact pole conversion to the window rate: w per-sample steps of
    # (1-decay) equal one window step of (1-decay)^w
    alpha_w = 1.0 - (1.0 - p.decay) ** w
    env_c, env_last = scanops.one_pole(m, alpha_w, env_prev)
    env_c = jnp.maximum(env_c, m)           # instant attack within window
    env = jnp.repeat(env_c, w)[:n]
    gain = p.ref / jnp.maximum(env, p.floor)
    gain = jnp.minimum(gain, p.max_gain)
    gain = jnp.where(enabled, gain, 1.0)
    y = x * gain.astype(x.real.dtype)
    # carry the SMOOTHED envelope, deliberately NOT max(env_last, m[-1]):
    # within a block the instant attack applies to the gain only and is
    # never fed back into the one-pole recursion, so carrying the
    # attacked value would make chunked processing diverge from one
    # batch call (the block-invariance guarantee every streaming test
    # pins). Gain recovering quickly after a burst is the in-block
    # behavior too — a property of max-tracking AGC, not a carry bug.
    return y, jnp.where(enabled, env_last, env_prev), gain[-1]
