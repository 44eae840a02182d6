"""Parallel (associative-scan) formulations of the serial recurrences.

The reference's AGC / squelch / DC removal are one-pole IIR feedback loops
run sample-by-sample in numpy (`y = filter(b, [1, b-1], x)` — reference
sigs/agc.m:6-13, sigs/squelch.m:100-137). Serial loops don't map to an
accelerator; every first-order linear recurrence

    y[n] = a[n] * y[n-1] + b[n]

is instead evaluated with `jax.lax.associative_scan` over the monoid
(a, b) ∘ (a', b') = (a*a', a'*b + b')  — O(log n) depth, fully
vectorized, and bit-equivalent (up to fp reassociation) to the serial loop.
Streaming state is the final y, folded into b[0] of the next block, so
chunked == whole-signal (the pattern proven in reference sigs/iir.py:83-105).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def linrec(a, b, y_prev):
    """Evaluate y[n] = a[n]*y[n-1] + b[n] for a block; y[-1] = y_prev.

    a, b: float32 (n,) or (n, k) — k independent columns ride ONE scan
    (the scan is over axis 0; fusing same-form recurrences into columns
    shrinks both compile time and launch count). y_prev: scalar or (k,).
    Returns (y, y_last).
    """
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    b0 = b.at[0].add(a[0] * y_prev)
    _, y = jax.lax.associative_scan(combine, (a, b0))
    return y, y[-1]


def one_pole(x, alpha, y_prev):
    """One-pole lowpass y[n] = alpha*x[n] + (1-alpha)*y[n-1] (reference
    agc.m beta=0.1, squelch.m alpha=0.001). x: (n,) or (n, k) columns;
    alpha: scalar or (k,) per-column. Returns (y, y_last)."""
    alpha = jnp.asarray(alpha, x.dtype)
    a = jnp.broadcast_to(1.0 - alpha, x.shape)
    return linrec(a, alpha * x, y_prev)


def dc_block(x, r, state):
    """DC blocker: y[n] = x[n] - x[n-1] + r*y[n-1] (r ~ 0.9985).

    The reference removes DC for AM/USB audio (receiver.py:250-252).
    state = (x_prev, y_prev). Works on float32 blocks.
    Returns (y, new_state).
    """
    x_prev, y_prev = state
    n = x.shape[0]
    xm1 = jnp.concatenate([jnp.reshape(x_prev, (1,)), x[:-1]])
    b = x - xm1
    a = jnp.full((n,), r, x.dtype)
    y, y_last = linrec(a, b, y_prev)
    return y, (x[-1], y_last)


def sr_latch(set_, reset, g_prev):
    """Set/reset latch over a block — the hysteresis comparator pattern
    (squelch open above T_open, close below T_close, hold in between).

    set_, reset: bool (n,) per-sample commands (set wins over reset when
    both fire); g_prev: float32 () previous gate in {0, 1}.
    Returns (gate float32 (n,), gate_last). Associative: each sample is a
    command in {+1 set, -1 reset, 0 hold}; composition keeps the later
    non-hold command, so lax.associative_scan gives O(log n) depth.
    """
    cmd = jnp.where(set_, jnp.int32(1),
                    jnp.where(reset, jnp.int32(-1), jnp.int32(0)))

    def combine(c1, c2):
        return jnp.where(c2 != 0, c2, c1)

    eff = jax.lax.associative_scan(combine, cmd)
    init = jnp.where(g_prev > 0.5, jnp.int32(1), jnp.int32(-1))
    gate = (jnp.where(eff != 0, eff, init) > 0).astype(jnp.float32)
    return gate, gate[-1]


def one_pole_cas(x, alpha, y_prev, n_stages: int = 1):
    """Cascade of identical one-pole sections (sharper smoothing)."""
    ys = x
    lasts = []
    for i in range(n_stages):
        ys, last = one_pole(ys, alpha, y_prev[i])
        lasts.append(last)
    return ys, jnp.stack(lasts)
