"""AGC behavior vs a serial simulation of the reference loop.

The reference AGC (external sig_proc; loop filter documented in
sigs/agc.m:6-13, state dumped at watchdog.py:296-302) is an asymmetric
envelope follower with a one-pole smoother (beta=0.1) driving
gain = ref/envelope. These tests pin the scan formulation's attack/decay
behavior against a per-sample serial loop and check the streaming
state-carry invariant.
"""

import numpy as np
import jax.numpy as jnp

from pysdr_tpu.ops import agc as agc_ops


def serial_envelope(mag, attack, decay, env0=0.0):
    """Per-sample asymmetric one-pole envelope follower — the serial form
    the window-max + scan formulation approximates. alpha = attack when the input
    exceeds the envelope (rising), decay when below (falling)."""
    env = np.empty_like(mag)
    e = env0
    for i, m in enumerate(mag):
        a = attack if m > e else decay
        e = a * m + (1 - a) * e
        env[i] = e
    return env


def run_agc(x, p, n_blocks=1):
    env = agc_ops.init_state()
    outs = []
    for b in np.split(x, n_blocks):
        y, env, gain = agc_ops.agc_block(jnp.asarray(b), env, p)
        outs.append(np.asarray(y))
    return np.concatenate(outs), float(env)


def test_attack_is_fast():
    """A 40 dB step up must be levelled within ~2 attack windows (the
    reference's max-tracking loop also clamps big signals immediately)."""
    p = agc_ops.AGCParams()
    n = 24000
    x = np.full(n, 0.005, np.float32)
    x[8000:] = 0.5
    y, _ = run_agc(x, p)
    w = 64
    post = y[8000 + 2 * w:12000]
    # output pinned at ref level right after the step
    assert np.all(post < 1.5 * p.ref)
    assert np.mean(post) > 0.5 * p.ref


def test_decay_time_constant_matches_serial_loop():
    """After a step DOWN, the envelope must decay like the serial
    asymmetric one-pole with the same decay alpha (sigs/agc.m loop filter
    applied to a falling input)."""
    p = agc_ops.AGCParams()
    n = 48000
    step = 16000
    x = np.full(n, 0.5, np.float32)
    x[step:] = 0.005
    y, _ = run_agc(x, p)
    mag = np.abs(x)
    env_ref = serial_envelope(mag, attack=1.0, decay=p.decay, env0=0.0)
    gain_ref = np.minimum(p.ref / np.maximum(env_ref, p.floor), p.max_gain)
    y_ref = x * gain_ref
    # compare output trajectories during the decay transient (skip the
    # window-quantization edge right at the step). +-2 dB: the windowed
    # form's only legitimate deviation from the serial loop is the
    # 64-sample hold quantization, (1-decay)^64 ~ 6% (VERDICT r2 #8 —
    # the old +-6 dB bound could hide a mis-set time constant).
    lo, hi = 10 ** (-2 / 20), 10 ** (2 / 20)
    for t in (2000, 8000, 24000):
        seg = slice(step + t, step + t + 1000)
        r = np.mean(y[seg]) / np.mean(y_ref[seg])
        assert lo < r < hi, (t, r)


def test_steady_state_hits_ref_level():
    p = agc_ops.AGCParams()
    rng = np.random.default_rng(7)
    x = (0.02 * rng.standard_normal(48000)).astype(np.float32)
    y, _ = run_agc(x, p)
    peak = np.percentile(np.abs(y[24000:]), 99.9)
    assert 0.5 * p.ref < peak < 2.0 * p.ref


def test_streaming_equals_batch():
    p = agc_ops.AGCParams()
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal(16384)).astype(np.float32)
    x[4000:8000] *= 10
    y1, e1 = run_agc(x, p, n_blocks=1)
    # block size is a multiple of the attack window (64) so the windowed
    # max sees identical segment boundaries
    y4, e4 = run_agc(x, p, n_blocks=4)
    np.testing.assert_allclose(y4, y1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(e4, e1, rtol=1e-4)


def test_disabled_is_identity():
    p = agc_ops.AGCParams()
    x = (0.01 * np.ones(4096)).astype(np.float32)
    y, env, gain = agc_ops.agc_block(jnp.asarray(x), agc_ops.init_state(),
                                     p, enabled=False)
    np.testing.assert_allclose(np.asarray(y), x)
    assert float(gain) == 1.0
