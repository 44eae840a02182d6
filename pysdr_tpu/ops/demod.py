"""Demodulator bank: AM, AM-synch, USB/LSB, CW, NFM, WFM, WFM stereo, IQ.

Reference behavior: `rx.demod_data(x)` dispatches on mode and runs envelope /
PLL / one-sided-filter / discriminator demodulation followed by AF filtering
and AGC (reference receiver.py:231-297; mode list Tables.py:34; NFM math
sigs/nfm.m:124-127; AGC sigs/agc.m).

Design decisions (deliberately NOT a translation):

* Every mode's frontend is branch-free and parallel-in-time. There is no
  per-sample loop anywhere: the AM-synch PLL becomes narrowband carrier
  recovery (a ~±100 Hz one-sided filter extracts the carrier; the signal is
  mixed with its conjugate unit vector) — equivalent to a locked PLL for any
  SNR where the PLL would lock, and exactly parallel. One-pole recurrences
  (DC block, de-emphasis, AGC envelope) are associative scans (scanops.py).

* All mode frontends are computed unconditionally and blended with
  `jnp.where` on a *traced* mode id. A mode change is therefore pure data —
  no recompile, and an N-channel bank with mixed modes is a single vmap.
  The extra arithmetic is negligible: frontends are elementwise; the heavy
  ops (AF FIR, carrier/pilot FIRs) run once each regardless.

* Audio is complex64: real = left/mono, imag = right (the reference packs
  two RXs into stereo L/R the same way, receiver.py:158-189); IQ mode
  passes baseband through unchanged.

Demod runs at the audio rate fs_out (post-decimation), so per-block cost is
tiny next to the RF-rate front half; fs_out = 192 kHz for WFM like the
reference (params.py:400-404).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu import tables
from pysdr_tpu.ops import agc as agc_ops
from pysdr_tpu.ops import cplx, fir, nco, resample, scanops
from pysdr_tpu.tables import Mode


class DemodState(NamedTuple):
    """Uniform per-channel streaming state (same pytree for every mode so
    the bank vmaps/shards cleanly)."""
    af_hist: jax.Array      # complex64 (Ta-1,) AF filter history
    carrier_hist: jax.Array # complex64 (Tc-1,) AM-synch carrier filter
    pilot_hist: jax.Array   # complex64 (Tp-1,) WFM stereo pilot filter
    lr_hist: jax.Array      # complex64 (Ta-1,) WFM stereo L-R filter
    disc_last: jax.Array    # complex64 (1,) FM discriminator boundary
    bfo_phase: jax.Array    # int32 () CW BFO NCO phase
    deemph: jax.Array       # float32 (2,) L/R de-emphasis one-pole state
    dc: jax.Array           # float32 (2,) DC blocker (x_prev, y_prev)
    agc_env: jax.Array      # float32 () AGC envelope
    sq_gate: jax.Array      # float32 () squelch latch (0 closed / 1 open)
    sq_env: jax.Array       # float32 (3,) [in-band env, out-of-band env,
                            #               smoothed gate] (squelch.m:134)
    mute_hold: jax.Array    # float32 () auto-mute hold (samples remaining,
                            # reference MUTE_TIME=0.25 s, params.py:447-450)


class DemodParams(NamedTuple):
    """Per-channel traced parameters (leading axis = channel when vmapped)."""
    mode: jax.Array         # int32 () tables.Mode value
    af_taps: jax.Array      # float32 (Ta, 2) packed complex AF filter row
                            # (packed re/im at jit boundaries — see
                            # ops/cplx.py)
    bfo_k: jax.Array        # int32 () CW beat NCO numerator @ fs_out
    fm_scale: jax.Array     # float32 () discriminator output scaling
    squelch_lin: jax.Array  # float32 () linear SNR threshold (0 = off)
    af_gain: jax.Array      # float32 ()
    agc_on: jax.Array       # bool ()
    mute_gain: jax.Array    # float32 () 0.0 = per-RX MUTED, else 1.0
    auto_mute_on: jax.Array # bool () strong-signal auto-mute armed
    auto_mute_lin: jax.Array# float32 () linear baseband power threshold


@dataclasses.dataclass(frozen=True)
class DemodDesign:
    """Static (compile-time) demod configuration shared by all channels."""
    fs_out: float
    af_taps: int = 256
    carrier_taps: int = 256     # AM-synch carrier recovery filter
    carrier_bw_hz: float = 100.0
    pilot_taps: int = 256
    agc: agc_ops.AGCParams = agc_ops.AGCParams()
    deemphasis_s: float = tables.WFM_DEEMPHASIS_S
    dc_pole: float = 0.9985
    squelch_alpha: float = 0.001    # envelope one-pole (squelch.m:134)
    squelch_hyst: float = 0.5       # close threshold = hyst * open (6 dB)
    mute_hold_s: float = 0.25       # reference MUTE_TIME (params.py:447)
    # Overlap-save FFT path for the four audio-rate filters
    # (ops/fftfilt.py), the default: with per-channel TRACED taps the
    # direct form is a batched convolution with one kernel per channel,
    # while in the frequency domain per-channel taps are just an
    # elementwise multiply, which vmaps cleanly. fft_af=False keeps the
    # direct conv (equivalence pinned by test_fftfilt.py).
    fft_af: bool = True

    def carrier_filter(self) -> np.ndarray:
        """Narrow one-sided LP around DC for carrier recovery."""
        return fir.complex_bandpass(-self.carrier_bw_hz, self.carrier_bw_hz,
                                    self.fs_out, self.carrier_taps)

    def pilot_filter(self) -> np.ndarray:
        """One-sided bandpass at +19 kHz (WFM stereo pilot). Only
        meaningful when fs_out >= ~48k; at lower rates it aliases but WFM
        is configured at 192k like the reference."""
        f0 = tables.WFM_PILOT_HZ
        if self.fs_out / 2 <= f0 + 1e3:
            h = np.zeros(self.pilot_taps, np.complex64)  # disabled
            return h
        return fir.complex_bandpass(f0 - 500.0, f0 + 500.0, self.fs_out,
                                    self.pilot_taps)

    def deemph_alpha(self) -> float:
        return float(1.0 - np.exp(-1.0 / (self.fs_out * self.deemphasis_s)))


def init_state(design: DemodDesign) -> DemodState:
    # Host numpy (not eager jnp): as a constant inside traced code numpy
    # behaves identically, and at construction time the caller packs the
    # complex leaves (ops/cplx.py) before any device_put.
    c64 = np.complex64
    return DemodState(
        af_hist=np.zeros(design.af_taps - 1, c64),
        carrier_hist=np.zeros(design.carrier_taps - 1, c64),
        pilot_hist=np.zeros(design.pilot_taps - 1, c64),
        lr_hist=np.zeros(design.af_taps - 1, c64),
        disc_last=np.zeros(1, c64),
        bfo_phase=np.zeros((), np.int32),
        deemph=np.zeros(2, np.float32),
        dc=np.zeros(2, np.float32),
        agc_env=agc_ops.init_state(),
        sq_gate=np.ones((), np.float32),
        sq_env=np.array([0.0, 0.0, 1.0], np.float32),
        mute_hold=np.zeros((), np.float32),
    )


def _af_fir(x, hist, taps_c, design: DemodDesign):
    """Audio-rate complex-taps FIR: direct conv or overlap-save FFT
    (ops/fftfilt.py), selected statically by design.fft_af."""
    with jax.named_scope("af_filter"):
        if design.fft_af:
            from pysdr_tpu.ops import fftfilt
            return fftfilt.fft_fir_block(x, hist, taps_c)
        return resample.fir_block_cmpx(x, hist, taps_c)


def _discriminate(iq, last1):
    """Phase-difference FM detector: fm[n] = angle(x[n] * conj(x[n-1])) in
    rad/sample. The reference's delay-conjugate detector
    (sigs/nfm.m:124-127) is the small-angle approximation of this (its
    sin(w) response distorts badly at WFM deviations); atan2 is exact at
    any deviation, amplitude-invariant, and pure elementwise work.
    Returns (fm (n,) float32, new_last1 (1,))."""
    ext = jnp.concatenate([last1, iq])          # (n+1,)
    prod = ext[1:] * jnp.conj(ext[:-1])
    fm = jnp.arctan2(prod.imag, prod.real)
    return fm, ext[-1:]


def demod_block(iq, state: DemodState, p: DemodParams, design: DemodDesign,
                carrier_taps, pilot_taps):
    """Demodulate one audio-rate block.

    iq: complex64 (n,) baseband at fs_out. carrier_taps/pilot_taps are the
    shared complex64 filter arrays from DemodDesign (passed in so they live
    once, not per channel). Returns (audio complex64 (n,), new_state).
    """
    n = iq.shape[0]
    mode = p.mode
    af_taps = cplx.unpack(p.af_taps) if not jnp.iscomplexobj(p.af_taps) \
        else p.af_taps
    if not jnp.iscomplexobj(carrier_taps):
        carrier_taps = cplx.unpack(carrier_taps)
    if not jnp.iscomplexobj(pilot_taps):
        pilot_taps = cplx.unpack(pilot_taps)

    # --- frontends (all computed; elementwise + 2 small FIRs) ---
    env = jnp.abs(iq)                                        # AM
    carrier, carrier_hist = _af_fir(
        iq, state.carrier_hist, carrier_taps, design)        # AM-synch
    unit = carrier / (jnp.abs(carrier) + 1e-9)
    z_ams = (iq * jnp.conj(unit)).real
    bfo = nco.tone(p.bfo_k, state.bfo_phase, n)              # CW beat
    bfo_phase = nco.advance(p.bfo_k, state.bfo_phase, n)
    z_cw = iq * bfo
    fm, disc_last = _discriminate(iq, state.disc_last)       # NFM/WFM
    z_fm = fm * p.fm_scale

    # WFM stereo: pilot-locked 38 kHz subcarrier demod.
    pilot, pilot_hist = _af_fir(
        fm.astype(jnp.complex64), state.pilot_hist, pilot_taps, design)
    punit = pilot / (jnp.abs(pilot) + 1e-9)
    # Broadcast convention (FCC 73.322 / BS.450): the 38 kHz subcarrier
    # zero-crosses in phase with the pilot — for pilot sin(phi) the
    # subcarrier is sin(2*phi). The analytic pilot from the one-sided
    # filter is e^{j(phi - pi/2)}, so sin(2*phi) = -Im(punit^2).
    # (Re(punit^2) is the quadrature term: it decodes ~zero stereo from
    # a standards-compliant MPX — caught round 4.)
    c38 = -(punit * punit).imag                              # sin(2*pilot_ph)
    lr_raw = (2.0 * fm * c38 * p.fm_scale).astype(jnp.complex64)
    lr_f, lr_hist = _af_fir(lr_raw, state.lr_hist, af_taps, design)
    lr = lr_f.real

    is_fm_wide = (mode == Mode.WFM) | (mode == Mode.WFM2)
    is_ssb = (mode == Mode.USB) | (mode == Mode.LSB)
    is_iq = (mode == Mode.IQ) | (mode == Mode.RTTY)

    z = jnp.where(mode == Mode.AM, env.astype(jnp.complex64),
        jnp.where(mode == Mode.AM_SYNC, z_ams.astype(jnp.complex64),
        jnp.where(is_ssb | is_iq, iq,
        jnp.where(mode == Mode.CW, z_cw,
                  z_fm.astype(jnp.complex64)))))             # NFM/WFM/WFM2

    # --- shared AF filter (complex taps row selects USB/LSB/lowpass) ---
    y, af_hist = _af_fir(z, state.af_hist, af_taps, design)
    y = jnp.where(is_iq, z, y)   # IQ passthrough keeps raw baseband
    mono = y.real

    # --- fused recurrences, pass 1 (ONE 4-column associative scan):
    # de-emphasis L/R one-poles + the two squelch power envelopes
    # (reference sigs/squelch.m:100-137: in-band vs out-of-band POWER,
    # alpha=0.001; in-band = post-AF-filter audio, out-of-band = total
    # minus in-band — power envelopes are slow next to the AF filter's
    # group delay, so no sample alignment is needed).
    alpha_de = jnp.float32(design.deemph_alpha())
    alpha_sq = jnp.float32(design.squelch_alpha)
    left_in = jnp.where(mode == Mode.WFM2, mono + lr, mono)
    right_in = jnp.where(mode == Mode.WFM2, mono - lr, mono)
    colsA = jnp.stack([left_in, right_in,
                       jnp.abs(y).astype(jnp.float32) ** 2,
                       jnp.abs(z).astype(jnp.float32) ** 2], axis=1)
    prevA = jnp.stack([state.deemph[0], state.deemph[1],
                       state.sq_env[0], state.sq_env[1]])
    alphasA = jnp.stack([alpha_de, alpha_de, alpha_sq, alpha_sq])
    scanA, lastA = scanops.one_pole(colsA, alphasA, prevA)
    use_de = is_fm_wide
    left = jnp.where(use_de, scanA[:, 0], left_in)
    right = jnp.where(use_de, scanA[:, 1], right_in)
    deemph = jnp.where(use_de, lastA[:2], state.deemph)
    env_in, env_tot = scanA[:, 2], scanA[:, 3]
    env_in_last, env_out_last = lastA[2], lastA[3]

    # --- squelch hysteresis gate: open above T, close below hyst*T ---
    ratio = env_in / jnp.maximum(env_tot - env_in, 1e-9)
    open_ = ratio > p.squelch_lin
    close = ratio < design.squelch_hyst * p.squelch_lin
    gate, gate_last = scanops.sr_latch(open_, close, state.sq_gate)
    sq_off = p.squelch_lin <= 0.0
    gate = jnp.where(sq_off, 1.0, gate)
    gate_last = jnp.where(sq_off, 1.0, gate_last)

    # --- fused recurrences, pass 2 (ONE 2-column scan): ~1 ms click
    # smoothing of the gate + the DC blocker
    # y[n] = x[n]-x[n-1] + r*y[n-1] for AM/USB-family audio
    # (reference receiver.py:250-252)
    alpha_click = jnp.float32(min(1.0, 1000.0 / design.fs_out))
    r_dc = jnp.float32(design.dc_pole)
    lm1 = jnp.concatenate([state.dc[0][None], left[:-1]])
    colsB_a = jnp.stack([jnp.full(n, 1.0 - alpha_click, jnp.float32),
                         jnp.full(n, r_dc, jnp.float32)], axis=1)
    colsB_b = jnp.stack([alpha_click * gate, left - lm1], axis=1)
    prevB = jnp.stack([state.sq_env[2], state.dc[1]])
    scanB, lastB = scanops.linrec(colsB_a, colsB_b, prevB)
    g_sm, l_dc = scanB[:, 0], scanB[:, 1]
    dc_on = (mode == Mode.AM) | (mode == Mode.AM_SYNC) | is_ssb | \
            (mode == Mode.CW)
    dc = jnp.where(dc_on, jnp.stack([left[-1], lastB[1]]), state.dc)
    left = jnp.where(dc_on, l_dc, left)

    audio = jax.lax.complex(left, jnp.where(mode == Mode.WFM2, right,
                                            jnp.where(is_iq, y.imag, 0.0)))
    audio = audio * g_sm
    sq_env = jnp.stack([env_in_last, env_out_last, lastB[0]])

    # --- AGC + gain ---
    audio, agc_env, _ = agc_ops.agc_block(audio, state.agc_env, design.agc,
                                          enabled=p.agc_on & ~is_iq)
    audio = audio * p.af_gain

    # --- per-RX mute + strong-signal auto-mute (reference P.MUTED
    # receiver.py:168-197; rx.auto_mute receiver.py:237-245 with a 0.25 s
    # hold, params.py:447-450). Baseband power over the block trips the
    # hold counter; the hold decays by one block of samples per step.
    bb_pwr = jnp.mean(jnp.abs(iq) ** 2)
    strong = p.auto_mute_on & (bb_pwr > p.auto_mute_lin)
    hold = jnp.where(strong, jnp.float32(design.mute_hold_s * design.fs_out),
                     jnp.maximum(state.mute_hold - n, 0.0))
    auto_muted = p.auto_mute_on & (strong | (state.mute_hold > 0.0))
    audio = audio * p.mute_gain * jnp.where(auto_muted, 0.0, 1.0)

    new_state = DemodState(
        af_hist=af_hist, carrier_hist=carrier_hist, pilot_hist=pilot_hist,
        lr_hist=lr_hist, disc_last=disc_last, bfo_phase=bfo_phase,
        deemph=deemph, dc=dc, agc_env=agc_env, sq_gate=gate_last,
        sq_env=sq_env, mute_hold=hold)
    return audio, new_state


def make_params(design: DemodDesign, mode: Mode, af_bw_hz: float = 0.0,
                bfo_hz: float = tables.CW_BFO_HZ, af_gain: float = 1.0,
                squelch_db: float = -150.0, agc_on: bool = True,
                deviation_hz: float | None = None, muted: bool = False,
                auto_mute: bool = False,
                auto_mute_db: float = -10.0) -> DemodParams:
    """Host-side construction of one channel's DemodParams."""
    fs = design.fs_out
    if af_bw_hz <= 0:
        af_bw_hz = tables.MODE_DEFAULT_AF_BW.get(mode, 0.0) or 0.45 * fs
    af_bw_hz = min(af_bw_hz, 0.45 * fs)
    if mode == Mode.CW:
        taps = fir.complex_bandpass(bfo_hz - af_bw_hz / 2,
                                    bfo_hz + af_bw_hz / 2, fs,
                                    design.af_taps)
    elif mode == Mode.USB:
        taps = fir.complex_bandpass(50.0, af_bw_hz, fs, design.af_taps)
    elif mode == Mode.LSB:
        taps = fir.complex_bandpass(-af_bw_hz, -50.0, fs, design.af_taps)
    else:
        taps = fir.lowpass(design.af_taps, af_bw_hz, fs).astype(np.complex64)
    if deviation_hz is None:
        deviation_hz = (tables.WFM_DEVIATION_HZ
                        if mode in (Mode.WFM, Mode.WFM2)
                        else tables.NFM_DEVIATION_HZ)
    fm_scale = fs / (2.0 * np.pi * deviation_hz)
    # squelch threshold is an in-band/out-of-band power-envelope ratio
    # (sigs/squelch.m), so dB converts at 10 dB/decade
    squelch_lin = 0.0 if squelch_db <= -149 else 10 ** (squelch_db / 10)
    return DemodParams(
        mode=jnp.int32(int(mode)),
        af_taps=jnp.asarray(cplx.pack(np.asarray(taps, np.complex64))),
        bfo_k=jnp.int32(nco.snap_freq(bfo_hz, fs)),
        fm_scale=jnp.float32(fm_scale),
        squelch_lin=jnp.float32(squelch_lin),
        af_gain=jnp.float32(af_gain),
        agc_on=jnp.asarray(agc_on),
        mute_gain=jnp.float32(0.0 if muted else 1.0),
        auto_mute_on=jnp.asarray(bool(auto_mute)),
        auto_mute_lin=jnp.float32(10 ** (auto_mute_db / 10)),
    )
