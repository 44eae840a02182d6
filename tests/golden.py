"""Independent NumPy/SciPy golden receive chain and the SNR metric that
compares the bank against it.

An implementation of mix -> rational resample -> demod -> AGC that shares
NO code with pysdr_tpu.ops (scipy.signal.resample_poly with its own
default anti-alias design, scipy.signal.firwin AF filters, a serial
one-pole AGC per sigs/agc.m:6-13). Used by tests/test_golden_parity.py on
the CPU and by chip_smoke.py on the GPU, with the same bounds.
"""

import numpy as np
import scipy.signal as sig

from pysdr_tpu import config as cfg_mod
from pysdr_tpu.models.receiver import ReceiverBank
from pysdr_tpu.ops import nco
from pysdr_tpu.tables import (CW_BFO_HZ, MODE_DEFAULT_AF_BW,
                              NFM_DEVIATION_HZ, WFM_DEEMPHASIS_S,
                              WFM_DEVIATION_HZ, Mode)

FS_IN = 512e3
FS_OUT = 48e3
OUT_BLOCK = 3072          # -> in_block = 32768 (up/down = 3/32)
N_BLOCKS = 8


def _fs_out(mode: Mode) -> float:
    # WFM/WFM2 run at the reference's 192 kHz audio rate (params.py:400-404)
    return 192e3 if mode in (Mode.WFM, Mode.WFM2) else FS_OUT


def _out_block(mode: Mode) -> int:
    return 12288 if mode in (Mode.WFM, Mode.WFM2) else OUT_BLOCK
OFFSET_HZ = 60e3          # station offset inside the passband
FC0 = 100e6


def _capture(mode: Mode, rng) -> np.ndarray:
    """Synthetic RF capture with one station at OFFSET_HZ + light noise."""
    plan_in = 32768 * N_BLOCKS
    t = np.arange(plan_in) / FS_IN
    audio = 0.6 * np.sin(2 * np.pi * 400.0 * t)
    if mode == Mode.AM:
        base = 0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 400.0 * t))
        x = base.astype(np.complex64)
    elif mode == Mode.AM_SYNC:
        # carrier 40 Hz OFF the dial (inside the ±100 Hz carrier-recovery
        # band): envelope detection still works on clean AM, but the
        # synchronous detector must actually TRACK the carrier here —
        # which is what the independent PLL golden validates
        base = 0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 400.0 * t))
        x = base * np.exp(2j * np.pi * 40.0 * t)
    elif mode == Mode.NFM:
        phase = np.cumsum(audio) / FS_IN * 2 * np.pi * NFM_DEVIATION_HZ / 0.6
        x = 0.5 * np.exp(1j * phase)
    elif mode == Mode.USB:
        # dominant + weak audio tone as upper-sideband content (a
        # near-constant envelope: the two chains' AGC conventions
        # legitimately differ on deeply-beating envelopes)
        x = (0.4 * np.exp(2j * np.pi * 1200.0 * t)
             + 0.02 * np.exp(2j * np.pi * 2500.0 * t))
    elif mode == Mode.CW:
        x = np.full(plan_in, 0.5, np.complex64)   # keyed-down carrier
    elif mode == Mode.WFM:
        wa = 0.5 * np.sin(2 * np.pi * 400.0 * t) \
            + 0.1 * np.sin(2 * np.pi * 3000.0 * t)
        phase = (np.cumsum(wa) / FS_IN * 2 * np.pi
                 * WFM_DEVIATION_HZ / 0.6)
        x = 0.5 * np.exp(1j * phase)
    else:
        raise ValueError(mode)
    x = x * np.exp(2j * np.pi * OFFSET_HZ * t)
    x = x + 1e-3 * (rng.standard_normal(plan_in)
                    + 1j * rng.standard_normal(plan_in))
    return x.astype(np.complex64)


def _golden_chain(x: np.ndarray, mode: Mode, up: int, down: int,
                  agc: bool) -> np.ndarray:
    fs_out = _fs_out(mode)
    """Fully independent scipy receive chain."""
    n = len(x)
    # 1. mix: same snapped LO frequency, exact integer phase (both chains
    # must target the same station frequency; the snap is part of the
    # framework's contract, nco.py docstring)
    k = nco.snap_freq(OFFSET_HZ, FS_IN)
    ang = 2 * np.pi * ((np.arange(n, dtype=np.int64) * k) % nco.DENOM) \
        / nco.DENOM
    y = x * np.exp(-1j * ang)
    # 2. rational resample with scipy's own kaiser anti-alias design
    bb = sig.resample_poly(y, up, down)
    # 3. demod
    af_bw = MODE_DEFAULT_AF_BW[mode]
    if mode == Mode.AM:
        aud = np.abs(bb)
        aud = aud - aud.mean()                      # DC removal
        h = sig.firwin(255, af_bw, fs=FS_OUT)
        aud = sig.lfilter(h, [1.0], aud)
    elif mode == Mode.AM_SYNC:
        # TRUE serial 2nd-order PLL (the loop the reference's am_pll
        # runs, receiver.py:649) — deliberately NOT the framework's
        # filter-based carrier-recovery reformulation (ops/demod.py
        # z_ams): tracks the 40 Hz carrier error sample by sample.
        theta, fr = 0.0, 0.0
        kp, ki = 0.1, 2e-3
        out = np.empty(len(bb))
        for i_s, s in enumerate(bb):
            zz = s * np.exp(-1j * theta)
            e = np.arctan2(zz.imag, zz.real)
            out[i_s] = zz.real
            fr += ki * e
            theta += fr + kp * e
        aud = out - out.mean()
        h = sig.firwin(255, af_bw, fs=FS_OUT)
        aud = sig.lfilter(h, [1.0], aud)
    elif mode == Mode.NFM:
        d = bb[1:] * np.conj(bb[:-1])
        fm = np.arctan2(d.imag, d.real)
        aud = fm * FS_OUT / (2 * np.pi * NFM_DEVIATION_HZ)
        aud = np.concatenate([[0.0], aud])
        h = sig.firwin(255, af_bw, fs=FS_OUT)
        aud = sig.lfilter(h, [1.0], aud)
    elif mode == Mode.USB:
        # one-sided 50..af_bw Hz filter: lowpass modulated up to center
        half = (af_bw - 50.0) / 2
        ctr = (af_bw + 50.0) / 2
        hlp = sig.firwin(255, half, fs=FS_OUT)
        m = np.arange(255) - 127
        h = hlp * np.exp(2j * np.pi * ctr / FS_OUT * m)
        aud = sig.lfilter(h, [1.0], bb).real
        aud = aud - aud.mean()
    elif mode == Mode.CW:
        # BFO beat (same snapped frequency as the bank's audio-rate NCO)
        kb = nco.snap_freq(CW_BFO_HZ, fs_out)
        ang_b = 2 * np.pi * ((np.arange(len(bb), dtype=np.int64) * kb)
                             % nco.DENOM) / nco.DENOM
        beat = np.real(bb * np.exp(1j * ang_b))
        h = sig.firwin(255, [CW_BFO_HZ - af_bw / 2, CW_BFO_HZ + af_bw / 2],
                       fs=fs_out, pass_zero=False)
        aud = sig.lfilter(h, [1.0], beat)
        aud = aud - aud.mean()
    elif mode == Mode.WFM:
        d = bb[1:] * np.conj(bb[:-1])
        fm = np.arctan2(d.imag, d.real)
        aud = fm * fs_out / (2 * np.pi * WFM_DEVIATION_HZ)
        aud = np.concatenate([[0.0], aud])
        h = sig.firwin(255, af_bw, fs=fs_out)
        aud = sig.lfilter(h, [1.0], aud)
        # 75 us de-emphasis one-pole (tables.WFM_DEEMPHASIS_S)
        al = 1.0 - np.exp(-1.0 / (fs_out * WFM_DEEMPHASIS_S))
        aud = sig.lfilter([al], [1.0, al - 1.0], aud)
    if not agc:
        return aud
    # 4. serial one-pole AGC (sigs/agc.m:6-13: y = filter(b, [1, b-1], x)
    # on the rectified signal; gain applied feed-forward from the
    # envelope). Transient/ripple conventions differ from the framework's
    # windowed-max AGC (validated separately in test_agc.py); here the
    # envelope must merely settle to a constant on steady-state signals.
    beta = 0.01
    env = sig.lfilter([beta], [1.0, beta - 1.0], np.abs(aud))
    gain = 0.5 / np.maximum(env, 1e-6)
    return aud * np.minimum(gain, 1e4)


def _bank_chain(x: np.ndarray, mode: Mode,
                agc: bool) -> tuple[np.ndarray, int, int]:
    cfg = cfg_mod.PipelineConfig(
        fs_in=FS_IN, fs_out=_fs_out(mode), out_block=_out_block(mode),
        foffset_hz=OFFSET_HZ,
        receivers=(cfg_mod.ReceiverConfig(fc_hz=FC0, mode=mode,
                                          agc_enabled=agc),))
    bank = ReceiverBank(cfg)
    d = bank.design
    outs = []
    for b in range(N_BLOCKS):
        blk = x[b * d.in_block:(b + 1) * d.in_block]
        outs.append(bank.step(blk)[0])
    audio = np.concatenate(outs).real.astype(np.float64)
    return audio, d.up, d.down


def _fit_snr(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(b @ b)
    if denom <= 0:
        return -np.inf
    c = float(a @ b) / denom
    resid = a - c * b
    p_err = float(resid @ resid)
    if p_err <= 0:
        return np.inf
    return 10 * np.log10(float(a @ a) / p_err)


def _frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    """Delay x by a fractional number of samples (FFT phase ramp)."""
    n = len(x)
    f = np.fft.rfftfreq(n)
    return np.fft.irfft(np.fft.rfft(x) * np.exp(-2j * np.pi * f * d), n)


def _best_fit_snr_db(ref: np.ndarray, test: np.ndarray,
                     max_lag: int = 256) -> float:
    """SNR of `test` against `ref` after optimal lag (integer search +
    fractional refinement — the two chains' resamplers have different,
    non-integer group delays) + scalar fit, on the steady-state second
    half."""
    n = min(len(ref), len(test))
    lo, hi = n // 2, n - max_lag - 1
    a = ref[lo:hi]
    best, best_lag = -np.inf, 0
    for lag in range(-max_lag, max_lag + 1):
        snr = _fit_snr(a, test[lo + lag:hi + lag])
        if snr > best:
            best, best_lag = snr, lag
    b0 = test[lo + best_lag - 4:hi + best_lag + 4]
    for frac in np.linspace(-1.0, 1.0, 41):
        b = _frac_delay(b0, frac)[4:-4]
        best = max(best, _fit_snr(a, b))
    return best


# (mode, agc, SNR bound in dB) per golden case: the CPU suite and the GPU
# smoke run hold the bank to the same bounds
GOLDEN_CASES = [
    (Mode.AM, False, 30.0),    # BASELINE config 1
    # carrier-recovery vs true serial PLL: measured ~45 dB across seeds
    # (r5 sweep; the old 20 dB floor predated the r4 WFM/phase fixes)
    (Mode.AM_SYNC, False, 35.0),
    (Mode.NFM, False, 25.0),   # BASELINE config 2
    (Mode.USB, False, 25.0),   # config 3 filter-chain waveform parity
    (Mode.USB, True, 30.0),    # BASELINE config 3 (measured ~37.6 dB)
    (Mode.CW, False, 25.0),    # BFO beat + narrow filter
    (Mode.WFM, False, 25.0),   # 192 kHz discriminator + de-emphasis
]
