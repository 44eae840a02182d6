"""Golden-chain parity oracle: ReceiverBank audio vs an INDEPENDENT
NumPy/SciPy implementation of the whole receive chain.

This is SURVEY §4's "replay-file equivalence vs a NumPy/SciPy golden chain
within an SNR bound" — the formalization of the reference's Octave oracle
discipline (reference sigs/internals.m:14-60, receiver.py:864-874): an
implementation of mix -> rational resample -> demod -> AGC that shares NO
code with pysdr_tpu.ops (scipy.signal.resample_poly with its own default
anti-alias design, scipy.signal.firwin AF filters, a serial one-pole AGC
per sigs/agc.m:6-13), compared on the same synthetic capture.

Covers BASELINE.md measurement-plan configs 1-3:
  1. AM demod of a recorded capture;
  2. NFM demod (squelch open);
  3. USB with narrow FIR + AGC.

Constant gain/level differences between the chains (different AGC envelope
conventions, filter scaling) are legitimate, so the metric fits an optimal
scalar + integer lag before computing SNR; waveform-shape errors cannot
hide in that fit.
"""

import numpy as np
import pytest
import scipy.signal as sig

from golden import (FC0, FS_IN, FS_OUT, GOLDEN_CASES, N_BLOCKS, OFFSET_HZ,
                    OUT_BLOCK, _bank_chain, _best_fit_snr_db, _capture,
                    _golden_chain, _out_block)
from pysdr_tpu import config as cfg_mod
from pysdr_tpu.models.receiver import ReceiverBank
from pysdr_tpu.ops import nco
from pysdr_tpu.tables import (MODE_DEFAULT_AF_BW, NFM_DEVIATION_HZ,
                              WFM_DEEMPHASIS_S, WFM_DEVIATION_HZ, Mode)


@pytest.mark.parametrize("mode,agc,bound_db", GOLDEN_CASES)
def test_golden_chain_parity(mode, agc, bound_db, rng):
    x = _capture(mode, rng)
    audio, up, down = _bank_chain(x, mode, agc)
    gold = _golden_chain(x, mode, up, down, agc)
    snr = _best_fit_snr_db(gold, audio)
    assert snr >= bound_db, (
        f"{mode}: bank audio only {snr:.1f} dB SNR vs independent "
        f"scipy golden chain (bound {bound_db} dB)")


def test_golden_wfm2_stereo(rng):
    """WFM2 stereo vs an INDEPENDENT pilot-locked decode: the golden
    chain recovers the 19 kHz pilot with zero-phase filtering
    (filtfilt + analytic signal — not the framework's one-sided FIR
    squaring), regenerates the 38 kHz subcarrier, and separates L/R.
    Mono and stereo-difference paths are fitted separately (their filter
    scalings legitimately differ)."""
    fs_out = 192e3
    n = 32768 * N_BLOCKS
    t = np.arange(n) / FS_IN
    fl, fr = 400.0, 1000.0
    L = 0.8 * np.sin(2 * np.pi * fl * t)
    R = 0.8 * np.sin(2 * np.pi * fr * t)
    th = 2 * np.pi * 19e3 * t
    # STANDARD broadcast convention: pilot sin, subcarrier sin(2*th)
    mpx = 0.45 * (L + R) + 0.1 * np.sin(th) \
        + 0.45 * (L - R) * np.sin(2 * th)
    phase = 2 * np.pi * WFM_DEVIATION_HZ * np.cumsum(mpx) / FS_IN
    x = (0.5 * np.exp(1j * phase)
         * np.exp(2j * np.pi * OFFSET_HZ * t)).astype(np.complex64)
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x.astype(np.complex64)

    # bank: WFM2 audio is complex L + jR
    cfg = cfg_mod.PipelineConfig(
        fs_in=FS_IN, fs_out=fs_out, out_block=_out_block(Mode.WFM2),
        foffset_hz=OFFSET_HZ,
        receivers=(cfg_mod.ReceiverConfig(fc_hz=FC0, mode=Mode.WFM2,
                                          agc_enabled=False),))
    bank = ReceiverBank(cfg)
    d = bank.design
    outs = [bank.step(x[b * d.in_block:(b + 1) * d.in_block])[0]
            for b in range(N_BLOCKS)]
    a = np.concatenate(outs)
    bank_mono = (a.real + a.imag).astype(np.float64) / 2
    bank_lr = (a.real - a.imag).astype(np.float64) / 2

    # golden: mix/resample, discriminate, zero-phase pilot lock
    k = nco.snap_freq(OFFSET_HZ, FS_IN)
    ang = 2 * np.pi * ((np.arange(n, dtype=np.int64) * k) % nco.DENOM) \
        / nco.DENOM
    bb = sig.resample_poly(x * np.exp(-1j * ang), d.up, d.down)
    dd = bb[1:] * np.conj(bb[:-1])
    mh = np.concatenate([[0.0], np.arctan2(dd.imag, dd.real)]) \
        * fs_out / (2 * np.pi * WFM_DEVIATION_HZ)
    hp = sig.firwin(511, [18e3, 20e3], fs=fs_out, pass_zero=False)
    pil = sig.hilbert(sig.filtfilt(hp, [1.0], mh))
    # analytic(sin(phi)) = e^{j(phi-pi/2)} -> sin(2*phi) = -sin(2*angle)
    c38 = -np.sin(2 * np.angle(pil))
    af_bw = MODE_DEFAULT_AF_BW[Mode.WFM2]
    h = sig.firwin(255, af_bw, fs=fs_out)
    al = 1.0 - np.exp(-1.0 / (fs_out * WFM_DEEMPHASIS_S))

    def deemph(v):
        return sig.lfilter([al], [1.0, al - 1.0], v)
    gold_mono = deemph(sig.lfilter(h, [1.0], mh))
    gold_lr = deemph(sig.lfilter(h, [1.0], 2 * mh * c38) / 2)

    snr_mono = _best_fit_snr_db(gold_mono, bank_mono)
    snr_lr = _best_fit_snr_db(gold_lr, bank_lr)
    # r5 measured margins: mono ~59 dB, L-R ~37 dB (the old 20/15 dB
    # floors predated the r4 subcarrier-phase fix and were never
    # retightened)
    assert snr_mono >= 40.0, snr_mono
    assert snr_lr >= 28.0, snr_lr
    # and the bank's separation is real: each tone owns its channel
    half = len(a) // 2

    def tone_p(xv, f):
        w = np.hanning(len(xv))
        sp = np.abs(np.fft.rfft(xv * w))
        fr_ = np.fft.rfftfreq(len(xv), 1 / fs_out)
        return sp[np.argmin(np.abs(fr_ - f))]
    lch, rch = a.real[half:], a.imag[half:]
    assert tone_p(lch, fl) > 5 * tone_p(rch, fl)
    assert tone_p(rch, fr) > 5 * tone_p(lch, fr)


def test_golden_squelch_drop(rng):
    """Squelch on a signal that DROPS mid-capture vs an independent
    serial energy-ratio gate (sigs/squelch.m:100-137: one-pole in-band /
    out-of-band power envelopes, alpha=0.001, hysteresis): both chains
    must demodulate the open half alike, close within 100 ms of each
    other, and mute the tail."""
    squelch_db = 6.0
    n = 32768 * N_BLOCKS
    t = np.arange(n) / FS_IN
    audio = 0.6 * np.sin(2 * np.pi * 400.0 * t)
    ph = np.cumsum(audio) / FS_IN * 2 * np.pi * NFM_DEVIATION_HZ / 0.6
    x = 0.5 * np.exp(1j * ph) * np.exp(2j * np.pi * OFFSET_HZ * t)
    x[n // 2:] = 0.0                               # carrier drops
    x += 3e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = x.astype(np.complex64)

    cfg = cfg_mod.PipelineConfig(
        fs_in=FS_IN, fs_out=FS_OUT, out_block=OUT_BLOCK,
        foffset_hz=OFFSET_HZ,
        receivers=(cfg_mod.ReceiverConfig(fc_hz=FC0, mode=Mode.NFM,
                                          agc_enabled=False,
                                          squelch_db=squelch_db),))
    bank = ReceiverBank(cfg)
    d = bank.design
    outs = [bank.step(x[b * d.in_block:(b + 1) * d.in_block])[0]
            for b in range(N_BLOCKS)]
    bank_audio = np.concatenate(outs).real.astype(np.float64)

    # golden: NFM demod + serial energy-ratio squelch
    k = nco.snap_freq(OFFSET_HZ, FS_IN)
    ang = 2 * np.pi * ((np.arange(n, dtype=np.int64) * k) % nco.DENOM) \
        / nco.DENOM
    bb = sig.resample_poly(x * np.exp(-1j * ang), d.up, d.down)
    dd = bb[1:] * np.conj(bb[:-1])
    fm = np.concatenate([[0.0], np.arctan2(dd.imag, dd.real)]) \
        * FS_OUT / (2 * np.pi * NFM_DEVIATION_HZ)
    h = sig.firwin(255, MODE_DEFAULT_AF_BW[Mode.NFM], fs=FS_OUT)
    inband = sig.lfilter(h, [1.0], fm)
    alpha = 1e-3
    env_in = sig.lfilter([alpha], [1.0, alpha - 1.0], inband ** 2)
    env_tot = sig.lfilter([alpha], [1.0, alpha - 1.0], fm ** 2)
    thr = 10.0 ** (squelch_db / 10.0)
    ratio = env_in / np.maximum(env_tot - env_in, 1e-9)
    gate = np.empty(len(ratio))
    g = 1.0
    for i, r in enumerate(ratio):          # serial hysteresis latch
        if r > thr:
            g = 1.0
        elif r < 0.5 * thr:
            g = 0.0
        gate[i] = g
    gold_audio = inband * gate

    n_out = min(len(bank_audio), len(gold_audio))
    # open half matches within SNR bound (skip the settle)
    lo, hi = n_out // 8, int(n_out * 0.45)
    snr = _best_fit_snr_db(gold_audio[:2 * hi], bank_audio[:2 * hi])
    assert snr >= 20.0, snr
    # both gates closed on the tail
    tail_b = bank_audio[int(n_out * 0.75):n_out]
    tail_g = gold_audio[int(n_out * 0.75):n_out]
    open_b = bank_audio[lo:hi]
    assert np.std(tail_b) < 0.05 * np.std(open_b), \
        (np.std(tail_b), np.std(open_b))
    assert np.std(tail_g) < 0.05 * np.std(gold_audio[lo:hi])
    # close instants agree within 100 ms
    def close_idx(v):
        on = np.abs(v) > 0.1 * np.std(open_b)
        idx = np.where(on)[0]
        return idx[-1] if len(idx) else 0
    assert abs(close_idx(bank_audio[:n_out])
               - close_idx(gold_audio[:n_out])) < 0.1 * FS_OUT
