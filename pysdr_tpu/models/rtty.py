"""Wideband parallel RTTY decoder: FFT filterbank + batched matched filter.

Reference behavior (reference rtty.py): up to 100 parallel 45.45-baud FSK
decoders over one FFT filterbank — `RTTY_Params` T=22 ms, shift=170 Hz,
4 samples/bit, NFFT=2^ceil(log2(N)) (rtty.py:376-404); `RTTY_Executive`
pulls IQ, applies a Kaiser(8.6) window and 4 overlapped FFTs per symbol
(rtty.py:834-845); per-channel decoders matched-filter ±1-bit templates of
all 32 baudot symbols `score = H @ signal` (rtty.py:483-512), recover
timing by integrated-score argmax (rtty.py:530-564), gate on per-symbol SNR
(rtty.py:660-670) and run a LTRS/FIGS state machine (rtty.py:567-700).

Design: the filterbank is a batched windowed FFT over hop frames; ALL
channels' mark/space soft bits become one tensor and the matched filter
over (channel, timing, symbol) is a single matmul `scores = soft @ H.T`
— the reference's 100 per-channel Python loops collapse into one
product. Only the per-character baudot FSM (a few
chars/s of work) stays on the host.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu.ops import cplx, precision

# ITA2 / Baudot code tables (LTRS and FIGS shifts), index = 5-bit code.
BAUDOT_LTRS = [
    '\x00', 'E', '\n', 'A', ' ', 'S', 'I', 'U',
    '\r', 'D', 'R', 'J', 'N', 'F', 'C', 'K',
    'T', 'Z', 'L', 'W', 'H', 'Y', 'P', 'Q',
    'O', 'B', 'G', '\x0f', 'M', 'X', 'V', '\x0e']
BAUDOT_FIGS = [
    '\x00', '3', '\n', '-', ' ', "'", '8', '7',
    '\r', '$', '4', '\x07', ',', '!', ':', '(',
    '5', '+', ')', '2', '#', '6', '0', '1',
    '9', '?', '&', '\x0f', '.', '/', ';', '\x0e']
LTRS_CODE, FIGS_CODE = 31, 27


@dataclasses.dataclass(frozen=True)
class RTTYDesign:
    """Static decoder design (reference RTTY_Params, rtty.py:376-404)."""
    fs: float                      # baseband sample rate
    baud: float = 45.45
    shift_hz: float = 170.0
    frames_per_bit: int = 4        # 4 overlapped FFTs per bit
    max_channels: int = 100
    kaiser_beta: float = 8.6

    @property
    def bit_len(self) -> int:
        """Samples per bit."""
        return int(round(self.fs / self.baud))

    @property
    def nfft(self) -> int:
        """Window = one bit period, padded to a power of two."""
        n = self.bit_len
        return 1 << int(np.ceil(np.log2(n)))

    @property
    def hop(self) -> int:
        return self.bit_len // self.frames_per_bit

    @property
    def bin_hz(self) -> float:
        return self.fs / self.nfft

    @property
    def shift_bins(self) -> int:
        return max(1, int(round(self.shift_hz / self.bin_hz)))

    def window(self) -> np.ndarray:
        w = np.kaiser(self.bit_len, self.kaiser_beta)
        return (w / w.sum()).astype(np.float32)

    # character frame: 1 start bit (space) + 5 data + 2 stop bits (mark)
    @property
    def bits_per_char(self) -> int:
        return 8

    @property
    def frames_per_char(self) -> int:
        return self.bits_per_char * self.frames_per_bit


def char_templates(design: RTTYDesign) -> np.ndarray:
    """(32, frames_per_char) ±1 templates: start=space(-1), 5 data bits
    LSB-first (mark=+1 for 1), stop=mark(+1). The reference's per-decoder
    template bank (rtty.py:483-512) shared by all channels."""
    fpb = design.frames_per_bit
    rows = []
    for code in range(32):
        bits = [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                         for b in range(5)] + [1.0, 1.0]
        rows.append(np.repeat(bits, fpb))
    return np.asarray(rows, np.float32)


def filterbank_block(x_packed, design: RTTYDesign, window):
    """Windowed overlapped FFTs: packed IQ (n, 2) -> magnitude spectra
    (n_frames, nfft) float32, frames at `hop` spacing (4 per bit)."""
    x = cplx.unpack(x_packed) if not jnp.iscomplexobj(x_packed) else x_packed
    n = x.shape[0]
    bl, hop, nfft = design.bit_len, design.hop, design.nfft
    n_frames = (n - bl) // hop + 1
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(bl)[None, :]
    segs = x[idx] * window[None, :]
    spec = jnp.fft.fft(segs, n=nfft, axis=-1)
    return jnp.abs(spec).astype(jnp.float32)


def soft_bits(mags, mark_bins, space_bins):
    """Per-channel FSK soft decision from filterbank magnitudes.
    mags: (n_frames, nfft); mark/space_bins: (n_ch,) int32.
    Returns (n_frames, n_ch) in [-1, 1]: +1 = mark."""
    mark = mags[:, mark_bins]
    space = mags[:, space_bins]
    return (mark - space) / (mark + space + 1e-9)


def matched_scores(soft, templates):
    """scores[f, c, s] = sum_t soft[f+t, c] * templates[s, t] — every
    (frame offset, channel, symbol) at once: ONE matmul (the
    reference's 100-decoder loop, rtty.py:850-853)."""
    n_frames, n_ch = soft.shape
    L = templates.shape[1]
    n_off = n_frames - L + 1
    idx = jnp.arange(n_off)[:, None] + jnp.arange(L)[None, :]
    windows = soft[idx]                                # (n_off, L, n_ch)
    w2 = windows.transpose(0, 2, 1).reshape(n_off * n_ch, L)
    sc = precision.dot(w2, templates.T)                # (n_off*n_ch, 32)
    return sc.reshape(n_off, n_ch, templates.shape[0])


class RTTYDecoder:
    """Host-driven streaming decoder over the device filterbank/matmul.

    detect_channels: pick carrier candidates from the average spectrum
    (reference find_sigs scan, rtty.py:744-776). decode_block: per channel,
    slice symbol windows on the recovered clock, argmax matched scores,
    SNR-gate, and feed the baudot FSM (rtty.py:567-700).
    """

    def __init__(self, design: RTTYDesign, rescan_every: int = 4,
                 expire_after: int = 4, thresh_db: float = 10.0,
                 rel_db: float = 40.0):
        self.design = design
        # host numpy: baked into the filterbank executable as a constant
        self.window = np.asarray(design.window())
        self._fb = jax.jit(
            lambda xp: filterbank_block(xp, design, self.window))
        self.templates = jnp.asarray(char_templates(design))
        self.channels: list[dict] = []   # {mark_bin, figs, text, ...}
        self._soft_tail = None
        self._iq_tail = None             # keeps frames hop-aligned across blocks
        # continuous-scan policy (the reference scans every pass,
        # rtty.py:744-776): re-scan every N blocks, expire a channel after
        # M consecutive scans below threshold
        self.rescan_every = max(1, rescan_every)
        self.expire_after = max(1, expire_after)
        self.thresh_db = thresh_db
        # dynamic-range window: ignore pairs more than rel_db below the
        # strongest pair (suppresses filter-stopband images of strong
        # stations on clean captures, where the absolute floor is ~0)
        self.rel_db = rel_db
        self._n_blocks = 0

    def _new_channel(self, mark_bin: int) -> dict:
        return {"mark_bin": int(mark_bin), "figs": False, "text": "",
                "snr_db": 0.0, "idle_scans": 0}

    def _candidate_bins(self, avg: np.ndarray,
                        pk: np.ndarray | None = None) -> list[int]:
        """Mark-bin candidates: FSK pairs (mark + space shift_bins below)
        above the median floor, strongest first, de-overlapped. The
        threshold tests the pair's JOINT mean energy: FSK keys exactly one
        of the two tones at any instant, so mark+space together is
        duty-cycle-invariant, while either bin alone under-reports at
        mark-heavy duty cycles (idle is all-mark). Floor = 25th
        percentile: at the reference's 100-stations-in-band density
        (rtty.py:56) the MEDIAN bin is already signal-occupied."""
        d = self.design
        floor = np.percentile(avg, 25)
        sb = d.shift_bins
        cand = []
        joint = avg + np.roll(avg, sb)   # mark at b, space at b - shift
        order = np.argsort(joint)[::-1]
        used = np.zeros(len(avg), bool)
        min_joint = joint.max() * 10 ** (-self.rel_db / 20)
        for b in order:
            if len(cand) >= d.max_channels:
                break
            sp = (b - sb) % len(avg)
            if used[b] or used[sp]:
                continue
            if joint[b] < min_joint:
                break            # sorted descending — all weaker below
            if 20 * np.log10(joint[b] / (2 * floor) + 1e-12) \
                    < self.thresh_db:
                continue
            # exclusion zone [mark-2*shift, mark+shift]: covers the pair's
            # own span plus the keying sidebands below the space tone
            # (which otherwise spawn shadow channels decoding duplicate
            # text) while staying narrower than the reference's
            # 100-stations-in-band pitch (rtty.py:56)
            lo = max(0, b - 2 * sb)
            used[lo:b + sb + 1] = True
            cand.append(int(b))
        return cand

    def detect_channels(self, mags_np: np.ndarray,
                        thresh_db: float | None = None):
        """Initial scan: replace the channel list (reference find_sigs,
        rtty.py:744-776)."""
        if thresh_db is not None:
            self.thresh_db = thresh_db
        cand = self._candidate_bins(mags_np.mean(axis=0))
        self.channels = [self._new_channel(b) for b in sorted(cand)]
        # a full re-detect replaces the channel set: any carried soft-bit
        # tail indexes the OLD columns (a (t, 0) tail survives the
        # all-expired case and would crash the next concat; a same-width
        # stale tail would silently feed the wrong stations)
        self._soft_tail = None
        return [c["mark_bin"] for c in self.channels]

    def rescan(self, mags_np: np.ndarray) -> tuple[list[int], list[int]]:
        """Continuous operation: merge newly-appeared stations into the
        channel list and expire ones that have gone quiet, preserving the
        decode state (pos/figs/lock) of surviving channels. Returns
        (added_bins, removed_bins)."""
        d = self.design
        avg = mags_np.mean(axis=0)
        sb = d.shift_bins
        cand = self._candidate_bins(avg)
        added, removed = [], []
        # activity bookkeeping for existing channels (joint mark+space
        # energy, duty-cycle invariant — see _candidate_bins)
        floor = np.percentile(avg, 25)
        for ch in self.channels:
            b = ch["mark_bin"]
            sp = (b - sb) % len(avg)
            snr = 20 * np.log10((avg[b] + avg[sp]) / (2 * floor) + 1e-12)
            ch["snr_db"] = float(snr)
            active = snr >= self.thresh_db or any(
                abs(c - b) <= sb for c in cand)
            ch["idle_scans"] = 0 if active else ch.get("idle_scans", 0) + 1
        survivors = []
        for ch in self.channels:
            if ch["idle_scans"] >= self.expire_after:
                removed.append(ch["mark_bin"])
            else:
                survivors.append(ch)
        # add genuinely new stations (not near a survivor)
        for b in cand:
            if len(survivors) >= d.max_channels:
                break
            if all(abs(b - ch["mark_bin"]) > 2 * sb for ch in survivors):
                nc = self._new_channel(b)
                survivors.append(nc)
                added.append(b)
        if added or removed:
            # remap the persistent soft-bit tail to the new channel order:
            # survivors keep their column, new channels start from zeros
            old_idx = {ch["mark_bin"]: i
                       for i, ch in enumerate(self.channels)}
            survivors.sort(key=lambda c: c["mark_bin"])
            if self._soft_tail is not None:
                tail = np.zeros((len(self._soft_tail), len(survivors)),
                                np.float32)
                for j, ch in enumerate(survivors):
                    i = old_idx.get(ch["mark_bin"])
                    if i is not None:
                        tail[:, j] = self._soft_tail[:, i]
                self._soft_tail = tail
        self.channels = survivors
        return added, removed

    def decode_block(self, x_packed) -> list[str]:
        """Process one baseband block; returns newly decoded text per
        channel. Device: filterbank + soft bits + matched scores; host:
        symbol slicing + baudot FSM."""
        d = self.design
        x = cplx.unpack(np.asarray(x_packed)) \
            if not np.iscomplexobj(np.asarray(x_packed)) else np.asarray(x_packed)
        if self._iq_tail is not None:
            x = np.concatenate([self._iq_tail, x])
        bl, hop = d.bit_len, d.hop
        n_frames = (len(x) - bl) // hop + 1
        if n_frames < 1:
            self._iq_tail = x
            return ["" for _ in self.channels]
        consumed = n_frames * hop
        self._iq_tail = x[consumed:].copy()
        # feed exactly the samples the frames read: the raw tail length
        # cycles block-to-block, and feeding all of x gave the jitted
        # filterbank dozens of distinct input shapes (one expensive
        # compile each on this backend); the frame-exact slice has at
        # most two shapes per block size
        need = (n_frames - 1) * hop + bl
        mags = self._fb(cplx.pack(x[:need]))
        # spectrum tap for the live RTTY waterfall (the reference RTTY
        # window's top pane, rtty.py:92-371): mean |X| over this block
        self.last_spectrum = np.asarray(mags).mean(axis=0)
        self._n_blocks += 1
        if not self.channels:
            self.detect_channels(np.asarray(mags))
            if not self.channels:
                return []
        elif self._n_blocks % self.rescan_every == 0:
            # continuous station add/expire (reference re-scans every
            # pass, rtty.py:744-776)
            self.rescan(np.asarray(mags))
            if not self.channels:
                return []
        nfft = d.nfft
        mark_bins = jnp.asarray([c["mark_bin"] for c in self.channels],
                                jnp.int32)
        space_bins = (mark_bins - d.shift_bins) % nfft
        soft = soft_bits(mags, mark_bins, space_bins)
        soft_np = np.asarray(soft)                    # (n_frames, n_ch)
        # persistent soft-bit buffer so characters straddling block edges
        # decode intact (the reference's prev-symbol concat, rtty.py:825-831)
        if self._soft_tail is not None \
                and self._soft_tail.shape[1] == soft_np.shape[1]:
            soft_np = np.concatenate([self._soft_tail, soft_np])
        fpc = d.frames_per_char
        keep = 2 * fpc
        if soft_np.shape[0] < fpc:
            # not one character's worth of frames yet (small device
            # blocks) — accumulate and wait
            self._soft_tail = soft_np.copy()
            return ["" for _ in self.channels]
        sc = np.asarray(matched_scores(jnp.asarray(soft_np),
                                       self.templates))  # (n_off, n_ch, 32)
        out = []
        for ci, ch in enumerate(self.channels):
            out.append(self._decode_channel(sc[:, ci, :], ch))
        # trim consumed frames; shift channel positions into the kept tail
        trim = max(0, len(soft_np) - keep)
        self._soft_tail = soft_np[trim:].copy()
        for ch in self.channels:
            ch["pos"] = max(0, ch.get("pos", 0) - trim)
        return out

    def _decode_channel(self, scores: np.ndarray, ch: dict) -> str:
        """Symbol-synchronous decode with per-character timing recovery:
        search the full character period for the best-matching (offset,
        symbol), emit if the normalized score clears the gate, then jump
        one character (the reference's integrated-score argmax timing,
        rtty.py:530-564, per character instead of per window)."""
        d = self.design
        fpc = d.frames_per_char
        gate = 0.5 * fpc            # perfect match scores ~fpc
        text = []
        pos = ch.get("pos", 0)
        locked = ch.get("locked", False)
        misses = ch.get("misses", 0)
        n_off = scores.shape[0]
        while pos + 1 < n_off:
            # acquisition: search a whole character period; once locked,
            # only a ±1-frame jitter window so shift chars can't be skipped
            span = 3 if locked else fpc
            lo = max(0, pos - 1) if locked else pos
            hi = lo + span
            if hi > n_off:
                # the full search span hasn't streamed in yet — deciding
                # on a truncated window picks premature off-center chars
                # (garbles small-block incremental decode); wait
                break
            win = scores[lo:hi]
            best = np.unravel_index(np.argmax(win), win.shape)
            off, sym = lo + int(best[0]), int(best[1])
            if win[best] > gate:
                text.append(self._baudot(sym, ch))
                pos = off + fpc
                locked, misses = True, 0
            else:
                pos += fpc
                if locked:
                    misses += 1
                    if misses >= 2:
                        locked, misses = False, 0
        ch["pos"] = pos   # absolute in the soft buffer; caller trims
        ch["locked"], ch["misses"] = locked, misses
        s = "".join(t for t in text if t)
        ch["text"] += s
        return s

    @staticmethod
    def _baudot(code: int, ch: dict) -> str:
        if code == LTRS_CODE:
            ch["figs"] = False
            return ""
        if code == FIGS_CODE:
            ch["figs"] = True
            return ""
        table = BAUDOT_FIGS if ch["figs"] else BAUDOT_LTRS
        c = table[code]
        return c if c not in ("\x00", "\x0e", "\x0f") else ""


def synthesize_rtty(text: str, design: RTTYDesign, carrier_hz: float,
                    amplitude: float = 1.0, snr_db: float | None = None,
                    seed: int = 0) -> np.ndarray:
    """Generate a baudot FSK baseband signal for tests (the reference
    validates against recorded RTTY captures with known content, rtty:1-40)."""
    d = design
    ltrs = {c: i for i, c in enumerate(BAUDOT_LTRS)}
    figs = {c: i for i, c in enumerate(BAUDOT_FIGS)}
    bits = [1.0] * (4 * d.bits_per_char)  # idle mark
    in_figs = False
    for c in text.upper():
        if c in ltrs:
            if in_figs:
                code, in_figs = LTRS_CODE, False
                bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                                  for b in range(5)] + [1.0, 1.0]
            code = ltrs[c]
        elif c in figs:
            if not in_figs:
                code, in_figs = FIGS_CODE, True
                bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                                  for b in range(5)] + [1.0, 1.0]
            code = figs[c]
        else:
            continue
        bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                          for b in range(5)] + [1.0, 1.0]
    bits += [1.0] * (4 * d.bits_per_char)
    sig = np.repeat(bits, d.bit_len)
    f_dev = d.shift_hz / 2.0
    inst = carrier_hz - f_dev + (np.asarray(sig) * 0.5 + 0.5) * d.shift_hz
    phase = 2 * np.pi * np.cumsum(inst) / d.fs
    x = amplitude * np.exp(1j * phase)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        npow = amplitude ** 2 / (10 ** (snr_db / 10))
        x = x + np.sqrt(npow / 2) * (rng.standard_normal(len(x))
                                     + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)
