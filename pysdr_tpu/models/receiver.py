"""The receiver: NCO mix -> polyphase decimate -> demod -> AGC, as one pure
block-processing function, vmapped into an arbitrary-N channel bank.

Reference architecture being re-expressed (NOT translated): the
`SDR_EXECUTIVE.Run` hot loop drives up to MAX_RX=6 `dsp.Receiver` chains,
each `lo -> dec -> demod -> agc` with mutable hot-swapped filters
(reference receiver.py:684-782, 825-835; chain members §2.9 of SURVEY.md).
Here one jitted `process_block(state, iq, params) -> (state, audio)` holds
the whole chain; the channel axis is a vmap (sharded across devices in
parallel/); every GUI-mutable quantity (NCO frequency, filter-bank row,
mode, gains) is a *traced* per-channel value in ChannelParams, so all the
reference's control-plane mutations (FreqSelect gui.py:1900-2038,
Video_BWSelect gui.py:1672-1714, ModeSelect gui.py:2042-2078) become pure
data swaps between blocks — zero recompiles, matching the reference's
block-boundary mutation discipline (receiver.py:633-680).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu import config as cfg_mod
from pysdr_tpu import tables
from pysdr_tpu.ops import cplx
from pysdr_tpu.ops import demod as demod_ops
from pysdr_tpu.ops import fir, nco, resample
from pysdr_tpu.tables import Mode


class ChannelParams(NamedTuple):
    """Per-channel traced parameters (leading axis = channel in the bank)."""
    nco_k: jax.Array           # int32 () NCO numerator (offset in passband)
    video_row: jax.Array       # int32 () index into the video weight bank
    demod: demod_ops.DemodParams


class ChannelState(NamedTuple):
    nco_phase: jax.Array       # int32 ()
    demod: demod_ops.DemodState


class BankState(NamedTuple):
    """Whole-bank carried state. The resampler history is the RAW RF tail
    (last Kp-1 input samples), which is channel-independent: the NCO phase
    is analytic (ops/nco.py), so each channel re-mixes the shared raw tail
    at its back-shifted phase — bit-identical to carrying a per-channel
    mixed tail, at 1/n_rx the state."""
    hist: jax.Array            # complex64 (Kp-1,) raw RF tail
    ch: ChannelState           # stacked per-channel (leading axis n_rx)


@dataclasses.dataclass(frozen=True)
class ReceiverDesign:
    """Static design: everything that selects the compiled executable."""
    fs_in: float
    fs_out: float
    up: int
    down: int
    in_block: int
    out_block: int
    video_taps: int            # prototype length (up * taps_per_phase)
    demod: demod_ops.DemodDesign

    @classmethod
    def from_config(cls, cfg: cfg_mod.PipelineConfig) -> "ReceiverDesign":
        plan = cfg.plan
        tpp = cfg.video_taps_per_phase or max(
            16, int(np.ceil(8 * plan.down / plan.up)))
        return cls(fs_in=cfg.fs_in, fs_out=plan.fs_out, up=plan.up,
                   down=plan.down, in_block=plan.in_block,
                   out_block=plan.out_block, video_taps=plan.up * tpp,
                   demod=demod_ops.DemodDesign(fs_out=plan.fs_out,
                                               af_taps=cfg.af_taps))


def channel_step(x, hist, state: ChannelState, p: ChannelParams,
                 design: ReceiverDesign, video_bank, carrier_taps,
                 pilot_taps):
    """One channel, one block: the whole `demodulate_data` equivalent
    (reference receiver.py:231-297). x: complex64 (in_block,) shared RF
    block; hist: complex64 (Kp-1,) shared RAW tail of the previous block.
    state.nco_phase is the LO phase index at x[0]; the tail is re-mixed at
    the back-shifted phase, reproducing the previous block's mixed tail
    exactly. Returns (audio complex64 (out_block,), new_state, bb).

    This is the per-channel REFERENCE form. The production paths (the
    bank's _step_impl and the stream shards) use the fused bank-level
    mix+resample instead (ops/resample.mixed_resample_bank, which never
    materializes the per-channel mixed streams); equivalence between the two forms is pinned >80 dB at the
    model level in tests/test_receiver.py."""
    kp1 = hist.shape[0]
    k = p.nco_k
    p0m = nco.advance((nco.DENOM - k) % nco.DENOM, state.nco_phase, kp1)
    y, _ = nco.mix_down(jnp.concatenate([hist, x]), k, p0m)
    phase = nco.advance(k, state.nco_phase, x.shape[0])
    w = jnp.asarray(video_bank)[p.video_row]
    bb, _ = resample.resample_block(
        y[kp1:], y[:kp1], w, up=design.up, down=design.down)
    audio, dstate = demod_ops.demod_block(
        bb, state.demod, p.demod, design.demod, carrier_taps, pilot_taps)
    return audio, ChannelState(nco_phase=phase, demod=dstate), bb


class ReceiverBank:
    """N independent receivers inside one passband + host control plane.

    The arbitrary-N generalization of the reference's MAX_RX=6 RX bank
    (params.py:33): one vmap over the channel axis; all per-channel knobs
    traced. Functional core: `step(state, x) -> (state, audio)`; the
    mutating methods only rewrite the host-side params arrays (pure data,
    applied at the next block boundary).
    """

    def __init__(self, cfg: cfg_mod.PipelineConfig, emit_baseband=False,
                 audio_wire: str = "f32"):
        cfg_mod.validate(cfg)
        self.cfg = cfg
        assert audio_wire in ("f32", "i16", "i8"), audio_wire
        self.audio_wire = audio_wire
        self.design = ReceiverDesign.from_config(cfg)
        d = self.design
        # Video (anti-alias) weight bank: one packed conv weight per
        # VIDEO_BWs row (reference dec.filter_bank, gui.py:1672-1714).
        self.video_bws = [bw for bw in tables.VIDEO_BWS_HZ
                          if bw == 0.0 or bw <= d.fs_out]
        proto = fir.video_filter_bank(d.fs_in, d.up, d.down, self.video_bws,
                                      taps_per_phase=d.video_taps // d.up)
        # Constants are kept as HOST numpy arrays, baked straight into the
        # executable; complex ones stay packed float (ops/cplx.py).
        self.video_bank = resample.pack_weight_bank(proto, d.up, d.down)
        self.video_proto = proto   # for the internals dump (receiver.py:864)
        self.carrier_taps = cplx.pack(d.demod.carrier_filter())
        self.pilot_taps = cplx.pack(d.demod.pilot_filter())
        self.emit_baseband = emit_baseband

        self._rx_cfgs = list(cfg.receivers)
        # the device tuner's dial-frequency anchor (center of the
        # passband in dial terms). Moves only on a main-RX out-of-band
        # retune via on_device_retune (the reference's FreqSelect device
        # retune, gui.py:1938-1944); all NCO offsets derive from it.
        self._center_dial = cfg.receivers[0].fc_hz - cfg.foffset_hz
        # host callback(new_center_dial_hz): retune the physical source
        # (set by the app when the source supports it, e.g. rtl_tcp)
        self.on_device_retune = None
        self.params = self._build_params()
        state_c = self.init_state()                     # host numpy tree
        packed, self._state_mask = cplx.pack_tree(state_c)  # host float32
        self.state = jax.tree.map(jnp.asarray, packed)  # device, no complex

        self._step = jax.jit(self._step_impl)

    # ---------- construction ----------

    def _params_for(self, rc: cfg_mod.ReceiverConfig,
                    offset_hz: float) -> ChannelParams:
        d = self.design
        row = self._video_row_for(rc)
        dp = demod_ops.make_params(
            d.demod, rc.mode, af_bw_hz=rc.af_bw_hz, bfo_hz=rc.bfo_hz,
            af_gain=rc.af_gain, squelch_db=rc.squelch_db,
            agc_on=rc.agc_enabled, muted=rc.muted, auto_mute=rc.auto_mute,
            auto_mute_db=rc.auto_mute_db)
        return ChannelParams(
            nco_k=jnp.int32(nco.snap_freq(offset_hz, d.fs_in)),
            video_row=jnp.int32(row), demod=dp)

    def _video_row_for(self, rc: cfg_mod.ReceiverConfig) -> int:
        if rc.video_bw_hz <= 0:
            return 0
        return tables.find_filter_index(rc.video_bw_hz, self.video_bws)

    def _build_params(self) -> ChannelParams:
        # NCO offsets from the CURRENT per-RX dials against the device
        # center anchor: cfg.channel_offsets_hz snapshots the
        # construction-time receivers, so deriving from it made every
        # later retune a dial-display-only no-op (the DSP kept listening
        # at the old frequency) — caught round 4. A chained RX
        # (rc.src >= 0) uses the reference's EXACT legacy formula,
        # fc_i - fc_src with no foffset (receiver.py:825-835): it hits a
        # physical station only when the device is centered on the
        # source RX's dial (the reference's rig-IF monitoring use); for
        # ordinary station tuning use src = -1.
        def off(rc):
            if 0 <= rc.src < len(self._rx_cfgs):
                return rc.fc_hz - self._rx_cfgs[rc.src].fc_hz
            return rc.fc_hz - self._center_dial
        plist = [self._params_for(rc, off(rc)) for rc in self._rx_cfgs]
        # host-side shadow of the video rows, so consumers need not pull
        # the device array
        self._video_rows_host = tuple(self._video_row_for(rc)
                                      for rc in self._rx_cfgs)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *plist)

    def init_state(self) -> BankState:
        # Pure host numpy: the constructor packs this tree on the host
        # and device_puts float32 pairs only (ops/cplx.py).
        d = self.design
        one = ChannelState(
            nco_phase=np.zeros((), np.int32),
            demod=demod_ops.init_state(d.demod))
        ch = jax.tree.map(
            lambda x: np.broadcast_to(x, (self.n_rx,) + x.shape).copy(),
            one)
        hist = np.zeros(resample.history_len(d.video_taps, d.up),
                        np.complex64)
        return BankState(hist=hist, ch=ch)

    @property
    def n_rx(self) -> int:
        return len(self._rx_cfgs)

    # ---------- functional core ----------

    def _step_impl(self, state_p, x_p, params):
        """Packed-boundary step: state_p/audio are float32 re-im pairs;
        x_p is float32 OR an int8/int16 wire block (cplx.dequantize);
        complex64 exists only inside this jit."""
        with jax.named_scope("dequantize"):
            x = cplx.unpack(cplx.dequantize(x_p))
        state = cplx.unpack_tree(state_p, self._state_mask)
        d = self.design
        kp1 = state.hist.shape[0]
        n = x.shape[0]

        # Fused bank-level mix+resample on the SHARED raw slab matrix
        # (ops/resample.mixed_resample_bank): the per-channel LO folds
        # into complex resampler weights via the exact integer-phase
        # factorization, so no per-channel mixed stream is materialized.
        # channel_step remains as the reference per-channel form, used
        # only by the equivalence tests (the stream-parallel processors
        # fuse too).
        with jax.named_scope("mix_resample"):
            p0m = jax.vmap(
                lambda k, p: nco.advance((nco.DENOM - k) % nco.DENOM, p,
                                         kp1)
            )(params.nco_k, state.ch.nco_phase)
            w_rx = jnp.asarray(self.video_bank)[params.video_row]
            bb = resample.mixed_resample_bank(
                x, state.hist, w_rx, params.nco_k, p0m, up=d.up,
                down=d.down)
        new_phase = jax.vmap(lambda k, p: nco.advance(k, p, n))(
            params.nco_k, state.ch.nco_phase)

        def one(bb_i, dst, pr):
            return demod_ops.demod_block(
                bb_i, dst, pr.demod, d.demod, self.carrier_taps,
                self.pilot_taps)
        with jax.named_scope("demod"):
            audio, new_demod = jax.vmap(one)(bb, state.ch.demod, params)
        new_ch = ChannelState(nco_phase=new_phase, demod=new_demod)
        new_state = BankState(hist=x[-kp1:] if kp1 else state.hist,
                              ch=new_ch)
        new_state_p, _ = cplx.pack_tree(new_state)
        # audio may leave the device as int16/int8 pairs (the executive
        # dequantizes on the host)
        with jax.named_scope("wire_out"):
            out = (cplx.quantize_audio_wire(cplx.pack(audio).reshape(-1),
                                            self.audio_wire),
                   cplx.pack(bb).reshape(-1) if self.emit_baseband
                   else None)
        return new_state_p, out

    def step(self, x):
        """Host convenience: process one RF block (in_block complex64 on
        the host). Returns host audio (n_rx, out_block) complex64;
        advances internal state."""
        audio_flat = cplx.dequantize_audio_host(
            np.asarray(self.step_device(self.to_device_block(x))))
        return cplx.unpack(
            audio_flat.reshape(self.n_rx, self.design.out_block, 2))

    def to_device_block(self, x):
        """Host complex block -> device packed pair (n, 2)."""
        if jnp.iscomplexobj(x):
            return cplx.to_device(np.asarray(x))
        return jnp.asarray(x)

    def step_device(self, x_p):
        """Device-native step: x_p float32 (in_block, 2) packed; returns
        packed audio flattened (n_rx*out_block*2,) on device (no host
        transfer — the bench path)."""
        self.state, (audio_p, bb) = self.step_functional(
            self.state, x_p, self.params)
        self._last_bb = bb
        return audio_p

    def step_functional(self, state_p, x_p, params):
        return self._step(state_p, x_p, params)

    # ---------- control plane (block-boundary mutations) ----------

    def _update(self, i: int, **changes):
        self._rx_cfgs[i] = dataclasses.replace(self._rx_cfgs[i], **changes)
        self.params = self._build_params()

    def retune(self, i: int, fc_hz: float):
        """Reference FreqSelect (gui.py:1900-2038): in-passband retunes
        are pure NCO-numerator updates; a MAIN-RX retune that leaves the
        passband moves the DEVICE (gui.py:1938-1944
        `setFrequency(f2-FOFFSET)`) via on_device_retune when the source
        supports it, re-anchoring every channel's offset."""
        half = self.cfg.fs_in / 2
        if abs(fc_hz - self._center_dial) >= half:
            if i == 0 and self.on_device_retune is not None:
                self._center_dial = fc_hz - self.cfg.foffset_hz
                self.on_device_retune(self._center_dial)
                # moving the passband can strand OTHER RXs outside it:
                # their dials are absolute (the reference's sub-RXs are
                # expected to live inside the main RX's passband)
                displaced = [
                    j for j, rc in enumerate(self._rx_cfgs)
                    if j != i
                    and abs(rc.fc_hz - self._center_dial) >= half]
                if displaced:
                    import warnings
                    warnings.warn(
                        f"device retune to "
                        f"{self._center_dial / 1e6:.3f} MHz leaves "
                        f"RX{displaced} outside the passband: retune "
                        "them or their audio will alias", stacklevel=2)
            else:
                import warnings
                why = ("only a MAIN-RX (RX0) retune moves the device; "
                       "retune RX0 to move the passband"
                       if self.on_device_retune is not None
                       else "the source cannot retune")
                warnings.warn(
                    f"RX{i} retune to {fc_hz / 1e6:.3f} MHz is outside "
                    f"the current passband (center "
                    f"{self._center_dial / 1e6:.3f} MHz ± "
                    f"{half / 1e6:.3f} MHz) — {why}: reception will "
                    "alias", stacklevel=2)
        self._update(i, fc_hz=fc_hz)

    def set_mode(self, i: int, mode: Mode):
        self._update(i, mode=tables.Mode(mode))

    def set_video_bw(self, i: int, bw_hz: float):
        self._update(i, video_bw_hz=bw_hz)

    def set_af_bw(self, i: int, bw_hz: float):
        self._update(i, af_bw_hz=bw_hz)

    def set_af_gain(self, i: int, gain: float):
        self._update(i, af_gain=gain)

    def set_squelch(self, i: int, level_db: float):
        self._update(i, squelch_db=level_db)

    def set_agc(self, i: int, enabled: bool):
        self._update(i, agc_enabled=enabled)

    def set_mute(self, i: int, muted: bool):
        """Per-RX mute (reference P.MUTED[irx] -> af_gain=0,
        receiver.py:168-197; GUI MuteCB)."""
        self._update(i, muted=bool(muted))

    def set_auto_mute(self, i: int, enabled: bool,
                      thresh_db: float | None = None):
        """Arm/disarm strong-signal auto-mute on one RX (reference
        ENABLE_AUTO_MUTE + rx.auto_mute, receiver.py:237-245)."""
        kw = {"auto_mute": bool(enabled)}
        if thresh_db is not None:
            kw["auto_mute_db"] = float(thresh_db)
        self._update(i, **kw)

    def set_auto_mute_all(self, enabled: bool):
        """SO2V/DXSPLIT arm every RX at once (reference udp.py:43-60)."""
        for i in range(self.n_rx):
            self._rx_cfgs[i] = dataclasses.replace(
                self._rx_cfgs[i], auto_mute=bool(enabled))
        self.params = self._build_params()

    # ---------- verification harness ----------

    def dump_internals(self) -> dict:
        """Filter-bank dump for numerical cross-validation — the
        `internals.mat` harness (reference receiver.py:864-874,
        sigs/internals.m)."""
        d = self.design
        return {
            "up": d.up, "down": d.down, "fs_in": d.fs_in,
            "fs_out": d.fs_out,
            "video_filter_bank": np.asarray(self.video_proto),
            "carrier_filter": np.asarray(self.carrier_taps),
            "af_banks": {i: np.asarray(p.af_taps)
                         for i, p in enumerate(
                             [self._params_for(rc, 0.0).demod
                              for rc in self._rx_cfgs])},
        }
