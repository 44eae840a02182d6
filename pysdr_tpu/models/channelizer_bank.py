"""ChannelizerBank: polyphase-channelize the whole passband, then demod
every channel — the 64+-channel generalization of the reference's
MAX_RX=6 receiver bank (reference params.py:33, receiver.py:825-835;
BASELINE config 5).

Where ReceiverBank pays one NCO+polyphase-decimate chain per RX (fine for
<=6 arbitrary frequencies), the channelizer splits fs_in into N uniform
channels with ONE branch filter + ONE DFT, then runs the ordinary demod
chain on every channel stream:

    x (fs_in) -> branch filter (elementwise) -> DFT matmul
      -> per-channel [fine NCO -> polyphase fs_ch->fs_out -> demod]

Design choices:
  * the channel transform is a DFT-matrix MATMUL, not an FFT: it shards
    over a 'ch' mesh axis with zero collectives (each device computes
    only its channels' DFT columns; an FFT along the sharded axis would
    need an all-to-all) — see ops/channelizer.py;
  * all per-channel knobs (fine offset, mode, AF/gain/squelch/mute) are
    traced leading-axis arrays exactly like ReceiverBank, so retunes and
    mode changes are pure data and the channel axis vmaps/shards;
  * packed float32 re/im boundary discipline throughout (ops/cplx.py).

Channels are critically sampled; a fine retune off channel center is
legal but approaches the channel edge at |offset| -> fs_ch/2 (aliasing),
like any critically-sampled PFB.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pysdr_tpu import rates, tables
from pysdr_tpu.ops import channelizer as chan_ops
from pysdr_tpu.ops import cplx
from pysdr_tpu.ops import demod as demod_ops
from pysdr_tpu.ops import fir, nco, resample
from pysdr_tpu.tables import Mode


@dataclasses.dataclass(frozen=True)
class ChannelSettings:
    """Per-channel demod settings (the ReceiverConfig analogue; the RF
    frequency is implied by the channel index, plus a fine offset)."""
    mode: Mode = Mode.AM
    fine_offset_hz: float = 0.0    # NCO offset from the channel center
    video_bw_hz: float = 0.0       # pre-demod channel filter (0 = Max)
    af_bw_hz: float = 0.0
    af_gain: float = 1.0
    agc_enabled: bool = True
    squelch_db: float = -150.0
    bfo_hz: float = tables.CW_BFO_HZ
    muted: bool = False
    auto_mute: bool = False
    auto_mute_db: float = -10.0


@dataclasses.dataclass(frozen=True)
class ChannelizerBankConfig:
    fs_in: float                    # total passband rate
    n_channels: int                 # uniform channels (fs_ch = fs_in / N)
    fs_out: float = 48e3
    out_block: int = 4096           # audio samples per block per channel
    fc_hz: float = 0.0              # RF frequency of the passband center
    taps_per_branch: int = 12
    af_taps: int = 256
    video_taps_per_phase: int = 16  # fs_ch -> fs_out resampler
    channels: tuple[ChannelSettings, ...] = ()

    def __post_init__(self):
        if not self.channels:
            object.__setattr__(
                self, "channels",
                tuple(ChannelSettings() for _ in range(self.n_channels)))
        assert len(self.channels) == self.n_channels

    @property
    def fs_ch(self) -> float:
        return self.fs_in / self.n_channels

    @property
    def plan(self) -> rates.RatePlan:
        return rates.rate_plan(self.fs_ch, self.fs_out, self.out_block)

    def center_freqs_hz(self) -> np.ndarray:
        """Absolute RF center of each channel (fftfreq order, like the
        DFT columns)."""
        return self.fc_hz + np.fft.fftfreq(self.n_channels,
                                           1.0 / self.fs_in)


class ChanBankState(NamedTuple):
    chan_hist: jax.Array     # complex64 ((K-1)*N,) raw input tail
    nco_phase: jax.Array     # int32 (N,) fine-NCO phases
    rs_hist: jax.Array       # complex64 (N, Kp-1) per-channel resampler tail
    demod: demod_ops.DemodState   # leading axis N


class ChanParams(NamedTuple):
    nco_k: jax.Array         # int32 (N,) fine offsets @ fs_ch
    video_row: jax.Array     # int32 (N,) row into the video weight bank
    demod: demod_ops.DemodParams  # leading axis N


class ChannelizerBank:
    """N uniform channels + demod with the same host control plane as
    ReceiverBank (block-boundary pure params swaps)."""

    def __init__(self, cfg: ChannelizerBankConfig,
                 audio_wire: str = "f32"):
        self.cfg = cfg
        assert audio_wire in ("f32", "i16", "i8"), audio_wire
        self.audio_wire = audio_wire
        n = cfg.n_channels
        plan = cfg.plan
        self.plan = plan
        self.chan_design = chan_ops.ChannelizerDesign(
            fs_in=cfg.fs_in, n_channels=n,
            taps_per_branch=cfg.taps_per_branch)
        self.demod_design = demod_ops.DemodDesign(fs_out=plan.fs_out,
                                                  af_taps=cfg.af_taps)
        # in_block at fs_in per device block
        self.out_block = plan.out_block
        self.in_block = plan.in_block * n

        # host-numpy constants baked into the executable (complex ones
        # packed, ops/cplx.py)
        self.branch_weights = chan_ops.pack_branch_weights(
            self.chan_design.prototype(), n)
        self.w_re, self.w_im = chan_ops.dft_matrix(n)

        video_taps = plan.up * cfg.video_taps_per_phase
        self.video_bws = [bw for bw in tables.VIDEO_BWS_HZ
                          if bw == 0.0 or bw <= plan.fs_out]
        self.video_proto = fir.video_filter_bank(
            cfg.fs_ch, plan.up, plan.down, self.video_bws,
            taps_per_phase=cfg.video_taps_per_phase)
        self.video_bank = resample.pack_weight_bank(
            self.video_proto, plan.up, plan.down)
        self.carrier_taps = cplx.pack(self.demod_design.carrier_filter())
        self.pilot_taps = cplx.pack(self.demod_design.pilot_filter())

        self._ch_cfgs = list(cfg.channels)
        self._last_bb = None          # executive/app tap parity
        self.params = self._build_params()
        packed, self._state_mask = cplx.pack_tree(self.init_state())
        self.state = jax.tree.map(jnp.asarray, packed)
        self._step = jax.jit(self._step_impl)

    # ---------- construction ----------

    @property
    def n_ch(self) -> int:
        return self.cfg.n_channels

    # Executive-facing facade: the streaming executive drives any bank
    # through (design.{fs_in,fs_out,in_block,out_block}, n_rx,
    # step_device, control methods) — runtime/executive.py.
    @property
    def n_rx(self) -> int:
        return self.cfg.n_channels

    @property
    def design(self):
        import types
        return types.SimpleNamespace(
            fs_in=self.cfg.fs_in, fs_out=self.plan.fs_out,
            in_block=self.in_block, out_block=self.out_block,
            up=self.plan.up, down=self.plan.down)

    def _params_for(self, cs: ChannelSettings) -> ChanParams:
        dd = self.demod_design
        # the pre-demod filter is selected by video_bw_hz ONLY: picking
        # it from af_bw_hz narrowed the pre-DISCRIMINATOR channel filter
        # whenever the operator narrowed the audio (an NFM channel with
        # a 5 kHz AF filter would have had its FM sidebands amputated
        # before demodulation) — caught round 4
        if cs.video_bw_hz > 0:
            row = tables.find_filter_index(cs.video_bw_hz,
                                           self.video_bws)
        else:
            row = 0
        dp = demod_ops.make_params(
            dd, cs.mode, af_bw_hz=cs.af_bw_hz, bfo_hz=cs.bfo_hz,
            af_gain=cs.af_gain, squelch_db=cs.squelch_db,
            agc_on=cs.agc_enabled, muted=cs.muted, auto_mute=cs.auto_mute,
            auto_mute_db=cs.auto_mute_db)
        return ChanParams(
            nco_k=jnp.int32(nco.snap_freq(cs.fine_offset_hz,
                                          self.cfg.fs_ch)),
            video_row=jnp.int32(row), demod=dp)

    def _build_params(self) -> ChanParams:
        plist = [self._params_for(cs) for cs in self._ch_cfgs]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *plist)

    def init_state(self) -> ChanBankState:
        n = self.n_ch
        kp1 = resample.history_len(
            self.plan.up * self.cfg.video_taps_per_phase, self.plan.up)
        one = demod_ops.init_state(self.demod_design)
        dstate = jax.tree.map(
            lambda x: np.broadcast_to(x, (n,) + x.shape).copy(), one)
        return ChanBankState(
            chan_hist=np.zeros(chan_ops.history_len(self.chan_design),
                               np.complex64),
            nco_phase=np.zeros(n, np.int32),
            rs_hist=np.zeros((n, kp1), np.complex64),
            demod=dstate)

    # ---------- functional core ----------

    def channel_chain(self, s, ph, rh, dst, pr):
        """One channel stream, one block: fine mix -> resample -> demod.
        Shared by the local step and the sharded processor
        (parallel/chanshard.py)."""
        with jax.named_scope("channel_resample"):
            z, ph2 = nco.mix_down(s, pr.nco_k, ph)
            w = jnp.asarray(self.video_bank)[pr.video_row]
            bb, rh2 = resample.resample_block(
                z, rh, w, up=self.plan.up, down=self.plan.down)
        with jax.named_scope("demod"):
            audio, dst2 = demod_ops.demod_block(
                bb, dst, pr.demod, self.demod_design,
                self.carrier_taps, self.pilot_taps)
        return audio, ph2, rh2, dst2

    def _step_impl(self, state_p, x_p, params):
        state = cplx.unpack_tree(state_p, self._state_mask)
        with jax.named_scope("dequantize"):
            x = cplx.unpack(cplx.dequantize(x_p))
        n = self.n_ch
        with jax.named_scope("branch_filter"):
            v, chan_hist = chan_ops.branch_filter(
                x, state.chan_hist, self.branch_weights, n)
        with jax.named_scope("channel_transform"):
            y = chan_ops.channel_transform(v, self.w_re, self.w_im)
            streams = y.T                                        # (N, M)

        audio, phase, rs_hist, dstate = jax.vmap(self.channel_chain)(
            streams, state.nco_phase, state.rs_hist, state.demod,
            params)
        new_state = ChanBankState(chan_hist=chan_hist, nco_phase=phase,
                                  rs_hist=rs_hist, demod=dstate)
        new_state_p, _ = cplx.pack_tree(new_state)
        with jax.named_scope("wire_out"):
            out = cplx.quantize_audio_wire(cplx.pack(audio).reshape(-1),
                                           self.audio_wire)
        return new_state_p, out

    def step_device(self, x_p):
        """x_p: packed float32 (in_block, 2). Returns packed audio
        flattened (n_ch*out_block*2,) on device."""
        self.state, audio_p = self._step(self.state, x_p, self.params)
        return audio_p

    def step(self, x):
        """Host convenience: complex in_block -> (n_ch, out_block)
        complex64 audio."""
        a = cplx.dequantize_audio_host(
            np.asarray(self.step_device(cplx.to_device(x))))
        return cplx.unpack(a.reshape(self.n_ch, -1, 2))

    # ---------- control plane ----------

    def _update(self, i: int, **changes):
        self._ch_cfgs[i] = dataclasses.replace(self._ch_cfgs[i], **changes)
        # channel params are independent, so a single-channel knob swap
        # scatters ONE freshly-built row into the stacked tree — a full
        # _build_params on a 64-1024 channel bank designed a 256-tap FIR
        # per channel for every GUI interaction
        row = self._params_for(self._ch_cfgs[i])
        self.params = jax.tree.map(
            lambda full, new: full.at[i].set(new), self.params, row)

    def retune(self, i: int, fine_offset_hz: float):
        """Fine retune inside channel i (the FreqSelect analogue)."""
        self._update(i, fine_offset_hz=fine_offset_hz)

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
        self._update(i, muted=bool(muted))

    def channel_of(self, freq_hz: float) -> int:
        """Channel index whose center is nearest an absolute RF freq."""
        return int(np.argmin(np.abs(self.cfg.center_freqs_hz() - freq_hz)))
