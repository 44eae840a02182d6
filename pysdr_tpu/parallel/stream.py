"""Stream-axis (time) parallelism: overlap-discard with halo exchange.

The reference processes blocks strictly serially because FIR/NCO/AGC state
carries across chunk boundaries (SURVEY.md §2.10, sigs/iir.py:83-105). This
design parallelizes time: a long IQ stream is cut into S contiguous
segments, one per 'stream' mesh row; each segment is processed with

  * an RF *halo* of H samples fetched from the left neighbor with
    `lax.ppermute` (shard 0 gets zeros) — this warms up every FIR
    history (resampler Kp-1, AF/carrier/pilot taps) and settles the
    exponential-memory recurrences (AGC, DC, de-emphasis) before the
    segment proper begins; the warm-up audio is discarded;
  * an *analytic* NCO phase: the LO phase at sample index m is
    (k*m) mod DENOM — a pure function of position (ops/nco.py), so no
    serial dependency crosses shards at all (the CW BFO likewise, at the
    audio rate).

The result matches serial processing everywhere except inside the first
halo (validated in tests/test_stream_parallel.py). This is the SDR analogue
of ring-attention-style sequence parallelism: the only communication is a
neighbor halo, once per segment.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pysdr_tpu.models import receiver as rx_mod
from pysdr_tpu.ops import cplx
from pysdr_tpu.ops import demod as demod_ops
from pysdr_tpu.ops import nco, resample


def default_halo(design: rx_mod.ReceiverDesign, settle_sec: float = 0.2
                 ) -> int:
    """Halo length in RF samples: covers the resampler history, the AF-
    filter warm-up mapped back to RF rate, and `settle_sec` of recurrence
    settling; rounded up to a multiple of DOWN so polyphase alignment is
    preserved. 0.2 s covers the slowest always-on recurrence (the DC
    blocker, tau ~14 ms) with margin; with AGC enabled the envelope
    tracker's decay (~1 s) is only approximately settled — acceptable
    because AGC gain varies slowly by design (audio-SNR-level match)."""
    kp = resample.taps_per_phase(design.video_taps, design.up)
    af_rf = (design.demod.af_taps + design.demod.carrier_taps) \
        * design.down // design.up
    h = max(4 * kp, af_rf, int(settle_sec * design.fs_in))
    return -(-h // design.down) * design.down


def _shifted_phase(k, base_k_seg, base_k_halo, s):
    """(k*(s*seg - H)) mod DENOM from precomputed per-unit advances.
    nco.advance keeps every int32 product below 2^31 for ANY shard index
    (a bare (base_k_seg * s) wraps at s >= 512 — nco.py discipline)."""
    a = nco.advance(base_k_seg, 0, s)
    return (a - base_k_halo + nco.DENOM) % nco.DENOM


def make_stream_processor(bank: rx_mod.ReceiverBank, mesh: Mesh,
                          seg: int, halo: int | None = None):
    """Build a jitted sharded processor for fixed segment length.

    Returns process(x, params) -> audio where x: float32 (S*seg, 2) packed
    re/im pair sharded P('stream'), params: bank.params (leading channel
    axis, sharded P('ch') if the mesh has a 'ch' axis), audio: packed
    float32 (n_rx, S*seg*up/down, 2).
    """
    design = bank.design
    d, u = design.down, design.up
    assert seg % d == 0, (seg, d)
    H = default_halo(design) if halo is None else halo
    # The halo comes from the immediate left neighbor only, so it cannot
    # exceed one segment; cap (keeping DOWN alignment).
    H = min(H, seg)
    assert H % d == 0
    n_stream = mesh.shape["stream"]
    has_ch = "ch" in mesh.shape and mesh.shape["ch"] > 1
    video_bank = bank.video_bank
    carrier_taps, pilot_taps = bank.carrier_taps, bank.pilot_taps
    out_halo = H * u // d
    aseg, ahalo = seg * u // d, out_halo

    kp1 = resample.history_len(design.video_taps, design.up)

    def shard_fn(x_local, params):
        # x_local: float32 (seg, 2) packed pair — complex64 never crosses
        # the jit boundary (ops/cplx.py). Halo exchange rides the pair.
        tail = x_local[-H:]
        perm = [(i, i + 1) for i in range(n_stream - 1)]
        left_halo = jax.lax.ppermute(tail, "stream", perm)
        xe = cplx.unpack(jnp.concatenate([left_halo, x_local]))  # (H+seg,)
        s = jax.lax.axis_index("stream")

        # Fused bank-level mix+resample on the shared extended segment
        # (ops/resample.mixed_resample_bank — same path as the serial
        # bank's step): analytic per-channel phases at (segment start
        # - H - kp1), the zero resampler history folded in.
        def phases(p: rx_mod.ChannelParams):
            k = p.nco_k
            k_seg = nco.advance(k, 0, seg)
            k_h = nco.advance(k, 0, H)
            p0 = _shifted_phase(k, k_seg, k_h, s)
            return nco.advance((nco.DENOM - k) % nco.DENOM, p0, kp1)

        p0m = jax.vmap(phases)(params)
        w_rx = jnp.asarray(video_bank)[params.video_row]
        bb = resample.mixed_resample_bank(
            xe, jnp.zeros(kp1, jnp.complex64), w_rx, params.nco_k, p0m,
            up=design.up, down=design.down)

        def one_channel(bb_i, p: rx_mod.ChannelParams):
            bk = p.demod.bfo_k
            bk_seg = nco.advance(bk, 0, aseg)
            bk_h = nco.advance(bk, 0, ahalo)
            b0 = _shifted_phase(bk, bk_seg, bk_h, s)
            dst = demod_ops.init_state(design.demod)._replace(
                bfo_phase=b0)
            audio, _ = demod_ops.demod_block(
                bb_i, dst, p.demod, design.demod, carrier_taps,
                pilot_taps)
            return cplx.pack(audio[out_halo:])          # drop warm-up

        return jax.vmap(one_channel)(bb, params)        # (C_local, aseg)

    in_specs = (P("stream"), jax.tree.map(
        lambda _: P("ch") if has_ch else P(), bank.params))
    out_specs = P("ch", "stream") if has_ch else P(None, "stream")
    sharded = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs, check_vma=False)
    return jax.jit(sharded), H


def make_streaming_processor(bank: rx_mod.ReceiverBank, mesh: Mesh,
                             seg: int, halo: int | None = None,
                             audio_wire: str | None = None,
                             emit_bb: bool | None = None):
    """State-continuous repeated-call form of the sharded processor.

    Where make_stream_processor is one-shot (every call re-warms from a
    zero halo, so repeated-block streaming is cold at shard 0 every
    call), this carries the real cross-call state:

      * the RF tail of the previous super-block becomes shard 0's left
        halo (shards s>0 still fetch theirs from the left neighbor over
        ppermute) — FIR/resampler histories are then EXACT everywhere
        after the very first call, and the recurrence warm-up sees real
        signal;
      * per-channel NCO/BFO phase bases advance across calls, so LO and
        beat phases are continuous over arbitrarily long streams (and
        across retunes, matching the serial bank's phase behavior);
      * the full per-channel demod recurrence state (AGC envelope,
        squelch latch + envelopes, auto-mute hold, DC blocker,
        de-emphasis) from the LAST stream shard seeds every shard's next
        call. The halo re-settles the fast recurrences regardless; the
        carried state is what makes the SLOW/latched ones (AGC tau ~1 s,
        the squelch gate latch, the 0.25 s mute hold — all longer than
        any affordable halo) continuous across calls instead of
        re-converging from cold every super-block. Within a super-block
        shard s still runs from state that is s segments stale — the one
        remaining stream-parallel approximation, bounded by the tests'
        AGC-on SNR floor (SURVEY §2.10 row 4).

    The audio wire (i16/i8, ops/cplx.quantize_audio_wire) is applied
    INSIDE each shard, so the device->host return ships the small ints
    from the sharded path too; with emit_bb the per-channel baseband is
    returned alongside (f32) for the RTTY tap.

    Returns (process, halo) with
      process(x, params, tail_prev, nco_base, bfo_base, dstate)
        -> (audio, new_nco_base, new_bfo_base, new_tail, new_dstate, bb)
    x: float32 (S*seg, 2) packed, sharded P('stream');
    tail_prev: float32 (halo, 2) replicated (zeros on the first call);
    nco_base/bfo_base: int32 (n_rx,) phase bases (zeros initially);
    dstate: packed DemodState pytree, leaves leading axis n_rx (seed
    with bank.state.ch.demod); audio: (n_rx, S*aseg, 2) in the wire
    dtype; bb: (n_rx, S*aseg, 2) float32 or None.
    """
    design = bank.design
    d, u = design.down, design.up
    assert seg % d == 0, (seg, d)
    want = default_halo(design) if halo is None else halo
    H = min(want, seg)
    if seg < want:
        import warnings
        seg_ms = seg / design.fs_in * 1e3
        want_ms = want / design.fs_in * 1e3
        warnings.warn(
            f"stream segment ({seg} samples, {seg_ms:.0f} ms) is "
            f"shorter than the recurrence-settle halo ({want_ms:.0f} "
            "ms): AGC/DC/squelch state will only partially re-settle "
            "per call — use a larger --block", stacklevel=3)
    assert H % d == 0
    n_stream = mesh.shape["stream"]
    has_ch = "ch" in mesh.shape and mesh.shape["ch"] > 1
    video_bank = bank.video_bank
    carrier_taps, pilot_taps = bank.carrier_taps, bank.pilot_taps
    out_halo = H * u // d
    aseg, ahalo = seg * u // d, out_halo
    wire = bank.audio_wire if audio_wire is None else audio_wire
    if emit_bb is None:
        emit_bb = bank.emit_baseband
    _, dmask = cplx.pack_tree(demod_ops.init_state(design.demod))

    def shard_fn(x_local, params, tail_prev, nco_base, bfo_base,
                 dstate_p):
        # int8/int16 wire blocks dequantize on device BEFORE the halo
        # exchange, so the carried tail and ppermute traffic stay f32
        # (the jit specializes on the wire dtype)
        x_local = cplx.dequantize(x_local)
        tail = x_local[-H:]
        perm = [(i, i + 1) for i in range(n_stream - 1)]
        left = jax.lax.ppermute(tail, "stream", perm)
        s = jax.lax.axis_index("stream")
        # shard 0's halo is the PREVIOUS super-block's tail, not zeros
        left = jnp.where(s == 0, tail_prev, left)
        xe = cplx.unpack(jnp.concatenate([left, x_local]))
        kp1 = resample.history_len(design.video_taps, u)

        # fused bank-level mix+resample (ops/resample.mixed_resample_bank
        # — the serial bank's path) with analytic per-channel phases
        def phases(p: rx_mod.ChannelParams, nb):
            k = p.nco_k
            k_seg = nco.advance(k, 0, seg)
            k_h = nco.advance(k, 0, H)
            # advance(k_seg, 0, s) = (k_seg*s) mod DENOM without int32
            # overflow at large shard counts (nco.py discipline)
            p0 = (nb + nco.advance(k_seg, jnp.int32(0), s) - k_h
                  + nco.DENOM) % nco.DENOM
            return nco.advance((nco.DENOM - k) % nco.DENOM, p0, kp1)

        p0m = jax.vmap(phases)(params, nco_base)
        w_rx = jnp.asarray(video_bank)[params.video_row]
        bb_all = resample.mixed_resample_bank(
            xe, jnp.zeros(kp1, jnp.complex64), w_rx, params.nco_k, p0m,
            up=u, down=design.down)

        def one_channel(bb_in, p: rx_mod.ChannelParams, bb, dstp):
            bk = p.demod.bfo_k
            bk_seg = nco.advance(bk, 0, aseg)
            bk_h = nco.advance(bk, 0, ahalo)
            b0 = (bb + nco.advance(bk_seg, jnp.int32(0), s) - bk_h
                  + nco.DENOM) % nco.DENOM
            dprev = cplx.unpack_tree(dstp, dmask)
            audio, new_d = demod_ops.demod_block(
                bb_in, dprev._replace(bfo_phase=b0), p.demod,
                design.demod, carrier_taps, pilot_taps)
            new_dp, _ = cplx.pack_tree(new_d)
            outs = (cplx.pack(audio[out_halo:]), new_dp)
            if emit_bb:
                outs += (cplx.pack(bb_in[out_halo:]),)
            return outs

        res = jax.vmap(one_channel)(bb_all, params, bfo_base, dstate_p)
        audio = cplx.quantize_audio_wire(res[0], wire)
        # each shard emits its final demod state with a unit stream axis;
        # the caller keeps the LAST shard's (end of the super-block)
        state_out = jax.tree.map(lambda leaf: leaf[None], res[1])
        if emit_bb:
            return audio, state_out, res[2]
        return audio, state_out

    ch_or_rep = (lambda: P("ch")) if has_ch else (lambda: P())
    dstate_spec = jax.tree.map(lambda _: ch_or_rep(), dmask)
    in_specs = (P("stream"),
                jax.tree.map(lambda _: ch_or_rep(), bank.params),
                P(), ch_or_rep(), ch_or_rep(), dstate_spec)
    audio_spec = P("ch", "stream") if has_ch else P(None, "stream")
    state_spec = jax.tree.map(
        lambda _: P("stream", "ch") if has_ch else P("stream"), dmask)
    out_specs = (audio_spec, state_spec) + \
        ((audio_spec,) if emit_bb else ())
    sharded = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs, check_vma=False)

    total_in = n_stream * seg
    total_out = n_stream * aseg

    def proc_impl(x, params, tail_prev, nco_base, bfo_base, dstate):
        res = sharded(x, params, tail_prev, nco_base, bfo_base, dstate)
        audio, state_all = res[0], res[1]
        bb_out = res[2] if emit_bb else None
        new_dstate = jax.tree.map(lambda leaf: leaf[-1], state_all)
        # cross-call state advances: pure elementwise, outside shard_map
        new_nb = nco.advance(params.nco_k, nco_base, total_in)
        new_bb = nco.advance(params.demod.bfo_k, bfo_base, total_out)
        return (audio, new_nb, new_bb, cplx.dequantize(x[-H:]),
                new_dstate, bb_out)

    return jax.jit(proc_impl), H


def process_stream(bank: rx_mod.ReceiverBank, x, mesh: Mesh,
                   halo: int | None = None):
    """Convenience one-shot: shard a long IQ array over the mesh's stream
    axis and process it. len(x) must divide evenly into stream shards with
    segments that are multiples of DOWN."""
    import numpy as np
    n_stream = mesh.shape["stream"]
    assert x.shape[0] % n_stream == 0
    seg = x.shape[0] // n_stream
    proc, H = make_stream_processor(bank, mesh, seg, halo)
    if jnp.iscomplexobj(x):
        x = jnp.asarray(cplx.pack(np.asarray(x)))
    audio_p = proc(x, bank.params)
    return cplx.unpack(np.asarray(audio_p))
