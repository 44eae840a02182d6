"""The streaming executive: source -> device -> ReceiverBank -> sinks.

Equivalent of the reference `SDR_EXECUTIVE.Run` hot loop (reference
receiver.py:684-782): per block it (1) reads an IQ chunk from the source,
(2) applies pending mode/freq changes at the block boundary
(mode_freq_change, receiver.py:633-680), (3) runs the demod bank,
(4) routes audio to sinks (audio_out, receiver.py:153-225), (5) taps
PSDs and recordings (receiver.py:747-761). Differences by design:

  * the DSP is one jitted device step, so the "loop" is a thin host
    pipeline: host reads block k+1 and converts it while the device
    computes block k (JAX async dispatch gives the overlap for free);
  * control mutations arrive through a thread-safe command queue and are
    applied between blocks as pure params swaps (no recompiles);
  * back-pressure: in realtime mode the loop paces to the audio clock and
    the watchdog keeps sink rings inside the watermarks; in throughput
    mode it free-runs (bench).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np

from pysdr_tpu.ops import cplx
from pysdr_tpu.runtime.profiler import BlockProfiler
from pysdr_tpu.runtime.ringbuffer import RingBuffer


class Executive:
    def __init__(self, bank, source, audio_rings=None, realtime=False,
                 raw_writer=None, demod_writer=None,
                 psd_callback: Callable | None = None, loop_source=True,
                 wire: str = "f32", pipeline_depth: int = 2,
                 want_bb: bool = True, prefetch: bool = True):
        """bank: models.receiver.ReceiverBank; source: DatReader/SynthSource
        (anything with read_data(n)); audio_rings: list of RingBuffer per
        channel (created if None); raw/demod_writer: io.datfile.DatWriter
        taps (reference -save_iq/-save_demod, params.py:136-141);
        wire: "f32" | "i16" | "i8" — RF blocks cross the host->device link
        as raw CS16/CS8 sample pairs at 1/2 / 1/4 the bytes, dequantized
        on device inside the step jit (cplx.dequantize). i16 is lossless
        for any real SDR front-end (14-bit SDRplay, 8-bit RTL).
        pipeline_depth: device blocks kept in flight before draining the
        oldest. Depth 1 is the classic double-buffer; a deeper pipeline
        lets upload k+1 / compute k / download k-1 all queue
        concurrently. Adds depth-1 blocks of audio latency — the
        realtime watchdog budget absorbs 1-2."""
        import jax.numpy as jnp
        self._jnp = jnp
        self.bank = bank
        self.source = source
        self.realtime = realtime
        self.loop_source = loop_source
        assert wire in ("f32", "i16", "i8"), wire
        self.wire = wire
        self.pipeline_depth = max(1, int(pipeline_depth))
        # whether ANY consumer (RTTY, BB display, --save-baseband) will
        # pull the carried baseband. When False the early
        # copy_to_host_async on the bb is skipped: it would be
        # device->host traffic (n_rx * out_block * 2 * 4 B/block) that
        # nobody reads.
        self.want_bb = want_bb
        # source prefetch thread: the host half of the read stage
        # (file/synth read, wire quantization, device_put issue) is pure
        # host work that otherwise runs SERIALLY inside the hot loop. A
        # depth-2 bounded read-ahead hides it behind the device step.
        # Recording taps and last_rf_block stay on the executive thread
        # at dispatch time, so block-boundary record semantics are
        # unchanged.
        self.prefetch = prefetch
        self._pf_q: queue.Queue | None = None
        self._pf_thread: threading.Thread | None = None
        self._pf_error: BaseException | None = None
        d = bank.design
        ring_size = 32 * 1024 * max(1, int(d.fs_out / 48e3))  # params.py:456
        self.audio_rings = audio_rings or [
            RingBuffer(f"audio{i}", ring_size, "complex64")
            for i in range(bank.n_rx)]
        self.raw_writer = raw_writer
        self.demod_writer = demod_writer
        self.psd_callback = psd_callback
        self.profiler = BlockProfiler(d.in_block, d.fs_in)
        self._cmd_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # prefetch reads only while a run() is active: a bounded
        # run(n_blocks=N) that returns without stop() must not leave the
        # reader eating source blocks past N and spinning on a full queue
        self._pf_active = threading.Event()
        self.n_blocks = 0
        self.last_rf_block: np.ndarray | None = None
        # baseband (device array) matching the block being DRAINED: with
        # a depth-D pipeline, bank._last_bb is D blocks ahead of the
        # audio handed to psd_callback, so the bb is carried through the
        # pipeline alongside its audio and exposed here for consumers
        # (the RTTY tap and the BB display read this, not bank._last_bb)
        self.drained_bb = None
        # per-stage accounting (ms totals; report with stage_report()):
        # read = host source + quantize, upload = host->device issue,
        # dispatch = device step issue, drain = result pull + sinks
        self.stage_ms = {"read": 0.0, "upload": 0.0, "dispatch": 0.0,
                         "drain": 0.0}

    def stage_report(self) -> dict:
        """Mean ms/block per pipeline stage (the per-stage breakdown the
        end-to-end bench publishes)."""
        n = max(1, self.n_blocks)
        return {k: v / n for k, v in self.stage_ms.items()}

    # ---- control plane: thread-safe, applied at block boundaries ----
    # (the service_commands RPC surface, reference receiver.py:301-399)

    def post(self, method, *args):
        """Queue a block-boundary mutation: either a bank method name
        (the service_commands RPC surface) or a CALLABLE applied to the
        executive itself (runtime mutations like the mid-run recording
        toggles, reference gui.py:1184-1219)."""
        self._cmd_q.put((method, args))

    def _apply_pending(self):
        while True:
            try:
                method, args = self._cmd_q.get_nowait()
            except queue.Empty:
                return
            try:
                if callable(method):
                    method(self, *args)
                else:
                    getattr(self.bank, method)(*args)
            except Exception:  # noqa: BLE001 — one bad control command
                # (out-of-range rx from an HTTP request, a typo'd hop
                # entry) must not kill the DSP/audio thread
                import sys
                import traceback
                print(f"executive: control command {method!r}{args!r} "
                      f"failed:\n{traceback.format_exc(limit=3)}",
                      file=sys.stderr, flush=True)

    # ---- the hot loop ----

    def run(self, n_blocks: int | None = None, duration_s: float | None = None):
        jnp = self._jnp
        d = self.bank.design
        deadline = time.monotonic() + duration_s if duration_s else None
        block_budget = d.in_block / d.fs_in

        def read_host_raw():
            """Host half of the source stage: (packed float32 (n, 2),
            complex64 view) or None at stream end. NO side effects —
            safe on the prefetch thread."""
            # fast path: sources that yield float32 (n, 2) packed pairs
            # directly (the C++ NativeStreamer) skip all host complex math
            if hasattr(self.source, "read_packed"):
                xp = self.source.read_packed(d.in_block)
                if len(xp) < d.in_block:
                    return None
                return xp, xp.view(np.complex64).reshape(-1)
            x = self.source.read_data(d.in_block, loop=self.loop_source) \
                if self.loop_source else self.source.read_data(d.in_block)
            x = np.asarray(x).reshape(-1)[:d.in_block]
            if len(x) < d.in_block:
                return None
            x = x.astype(np.complex64)
            return cplx.pack(x), x

        def prepare(pair):
            """Wire quantization + host->device issue for a read pair."""
            if pair is None:
                return None
            t1 = time.perf_counter()
            xb = jnp.asarray(cplx.quantize_host(pair[0], self.wire))
            self.stage_ms["upload"] += (time.perf_counter() - t1) * 1e3
            return xb, pair[1]

        def pf_loop():
            # NOTE on stage_ms: each key has exactly one writer thread
            # (read/upload here when prefetch is on, dispatch/drain on
            # the executive thread), so the += updates never race;
            # stage_report() readers may see a mid-block value, which
            # is fine for a diagnostic.
            while not self._stop.is_set():
                if not self._pf_active.wait(timeout=0.2):
                    continue           # paused between run() calls
                t0 = time.perf_counter()
                try:
                    pair = read_host_raw()
                    self.stage_ms["read"] += \
                        (time.perf_counter() - t0) * 1e3
                    item = prepare(pair)
                except BaseException as e:  # noqa: BLE001 — a source
                    # error (rtl_tcp timeout, disk I/O) must surface in
                    # the executive loop, not die silently here and
                    # leave read_block blocked on the queue forever
                    self._pf_error = e
                    item = None
                while not self._stop.is_set():
                    try:
                        self._pf_q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if item is None:
                    return                         # stream end / error

        def read_block():
            """Next (device_block, host complex64) — from the prefetch
            thread when enabled, inline otherwise. Recording taps and
            the RF display tap run HERE (executive thread, dispatch
            order) either way."""
            if self.prefetch:
                if self._pf_q is None:
                    self._pf_q = queue.Queue(maxsize=2)
                if (self._pf_thread is None
                        or not self._pf_thread.is_alive()) \
                        and self._pf_q.empty():
                    # first run, or a consumed EOF: (re)start the reader
                    self._pf_error = None
                    self._pf_thread = threading.Thread(
                        target=pf_loop, daemon=True)
                    self._pf_thread.start()
                while True:
                    try:
                        item = self._pf_q.get(timeout=1.0)
                        break
                    except queue.Empty:
                        if self._stop.is_set():
                            return None
                        if not self._pf_thread.is_alive():
                            item = None      # died without a sentinel
                            break
                if item is None and self._pf_error is not None:
                    err, self._pf_error = self._pf_error, None
                    raise err                # loud, like the inline path
            else:
                t0 = time.perf_counter()
                pair = read_host_raw()
                self.stage_ms["read"] += (time.perf_counter() - t0) * 1e3
                item = prepare(pair)
            if item is None:
                return None
            xb, x = item
            if self.raw_writer is not None:
                self.raw_writer.save_data(x)
            # RF tap for PSD/display consumers (reference rb_rf push,
            # receiver.py:747-756)
            self.last_rf_block = x
            return xb

        # realtime pacing: an ABSOLUTE schedule (next_deadline advances by
        # exactly one budget per completed block), not per-block elapsed —
        # with the software pipeline below, block k's sleep runs an
        # iteration after its t_start, so an elapsed-based sleep would
        # double-count the previous block's sleep and run the source at
        # ~2x real time (ADVICE r2 #1). Debt is clamped to one budget so a
        # slow start doesn't trigger a long full-speed catch-up burst.
        next_deadline = None

        def finish(entry):
            nonlocal next_deadline
            audio_p, self.drained_bb = entry
            # sync point: device -> host pull of an ALREADY-dispatched
            # block; with the one-block pipeline below the compute had a
            # whole iteration to complete, so this pays transfer only
            t0 = time.perf_counter()
            audio = cplx.unpack(cplx.dequantize_audio_host(
                np.asarray(audio_p)).reshape(
                self.bank.n_rx, d.out_block, 2))
            self.stage_ms["drain"] += (time.perf_counter() - t0) * 1e3
            for i, ring in enumerate(self.audio_rings):
                ring.push(audio[i])
            if self.demod_writer is not None:
                self.demod_writer.save_data(audio.T)
            if self.psd_callback is not None:
                self.psd_callback(self, audio)
            self.n_blocks += 1
            if self.realtime:
                now = time.monotonic()
                if next_deadline is None:
                    next_deadline = now
                next_deadline += block_budget
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                    # pacing sleep is idle time, not compute: keep it out
                    # of the profiled block so realtime_factor reports
                    # actual headroom (ADVICE r2 #3)
                    self.profiler.discount(next_deadline - now)
                else:
                    next_deadline = max(next_deadline, now - block_budget)

        # software pipeline, depth D: while the device computes block k,
        # the host reads block k+1 AND drains block k-D to the sinks (the
        # reference's thread/ring-buffer decoupling, SURVEY §2.10 row 2,
        # without threads — JAX async dispatch holds the in-flight
        # blocks). Depth > 1 keeps several blocks' uploads/computes/
        # downloads queued concurrently.
        from collections import deque
        self._pf_active.set()
        try:
            nxt = read_block()
            pending: deque = deque()     # device audio buffers in flight
            depth = self.pipeline_depth
            while not self._stop.is_set():
                if nxt is None:
                    break
                # n_blocks is cumulative across run() calls (self.n_blocks
                # counts completed blocks; more may be in flight)
                if n_blocks is not None and \
                        self.n_blocks + len(pending) >= n_blocks:
                    break
                if deadline and time.monotonic() > deadline:
                    break
                self._apply_pending()
                with self.profiler:
                    t0 = time.perf_counter()
                    audio_p = self.bank.step_device(nxt)   # async dispatch
                    # enqueue the device->host copy NOW, so the later
                    # np.asarray picks up a landed buffer instead of
                    # starting the copy then
                    try:
                        audio_p.copy_to_host_async()
                    except AttributeError:
                        pass
                    self.stage_ms["dispatch"] += \
                        (time.perf_counter() - t0) * 1e3
                    nxt = read_block()                 # overlap host read
                    bb_p = getattr(self.bank, "_last_bb", None)
                    if bb_p is not None and self.want_bb:
                        try:      # same early-copy rationale as the audio
                            bb_p.copy_to_host_async()
                        except AttributeError:
                            pass
                    pending.append((audio_p, bb_p))
                    if len(pending) > depth:
                        finish(pending.popleft())      # drain block k-D
            while pending:
                finish(pending.popleft())
            return self.profiler
        finally:
            self._pf_active.clear()

    def stop(self):
        """Stop the loop and join the prefetch reader, so no reader thread
        is left inside the source or the runtime when the process
        exits."""
        self._stop.set()
        t = self._pf_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def run_in_thread(self, **kw) -> threading.Thread:
        t = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        t.start()
        return t
