"""Run pysdr_tpu end to end on an NVIDIA GPU and check what comes out.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh runs and the
                                   # one-card runs they are compared with
    python chip_smoke.py --cpu-rehearsal   # toy sizes on the CPU, to
                                   # check the plumbing; prints no result

Phases, all in this one process (a JAX process reserves most of the
card's memory, so a second JAX process would fail for want of it):

  device  JAX must report platform "gpu"; prints device_kind, the device
          count and nvidia-smi's name and power limit.
  bank4   4 receivers (AM/NFM/USB/CW) over 8 MHz with 24576-sample audio
          blocks (4,096,000 RF samples each), built by `App` from CLI
          argv and driven through `Executive.run`: once on the synthetic
          source; once replaying a seeded CS8 .dat capture on the i8 RF
          wire with the i16 audio wire (C++ streamer, prefetch thread,
          on-device dequantize). Each receiver's audio (the WAV on the
          synthetic run; every delivered block on the free-running
          replay, which outpaces the WAV players) must carry its tone
          TONE_FLOOR_DB over the spectral floor.
  chan64  `--channelize 64` over 12.288 MHz on the i8 RF and mu-law i8
          audio wires: every channel with a synthetic station carries
          its tone TONE_FLOOR_DB over the floor, and no stationless
          channel carries a station tone.
  parity  (a) the bank4 and chan64 steps at full width on the GPU
          against the same step on the CPU under HIGHEST matmul
          precision; (b) the bank at the golden configurations on the
          GPU against the independent SciPy chain (tests/golden.py), held
          to the CPU suite's bounds.

Times and rates are printed for information; nothing here is a
benchmark. Any failed check raises, and the script then exits non-zero
without its last line, which is otherwise
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tone peak over the median spectral bin of the audio. The healthy chain
# sits far above it (quantization and AGC noise only); a precision or
# quantization fault that smears the audio falls below it.
TONE_FLOOR_DB = 60.0
# A stationless channel is quiet when no station tone stands more than
# this far over the median of its audio band (100 Hz to 4 kHz, inside
# the AM filter). AGC levels every channel, so only relative levels mean
# anything: a station channel's own tone stands ~40 dB or more over that
# in-band floor, while a neighbour leaking through the 70 dB prototype
# stopband lands below the channel's noise.
QUIET_DB = 20.0
QUIET_BAND_HZ = (100.0, 4000.0)
# GPU step against the CPU step at HIGHEST precision. Both run float32;
# what differs is summation order and the transcendental functions'
# last bits, which cost ~1e-6 relative (~120 dB) per operation and
# grow through AGC gain and the discriminator. A loss of operand
# precision (TF32 or bf16 operands: 10 or 7 mantissa bits) shows as an
# error near -60 dB or worse, so the bound sits there.
CPU_PARITY_DB = 60.0
# --mesh 1,4 (pure channel sharding) against one card on the same input:
# the sharded streaming processors re-run a halo of settled history each
# call, which leaves recurrence state a little different from the serial
# step; tests/test_sharded_streaming.py bounds it at 2% peak error with
# AGC off, about 34 dB, and this run has AGC on.
MESH_CH_DB = 30.0
# --mesh 2,2 (stream x channel): the shard boundary's AGC state is stale
# by design (DESIGN.md §4); tests/test_sharded_streaming.py holds the
# AGC-on fit at 30 dB after a 1 s settle.
MESH_STREAM_DB = 30.0
MESH_STREAM_SETTLE_S = 1.0

FULL = {
    "bank4": ["--fs", "8.0", "--block", "24576",
              "--fc", "100.0", "100.5", "101.0", "101.5",
              "--modes", "AM", "NFM", "USB", "CW"],
    # 16 AM stations (every 4th channel): -26 dB of RF gain keeps their
    # sum inside the i8 wire's full scale, and the synthetic noise,
    # 0.004 rms (half an LSB) after the gain, dithers the 8-bit
    # quantization, whose error would otherwise carry the stations' AM
    # into every channel
    "chan64": ["--channelize", "64", "--fs", "12.288", "--block", "12288",
               "--fc", "100.0", "--wire", "i8", "--audio-wire", "i8",
               "--rf-gain", "-26", "--synth-noise", "0.08"],
    "blocks": {"bank4": 16, "replay": 32, "chan64": 16, "parity": 4,
               "mesh_bank4": 16, "mesh_chan64": 16},
}
SMALL = {
    "bank4": ["--fs", "0.512", "--block", "2048",
              "--fc", "100.0", "100.05", "100.1", "100.15",
              "--modes", "AM", "NFM", "USB", "CW"],
    "chan64": ["--channelize", "8", "--fs", "0.768", "--block", "2048",
               "--fc", "100.0", "--wire", "i8", "--audio-wire", "i8",
               "--rf-gain", "-20", "--synth-noise", "0.04"],
    "blocks": {"bank4": 16, "replay": 16, "chan64": 16, "parity": 3,
               "mesh_bank4": 64, "mesh_chan64": 12},
}


# ---------------------------------------------------------------- checks

def check_device() -> dict:
    """The default JAX backend must be a GPU; no fallback to the CPU."""
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, but JAX's default "
                         f"backend is {d.platform!r} ({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """(rate, left channel as float64 in [-1, 1])."""
    with wave.open(path) as w:
        fs = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        pcm = pcm.reshape(-1, w.getnchannels())[:, 0]
    return fs, pcm.astype(np.float64) / 32767.0


def _spectrum(x: np.ndarray, fs: float):
    x = np.asarray(x, np.float64)
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.fft.rfftfreq(len(x), 1.0 / fs), sp


def tone_over_floor(x: np.ndarray, fs: float) -> tuple[float, float]:
    """(frequency of the strongest tone, its peak over the median bin in
    dB); the first 5 bins (DC) are ignored."""
    f, sp = _spectrum(x, fs)
    pk = 5 + int(np.argmax(sp[5:]))
    floor = max(float(np.median(sp[5:])), 1e-30)
    return float(f[pk]), 20.0 * np.log10(sp[pk] / floor)


def check_tone(label: str, x: np.ndarray, fs: float, f_hz: float,
               tol_hz: float = 5.0) -> float:
    peak, db = tone_over_floor(x, fs)
    print(f"{label}: tone {peak:.1f} Hz (expect {f_hz:.1f}) "
          f"{db:.1f} dB over floor (bound {TONE_FLOOR_DB})", flush=True)
    if abs(peak - f_hz) > tol_hz or not db >= TONE_FLOOR_DB:
        raise AssertionError(f"{label}: tone {peak:.1f} Hz at {db:.1f} dB,"
                             f" expected {f_hz:.1f} Hz >= {TONE_FLOOR_DB}")
    return db


def level_over_band(x: np.ndarray, fs: float, freqs, band,
                    tol_hz: float = 2.0) -> float:
    """Highest spectral bin within tol_hz of any of freqs, over the
    median bin of the band (lo, hi) Hz, in dB."""
    f, sp = _spectrum(x, fs)
    near = np.zeros(len(f), bool)
    for ft in freqs:
        near |= np.abs(f - ft) <= tol_hz
    inband = (f >= band[0]) & (f <= band[1])
    floor = max(float(np.median(sp[inband])), 1e-30)
    return 20.0 * np.log10(max(float(sp[near].max()), 1e-30) / floor)


def golden():
    """tests/golden.py, loaded by path (a module named `tests` elsewhere on
    sys.path must not shadow it)."""
    import importlib.util
    mod = sys.modules.get("pysdr_golden")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "pysdr_golden", os.path.join(ROOT, "tests", "golden.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["pysdr_golden"] = mod
        spec.loader.exec_module(mod)
    return mod


def fit_snr_db(ref: np.ndarray, test: np.ndarray, max_lag: int = 16
               ) -> float:
    """SNR of test against ref after the golden suite's optimal scalar +
    lag fit (tests/golden.py), on the second half."""
    return float(golden()._best_fit_snr_db(np.asarray(ref, np.float64),
                                  np.asarray(test, np.float64),
                                  max_lag=max_lag))


def expected_tones(modes) -> list[float]:
    """Audio tone of receiver i on the app's synthetic source (and the
    replay capture written below): 400*(i+1) Hz, except CW, whose
    keyed carrier beats at the BFO."""
    from pysdr_tpu import tables
    return [tables.CW_BFO_HZ if m == "CW" else 400.0 * (i + 1)
            for i, m in enumerate(modes)]


# ------------------------------------------------------------- the runs

class CompileClock:
    """Backend compile seconds and persistent-cache hits, from JAX's
    monitoring events."""

    def __init__(self):
        import jax
        self.secs, self.count, self.hits = 0.0, 0, 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration_secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.secs += duration_secs
            self.count += 1

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def snapshot(self):
        return self.secs, self.count, self.hits


CLOCK: CompileClock | None = None


def run_app(label: str, argv: list[str], n_blocks: int):
    """Build App from CLI argv, run n_blocks through Executive.run with
    the app's own services (WAV players etc.), and collect every audio
    block the executive delivers. Returns (app, audio (n_rx, n) complex,
    info dict); prints compile time and the steady rate."""
    from pysdr_tpu import app as app_mod
    args = app_mod.build_parser().parse_args(argv)
    a = app_mod.App(args)
    blocks, stamps = [], []
    inner = a.ex.psd_callback

    def tap(ex, audio):
        stamps.append(time.perf_counter())
        blocks.append(np.array(audio))
        if inner is not None:
            inner(ex, audio)

    a.ex.psd_callback = tap
    c0 = CLOCK.snapshot()
    a.start_services()
    t0 = time.perf_counter()
    try:
        a.ex.run(n_blocks=n_blocks)
    finally:
        a.stop_services()
    c1 = CLOCK.snapshot()
    d = a.bank.design
    if a.ex.n_blocks != n_blocks:
        raise AssertionError(f"{label}: ran {a.ex.n_blocks} of "
                             f"{n_blocks} blocks")
    w = n_blocks // 3
    steady_s = stamps[-1] - stamps[w]
    bps = (n_blocks - 1 - w) / steady_s
    info = {"first_audio_s": stamps[0] - t0,
            "compile_s": c1[0] - c0[0], "compiles": c1[1] - c0[1],
            "cache_hits": c1[2] - c0[2],
            "blocks_per_s": bps, "msamp_per_s": bps * d.in_block / 1e6,
            "overflows": sum(r.overflows for r in a.ex.audio_rings),
            "source": type(a.source).__name__}
    print(f"{label}: {n_blocks} blocks of {d.in_block} RF samples, "
          f"{a.bank.n_rx} ch; compile {info['compile_s']:.1f} s "
          f"({info['compiles']} executables, {info['cache_hits']} cache "
          f"hits); first audio after {info['first_audio_s']:.1f} s; "
          f"steady {bps:.2f} blocks/s = {info['msamp_per_s']:.1f} Msamp/s"
          f" (information only); source {info['source']}; ring "
          f"overflows {info['overflows']}", flush=True)
    return a, np.concatenate(blocks, axis=1), info


def write_capture(path: str, x: np.ndarray, fs: float, fc: float):
    """Write complex samples as a CS8 .dat capture (full scale 1.0)."""
    from pysdr_tpu.io import datfile
    w = datfile.DatWriter(path, fs=fs, fc=fc, dtype="int8")
    w.save_data(x)
    w.close()


def write_replay_capture(path: str, argv: list[str], seconds: float = 1.0,
                         amplitude: float = 0.15, seed: int = 7):
    """A seeded CS8 .dat capture holding the bank's stations (the same
    kinds and tones as the app's synthetic source) at levels whose sum
    stays inside the 8-bit full scale. It is `seconds` long with every
    carrier and tone an integer number of cycles, so the looping replay
    is seamless."""
    from pysdr_tpu import app as app_mod
    from pysdr_tpu.io import synth
    args = app_mod.build_parser().parse_args(argv)
    cfg = app_mod.build_config(args)
    kinds = {"AM": "am", "NFM": "fm", "USB": "usb", "CW": "cw"}
    specs = [synth.SignalSpec(offset_hz=off, mode=kinds[m],
                              amplitude=amplitude, audio_hz=400.0 * (i + 1))
             for i, (off, m) in enumerate(zip(cfg.channel_offsets_hz(),
                                              args.modes))]
    n = int(round(seconds * cfg.fs_in))
    x = synth.render(specs, cfg.fs_in, n, noise_rms=0.002, seed=seed)
    write_capture(path, x, cfg.fs_in, cfg.sdr_center_hz)


def phase_bank4(workdir: str, sz: dict) -> dict:
    out = {}
    argv = sz["bank4"]
    modes = argv[argv.index("--modes") + 1:]
    tones = expected_tones(modes)
    for run, extra, n in (
            ("synth", [], sz["blocks"]["bank4"]),
            ("replay", ["--wire", "i8", "--audio-wire", "i16"],
             sz["blocks"]["replay"])):
        prefix = os.path.join(workdir, f"bank4_{run}")
        if run == "replay":
            cap = os.path.join(workdir, "bank4.dat")
            write_replay_capture(cap, argv)
            extra = ["--replay", cap] + extra
        a, audio, info = run_app(f"bank4 {run}", argv + extra
                                 + ["--wav", prefix], n)
        if run == "replay" and info["source"] != "NativeStreamer":
            raise AssertionError("bank4 replay did not use the C++ "
                                 f"streamer ({info['source']})")
        fs = a.bank.design.fs_out
        ob = a.bank.design.out_block
        dbs = []
        for i, (m, f) in enumerate(zip(modes, tones)):
            if run == "synth":
                # what the WAV sink wrote, from the middle of the stream:
                # past the AGC settle, and before the end of the run,
                # where the executive drains its last in-flight blocks
                # into the rings back to back (the overflows counted
                # above happen there)
                wfs, x = read_wav(f"{prefix}_rx{i}.wav")
                if wfs != int(round(fs)) or len(x) < (n - 3) * ob:
                    raise AssertionError(f"{prefix}_rx{i}.wav: {len(x)} "
                                         f"samples at {wfs} Hz")
                dbs.append(check_tone(f"bank4 {run} rx{i} {m} wav",
                                      x[len(x) // 3:len(x) - 3 * ob], fs,
                                      f))
            else:
                # free-running replay outpaces the WAV players, whose
                # rings then drop audio (counted above), so the check
                # reads every block the executive delivered
                dbs.append(check_tone(f"bank4 {run} rx{i} {m} audio",
                                      audio[i, audio.shape[1] // 3:].real,
                                      fs, f))
        out[run] = dict(info, tone_db=dbs)
    return out


def phase_chan64(sz: dict) -> dict:
    argv = sz["chan64"]
    a, audio, info = run_app("chan64", argv, sz["blocks"]["chan64"])
    n = a.bank.n_ch
    fs = a.bank.design.fs_out
    seg = audio[:, audio.shape[1] // 2:].real
    stations = {c: 300.0 + 50.0 * c for c in range(0, n, 4)}
    dbs, leaks = [], {}
    for c in range(n):
        if c in stations:
            dbs.append(check_tone(f"chan64 ch{c}", seg[c], fs, stations[c]))
        else:
            leaks[c] = level_over_band(seg[c], fs, stations.values(),
                                       QUIET_BAND_HZ)
    worst = max(leaks, key=leaks.get)
    print(f"chan64: {len(stations)} station channels, min tone "
          f"{min(dbs):.1f} dB over floor; {len(leaks)} stationless "
          f"channels, loudest station tone {leaks[worst]:.1f} dB over "
          f"the in-band floor in ch{worst} (bound {QUIET_DB})",
          flush=True)
    if not leaks[worst] < QUIET_DB:
        raise AssertionError(f"chan64: stationless ch{worst} carries a "
                             f"station tone {leaks[worst]:.1f} dB over "
                             "its floor")
    return dict(info, min_tone_db=min(dbs), max_leak_db=leaks[worst])


def _unpack_audio(out, n_ch: int) -> np.ndarray:
    from pysdr_tpu.ops import cplx
    a = out[0] if isinstance(out, tuple) else out
    return cplx.unpack(np.asarray(a).reshape(n_ch, -1, 2))


def step_parity(label: str, bank, blocks, channels) -> list[float]:
    """The bank's jitted step on the default device (GPU) against the same
    step on the CPU under HIGHEST matmul precision, from the same state
    on the same blocks. Returns the fit SNR of each listed channel."""
    import jax
    cpu = jax.devices("cpu")[0]
    s0 = bank.state
    st, gpu = s0, []
    for x in blocks:
        st, out = bank._step(st, jax.numpy.asarray(x), bank.params)
        gpu.append(_unpack_audio(out, bank.n_rx))
    step_cpu = jax.jit(bank._step_impl)
    ref = []
    with jax.default_matmul_precision("highest"):
        st = jax.device_put(s0, cpu)
        params = jax.device_put(bank.params, cpu)
        for x in blocks:
            st, out = step_cpu(st, jax.device_put(x, cpu), params)
            ref.append(_unpack_audio(out, bank.n_rx))
    g, r = np.concatenate(gpu, axis=1), np.concatenate(ref, axis=1)
    snrs = [fit_snr_db(r[c].real, g[c].real) for c in channels]
    print(f"parity {label}: {jax.devices()[0].platform} step vs CPU "
          f"HIGHEST over {len(blocks)} blocks: min fit SNR "
          f"{min(snrs):.1f} dB over {len(channels)} channels (bound "
          f"{CPU_PARITY_DB})", flush=True)
    if not min(snrs) >= CPU_PARITY_DB:
        raise AssertionError(f"parity {label}: {min(snrs):.1f} dB")
    return snrs


def phase_parity(sz: dict) -> dict:
    from pysdr_tpu import app as app_mod
    from pysdr_tpu.models.receiver import ReceiverBank
    from pysdr_tpu.ops import cplx
    out = {}
    k = sz["blocks"]["parity"]
    args = app_mod.build_parser().parse_args(sz["bank4"])
    cfg = app_mod.build_config(args)
    src, _, _ = app_mod.build_source(args, cfg)
    bank = ReceiverBank(cfg)
    blocks = [cplx.pack(src.read_data(bank.design.in_block))
              for _ in range(k)]
    out["bank4_cpu_snr_db"] = step_parity("bank4", bank, blocks,
                                          range(bank.n_rx))
    args = app_mod.build_parser().parse_args(
        sz["chan64"] + ["--audio-wire", "f32"])
    cb, src, _ = app_mod.build_channelizer(args)
    blocks = [cplx.pack(src.read_data(cb.in_block)) for _ in range(k)]
    out["chan64_cpu_snr_db"] = step_parity("chan64", cb, blocks,
                                           range(0, cb.n_ch, 4))
    out["golden_snr_db"] = phase_golden()
    return out


def golden_snrs() -> dict:
    """{case: (SNR dB against the SciPy chain, bound)} for the golden AM,
    NFM and USB+AGC cases, run on the default device."""
    from pysdr_tpu.tables import Mode
    g = golden()
    res = {}
    for mode, agc, bound in g.GOLDEN_CASES:
        if (mode, agc) not in ((Mode.AM, False), (Mode.NFM, False),
                               (Mode.USB, True)):
            continue
        x = g._capture(mode, np.random.default_rng(12345))
        audio, up, down = g._bank_chain(x, mode, agc)
        snr = float(g._best_fit_snr_db(
            g._golden_chain(x, mode, up, down, agc), audio))
        res[f"{mode.name}{'+AGC' if agc else ''}"] = (snr, bound)
    return res


def phase_golden() -> dict:
    res = golden_snrs()
    for name, (snr, bound) in res.items():
        print(f"golden {name}: {snr:.1f} dB vs the SciPy chain (bound "
              f"{bound})", flush=True)
        if not snr >= bound:
            raise AssertionError(f"golden {name}: {snr:.1f} < {bound} dB")
    return {name: snr for name, (snr, _) in res.items()}


def _mesh_compare(label, ref, test, channels, fs, bound, settle_s=0.0):
    n = min(ref.shape[1], test.shape[1])
    lo = int(settle_s * fs)
    snrs = [fit_snr_db(ref[c, lo:n].real, test[c, lo:n].real)
            for c in channels]
    print(f"{label}: min fit SNR {min(snrs):.1f} dB against one card over "
          f"{len(channels)} channels (bound {bound})", flush=True)
    if not min(snrs) >= bound:
        raise AssertionError(f"{label}: {min(snrs):.1f} < {bound} dB")
    return snrs


def phase_four(workdir: str, sz: dict) -> dict:
    """One card against --mesh 1,4 for bank4 and chan64, then bank4 on a
    2x2 stream x channel mesh. Every run replays the same seeded CS8
    capture (the host synthesizer would set the pace otherwise)."""
    import jax
    from pysdr_tpu import app as app_mod
    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 devices, JAX has "
                             f"{len(jax.devices())}")
    out = {}
    nb, nc = sz["blocks"]["mesh_bank4"], sz["blocks"]["mesh_chan64"]
    cap64 = os.path.join(workdir, "chan64.dat")
    cb, src, cfg = app_mod.build_channelizer(
        app_mod.build_parser().parse_args(sz["chan64"]))
    write_capture(cap64, src.read_data(int(cfg.fs_in)), cfg.fs_in,
                  cfg.fc_hz)
    argv = sz["chan64"] + ["--replay", cap64]
    a, one, _ = run_app("chan64 one card", argv, nc)
    _, four, info = run_app("chan64 --mesh 1,4", argv + ["--mesh", "1,4"],
                            nc)
    fs = a.bank.design.fs_out
    out["chan64_1x4"] = dict(info, snr_db=_mesh_compare(
        "chan64 --mesh 1,4", one, four, range(0, a.bank.n_ch, 4), fs,
        MESH_CH_DB))
    cap4 = os.path.join(workdir, "bank4.dat")
    write_replay_capture(cap4, sz["bank4"])
    argv = sz["bank4"] + ["--replay", cap4, "--wire", "i8"]
    a, one, _ = run_app("bank4 one card", argv, nb)
    fs = a.bank.design.fs_out
    _, four, info = run_app("bank4 --mesh 1,4", argv + ["--mesh", "1,4"],
                            nb)
    out["bank4_1x4"] = dict(info, snr_db=_mesh_compare(
        "bank4 --mesh 1,4", one, four, range(4), fs, MESH_CH_DB))
    # a 2x2 super-block holds two blocks: half the executive blocks
    _, two, info = run_app("bank4 --mesh 2,2", argv + ["--mesh", "2,2"],
                           nb // 2)
    out["bank4_2x2"] = dict(info, snr_db=_mesh_compare(
        "bank4 --mesh 2,2", one, two, range(4), fs, MESH_STREAM_DB,
        settle_s=MESH_STREAM_SETTLE_S))
    return out


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="toy sizes on the CPU (plumbing check only; "
                         "prints no result line)")
    opts = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if opts.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
    elif os.environ.get("JAX_PLATFORMS") and \
            "cpu" not in os.environ["JAX_PLATFORMS"]:
        # the parity phase needs the CPU backend beside the GPU
        os.environ["JAX_PLATFORMS"] += ",cpu"
    import jax
    from pysdr_tpu.utils import enable_compilation_cache

    if opts.cpu_rehearsal:
        dev = {"platform": "cpu", "kind": jax.devices()[0].device_kind,
               "count": len(jax.devices())}
        sz = SMALL
    else:
        dev = check_device()
        sz = FULL
    print(f"device: platform {dev['platform']}, kind {dev['kind']}, "
          f"count {dev['count']}", flush=True)
    if not opts.cpu_rehearsal:
        for ln in nvidia_smi():
            print(f"nvidia-smi: {ln}", flush=True)
    cache = enable_compilation_cache()
    global CLOCK
    CLOCK = CompileClock()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        if opts.four:
            res = phase_four(td, sz)
        else:
            res = {"bank4": phase_bank4(td, sz), "chan64": phase_chan64(sz),
                   "parity": phase_parity(sz)}
    n_entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"compile cache: {cache} holds {n_entries} entries; "
          f"{CLOCK.hits} hits this run; total compile "
          f"{CLOCK.secs:.1f} s over {CLOCK.count} executables", flush=True)
    print(f"summary: {json.dumps(res, default=float)}", flush=True)
    print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    if opts.cpu_rehearsal:
        print("cpu rehearsal ok (no result line)", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
