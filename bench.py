"""Headline benchmark: IQ samples/s through the full mix+filter+demod chain,
across the BASELINE.md measurement plan (configs 1-5) plus end-to-end
(host->device->host) numbers per wire format.

Prints ONE JSON line {metric, value, unit, vs_baseline, device, extra}:
  metric/value  = RF input samples/s through the 4-channel 8 MHz bank
                  (BASELINE config 4 — the reference's maximum advertised
                  configuration, reference README.md:27, Tables.py:45);
  vs_baseline   = value / 10 Msamp/s, the reference's real-time design
                  envelope (it publishes no benchmark numbers; BASELINE.md);
  device        = platform, device_kind and count the children ran on;
  extra         = the full per-config table: configs 1-3 (one executable —
                  modes are traced params), config 5 (64-ch channelizer),
                  and the e2e_suite (host replay -> device -> host audio
                  per wire format with per-stage ms/block, and the 64-ch
                  config host-to-host). Every entry names its device.

Each config runs in its own child process, one at a time, so one process
holds the device; the parent imports no JAX. Run `python bench.py <name>`
for one config standalone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BASELINE_SPS = 10e6          # reference max real-time RF rate (BASELINE.md)

# Published peaks by jax device_kind, for roofline shares. A kind that is
# not listed gets no share. H100 SXM: NVIDIA H100 Tensor Core GPU data
# sheet, dense (no sparsity), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflop_per_s": 989.0, "tf32_tflop_per_s": 495.0,
        "f32_tflop_per_s": 67.0, "hbm_gb_per_s": 3350.0,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)"},
}

CONFIGS = {   # name -> (timeout_s, description)
    "bank4": (600, "4-RX mixed-mode bank over 8 MHz (BASELINE config 4)"),
    "modes1ch": (600, "1-RX AM/NFM+squelch/SSB+AGC at 2.048 MHz "
                      "(BASELINE configs 1-3, one executable)"),
    "chan64": (600, "64-channel polyphase channelizer + demod at "
                    "12.288 MHz (BASELINE config 5)"),
    "e2e_suite": (900, "host replay -> device bank -> host audio over "
                       "f32/i16/i8 wires + bank4 and 64-ch end-to-end"),
    "host_source": (240, "replay-file host feeding rate: C++ streamer vs "
                         "Python reader (SURVEY §7 hard part 4); no "
                         "device traffic"),
}


def _device() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _measure(step, blocks, iters=20, reps=5):
    """`reps` separately-timed windows of `iters` executes each, after one
    warm-up execute (compile). Returns executes-per-second for each
    window."""
    import jax
    out = step(blocks[0])
    jax.block_until_ready(out)
    rates = []
    for r in range(reps):
        t0 = time.perf_counter()
        for i in range(iters):
            out = step(blocks[(r * iters + i) % len(blocks)])
        jax.block_until_ready(out)
        rates.append(iters / (time.perf_counter() - t0))
    return rates


def _sps_stats(rates, in_block) -> dict:
    """Window rates -> {median, min, max, n} RF samples/s."""
    import statistics
    sps = sorted(r * in_block for r in rates)
    return {"samples_per_s": statistics.median(sps),
            "sps_min": sps[0], "sps_max": sps[-1], "n_reps": len(sps)}


def _rand_blocks(in_block, n=4):
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(0)
    return [jax.device_put(jax.random.normal(
        jax.random.fold_in(key, i), (in_block, 2), jnp.float32))
        for i in range(n)]


def _bank(fs_in, modes, out_block, spacing=500e3, foffset=750e3,
          squelch_db=-150.0):
    from pysdr_tpu.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu.models.receiver import ReceiverBank
    fc0 = 100e6
    rxs = tuple(
        ReceiverConfig(fc_hz=fc0 + spacing * i, mode=m,
                       squelch_db=squelch_db)
        for i, m in enumerate(modes))
    cfg = PipelineConfig(fs_in=fs_in, fs_out=48e3, out_block=out_block,
                         foffset_hz=foffset, receivers=rxs)
    return ReceiverBank(cfg)


def bench_bank4():
    from pysdr_tpu.tables import Mode
    bank = _bank(8e6, [Mode.AM, Mode.NFM, Mode.USB, Mode.CW],
                 out_block=24576)
    d = bank.design
    blocks = _rand_blocks(d.in_block)
    res = _sps_stats(_measure(bank.step_device, blocks), d.in_block)
    res.update({"in_block": d.in_block, "n_rx": 4})
    return res


def bench_modes1ch():
    """BASELINE configs 1-3 with ONE compiled executable: mode, squelch,
    and AGC are traced params, so the three configs are pure param swaps
    (the framework's core design claim, models/receiver.py)."""
    from pysdr_tpu.tables import Mode
    bank = _bank(2.048e6, [Mode.AM], out_block=16384, spacing=0,
                 foffset=120e3)
    d = bank.design
    blocks = _rand_blocks(d.in_block)
    out = {}
    t_c0 = time.perf_counter()
    for name, mode, squelch in (("am", Mode.AM, -150.0),
                                ("nfm_squelch", Mode.NFM, 10.0),
                                ("ssb_agc", Mode.USB, -150.0)):
        bank.set_mode(0, mode)
        bank.set_squelch(0, squelch)
        out[name] = _sps_stats(_measure(bank.step_device, blocks),
                               d.in_block)
    out["compile_plus_bench_s"] = time.perf_counter() - t_c0
    out["in_block"] = d.in_block
    return out


def bench_chan64():
    from pysdr_tpu.models.channelizer_bank import (ChannelizerBank,
                                                   ChannelizerBankConfig,
                                                   ChannelSettings)
    from pysdr_tpu.tables import Mode
    n = 64
    cfg = ChannelizerBankConfig(
        fs_in=n * 192e3, n_channels=n, fs_out=48e3, out_block=3072,
        fc_hz=100e6,
        channels=tuple(ChannelSettings(mode=Mode.AM)
                       for _ in range(n)))
    cb = ChannelizerBank(cfg)
    blocks = _rand_blocks(cb.in_block)
    res = _sps_stats(_measure(cb.step_device, blocks), cb.in_block)
    res.update({"in_block": cb.in_block, "n_channels": n,
                "fs_in": cfg.fs_in})
    return res


def _write_am_dat(path, fs, n, offset_hz=120e3):
    import numpy as np
    from pysdr_tpu.io import datfile
    t = np.arange(n) / fs
    m = 0.5 * np.sin(2 * np.pi * 400.0 * t)
    x = (0.45 * (1 + m) * np.exp(2j * np.pi * offset_hz * t)
         ).astype(np.complex64)
    w = datfile.DatWriter(path, fs=fs, fc=100e6 - offset_hz)
    w.save_data(x)
    w.close()


def _wire_bytes(wire: str) -> int:
    """Bytes per component for a wire format, from the one table that
    defines the formats (ops/cplx.WIRE_DTYPES) — no parallel constants
    to drift when a format is added."""
    import numpy as np

    from pysdr_tpu.ops import cplx
    return np.dtype(cplx.WIRE_DTYPES[wire]).itemsize


def _run_e2e(argv, n_blocks=50, warm=2, reps=5):
    """Drive the App's executive after warm blocks, in `reps` separately
    timed repetitions. Returns the MEDIAN throughput with min/max, the
    per-stage ms/block breakdown, and the wire bytes per block."""
    import statistics

    from pysdr_tpu import app as app_mod
    args = app_mod.build_parser().parse_args(argv)
    a = app_mod.App(args)
    try:
        a.ex.run(n_blocks=warm)                # compile + settle
        d = a.bank.design
        base = dict(a.ex.stage_ms)
        per = max(1, n_blocks // reps)
        done, rates = warm, []
        t_all0 = time.perf_counter()
        for _ in range(reps):
            t0 = time.perf_counter()
            a.ex.run(n_blocks=done + per)      # n_blocks is cumulative
            rates.append(per * d.in_block / (time.perf_counter() - t0))
            done += per
        dt_all = time.perf_counter() - t_all0
    finally:
        a.stop_services()                      # joins the reader thread
    n_run = done - warm
    stages = {k: (a.ex.stage_ms[k] - base[k]) / n_run
              for k in a.ex.stage_ms}
    bytes_up = d.in_block * 2 * _wire_bytes(args.wire)
    bytes_down = a.bank.n_rx * d.out_block * 2 * _wire_bytes(
        args.audio_wire)
    block_ms = dt_all / n_run * 1e3
    return {"samples_per_s": statistics.median(rates),
            "sps_min": min(rates), "sps_max": max(rates), "n_reps": reps,
            "blocks_per_rep": per,
            "in_block": d.in_block, "n_rx": a.bank.n_rx,
            "audio_sps_out": n_run * d.out_block / dt_all,
            "block_ms": block_ms,
            "stage_ms": {k: round(v, 1) for k, v in stages.items()},
            "bytes_up_per_block": bytes_up,
            "bytes_down_per_block": bytes_down,
            "wire_bytes_per_rf_sample": round(
                (bytes_up + bytes_down) / d.in_block, 3),
            "source": type(a.source).__name__}


def bench_e2e_suite():
    """The product numbers: host replay -> device -> host audio through
    the streaming executive, per wire format, plus the 4-RX bank and the
    64-ch configuration host-to-host."""
    import tempfile

    partial = os.environ.get("PYSDR_TPU_PARTIAL")

    def checkpoint(out):
        if partial:
            with open(partial, "w") as f:
                json.dump(out, f)

    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "e2e.dat")
        _write_am_dat(path, fs=2.048e6, n=1 << 22)
        for wire in ("f32", "i16", "i8"):
            out[f"end_to_end_{wire}"] = _run_e2e(
                ["--replay", path, "--fs", "2.048", "--block", "16384",
                 "--fc", "100.0", "--wire", wire])
            print(f"# e2e {wire}: {out[f'end_to_end_{wire}']}",
                  file=sys.stderr, flush=True)
            checkpoint(out)
        # big-block variant: 4x the block (2.8 Msamples, 1.37 s of
        # stream) — the throughput-over-latency corner of the envelope
        out["end_to_end_i8_xl"] = _run_e2e(
            ["--replay", path, "--fs", "2.048", "--block", "65536",
             "--fc", "100.0", "--wire", "i8"], n_blocks=30)
        print(f"# e2e i8 xl: {out['end_to_end_i8_xl']}",
              file=sys.stderr, flush=True)
        checkpoint(out)
        # BASELINE config 4 host-to-host: the reference's maximum
        # advertised envelope (4 RX over 8 MHz) through the full
        # host->device->host loop on the compact wires, 6-block reps
        path8 = os.path.join(td, "e2e8m.dat")
        _write_am_dat(path8, fs=8e6, n=1 << 23, offset_hz=750e3)
        out["end_to_end_bank4"] = _run_e2e(
            ["--replay", path8, "--fs", "8.0", "--block", "24576",
             "--fc", "100.0", "100.5", "101.0", "101.5",
             "--modes", "AM", "NFM", "USB", "CW",
             "--wire", "i8", "--audio-wire", "i16"], n_blocks=30)
        print(f"# e2e bank4: {out['end_to_end_bank4']}",
              file=sys.stderr, flush=True)
        checkpoint(out)
        # flagship config 5 host-to-host: 64 channels over 12.288 MHz.
        # RF rides i8 CS8 (2 B/sample); the 64-channel AUDIO return rides
        # the mu-law i8 wire (0.5 B/RF-sample at 64x48k); 12288-sample
        # audio blocks = 3.1 Msample RF.
        path64 = os.path.join(td, "e2e64.dat")
        _write_am_dat(path64, fs=12.288e6, n=1 << 23, offset_hz=96e3)
        out["end_to_end_chan64"] = _run_e2e(
            ["--replay", path64, "--channelize", "64", "--fs", "12.288",
             "--block", "12288", "--fc", "100.0", "--wire", "i8",
             "--audio-wire", "i8"],
            n_blocks=40)
        print(f"# e2e chan64: {out['end_to_end_chan64']}",
              file=sys.stderr, flush=True)
        checkpoint(out)
    return out


def bench_host_source():
    """Host-side source feeding rate from a .dat replay file — must not be
    the bottleneck at the device's consumption rate."""
    import tempfile

    import numpy as np
    from pysdr_tpu.io import datfile
    from pysdr_tpu.runtime import native

    n = 1 << 24                  # 16 Msamples, 128 MiB complex64
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench.dat")
        w = datfile.DatWriter(path, fs=10e6, fc=100e6)
        chunk = np.zeros(1 << 20, np.complex64)
        for _ in range(n // len(chunk)):
            w.save_data(chunk)
        w.close()
        out = {}
        block = 1 << 20

        def sweep_python():
            rd = datfile.DatReader(path)
            t0 = time.perf_counter()
            got = 0
            while True:
                x = rd.read_data(block)
                got += len(x)
                if len(x) < block:
                    break
            rd.close()
            return got / (time.perf_counter() - t0)

        def sweep_native():
            ns = native.NativeStreamer(path)
            t0 = time.perf_counter()
            got = 0
            while True:
                xp = ns.read_packed(block)
                got += len(xp)
                if len(xp) < block:
                    break
            ns.close()
            return got / (time.perf_counter() - t0)

        # measure the CPU path, not the disk: first pass of each warms
        # the page cache / rides out writeback of the just-written file
        # (run-to-run spread without this: 120-800 Msamp/s); report the
        # best of the remaining passes
        sweep_python()
        out["python_reader_sps"] = max(sweep_python() for _ in range(2))
        if native.available():
            sweep_native()
            out["native_streamer_sps"] = max(sweep_native()
                                             for _ in range(2))
        else:
            out["native_streamer_sps"] = None
        return out


def run_config(name: str):
    if name == "bank4":
        return bench_bank4()
    if name == "modes1ch":
        return bench_modes1ch()
    if name == "chan64":
        return bench_chan64()
    if name == "e2e_suite":
        return bench_e2e_suite()
    if name == "host_source":
        return bench_host_source()
    raise SystemExit(f"unknown config {name}")


def main():
    if len(sys.argv) > 1:                      # child / standalone mode
        from pysdr_tpu.utils import enable_compilation_cache
        enable_compilation_cache()
        res = run_config(sys.argv[1])
        res["device"] = _device()
        print(json.dumps(res))
        return

    deadline = time.monotonic() + float(
        os.environ.get("PYSDR_TPU_BENCH_DEADLINE", 2400))
    extra: dict = {}
    for name, (budget, _desc) in CONFIGS.items():
        left = deadline - time.monotonic()
        if left < 60:
            extra[name] = {"skipped": "bench deadline"}
            continue
        partial_path = os.path.abspath(f".bench_partial_{name}.json")
        env = dict(os.environ, PYSDR_TPU_PARTIAL=partial_path)
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), name],
                timeout=min(budget, left), capture_output=True, text=True,
                env=env)
            if p.returncode == 0:
                extra[name] = json.loads(p.stdout.strip().splitlines()[-1])
            else:
                extra[name] = {"error": p.stderr.strip()[-400:]}
        except subprocess.TimeoutExpired:
            extra[name] = {"error": f"timeout after {budget}s"}
            # a killed e2e child leaves its progressive checkpoint
            if os.path.exists(partial_path):
                try:
                    extra[name]["partial"] = json.load(open(partial_path))
                except Exception:  # noqa: BLE001
                    pass
        except Exception as e:  # noqa: BLE001
            extra[name] = {"error": str(e)[:400]}
        finally:
            if os.path.exists(partial_path):
                os.unlink(partial_path)
        print(f"# {name}: {extra[name]}", file=sys.stderr, flush=True)

    headline = extra.get("bank4", {}).get("samples_per_s", 0.0)
    print(json.dumps({
        "metric": "rf_samples_per_s_4ch_bank",
        "value": float(headline),
        "unit": "samples/s",
        "vs_baseline": float(headline / BASELINE_SPS),
        "device": extra.get("bank4", {}).get("device"),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
