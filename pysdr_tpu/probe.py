"""Environment / device exploration tool.

The equivalent of the reference's device smoke tools —
`playpen.py` (Soapy API exploration, playpen.py:41-195), `soapy.py` /
`simple.py` enumeration scripts, and the `check_sdr_settings` dump
(utils.py:358-422): enumerate the compute devices (GPUs / CPU
mesh), probe the source layer (replay-file headers, synth self-test,
native C++ streamer), and run a tiny end-to-end smoke block.

    python -m pysdr_tpu.probe [--replay FILE] [--smoke] [--devices N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def probe_devices():
    import jax
    print(f"jax {jax.__version__}  backend={jax.default_backend()}")
    devs = jax.devices()
    for d in devs:
        kind = getattr(d, "device_kind", "?")
        print(f"  device[{d.id}] platform={d.platform} kind={kind} "
              f"process={d.process_index}")
    n = len(devs)
    facs = [(s, n // s) for s in range(1, n + 1) if n % s == 0]
    print(f"  {n} device(s); stream x ch mesh shapes: "
          + " ".join(f"{a}x{b}" for a, b in facs))
    return devs


def probe_replay(path: str):
    from pysdr_tpu.io import datfile
    rd = datfile.DatReader(path)
    h = rd.header
    print(f"replay {path}:")
    print(f"  fs={rd.srate / 1e6:.6f} MHz  fc={rd.fc / 1e6:.6f} MHz "
          f"nchan={h.nchan} dtype={h.dtype} tag={h.tag}")
    import numpy as np
    x = rd.read_data(min(1 << 16, 4096))
    data_bytes = os.path.getsize(path) - rd._data_start
    dur = data_bytes / (rd._isize * rd.srate)     # honors compact dtypes
    print(f"  ~{dur:.1f} s of capture; first block: rms="
          f"{np.sqrt(np.mean(np.abs(x) ** 2)):.4f} "
          f"peak={np.max(np.abs(x)):.4f} dc={np.mean(x):.5f}")
    rd.close()


def probe_native():
    from pysdr_tpu.runtime import native
    ok = native.available()
    print(f"native C++ runtime (libsdrio.so): "
          f"{'available' if ok else 'NOT built (make -C pysdr_tpu/native)'}")
    return ok


def probe_synth():
    import numpy as np
    from pysdr_tpu.io import synth
    src = synth.SynthSource(
        [synth.SignalSpec(offset_hz=50e3, mode="am", amplitude=0.5,
                          audio_hz=400.0)], 512e3, noise_rms=0.001)
    t0 = time.perf_counter()
    x = src.read_data(1 << 18)
    rate = len(x) / (time.perf_counter() - t0)
    print(f"synth source: ok rms={np.sqrt(np.mean(np.abs(x) ** 2)):.3f} "
          f"({rate / 1e6:.1f} Msamp/s host generation)")


def probe_rtl_tcp(hostport: str):
    """Connect to an rtl_tcp server and dump its identity + a stream
    sample (the reference's check_sdr_settings dump, utils.py:358-422,
    over the network path)."""
    import numpy as np

    from pysdr_tpu.io import rtltcp
    host, _, port = hostport.partition(":")
    src = rtltcp.RtlTcpSource(host or "127.0.0.1", int(port or 1234),
                              fs=1.024e6, fc=100e6)
    try:
        print(f"rtl_tcp {hostport}: tuner={src.tuner} "
              f"(type {src.tuner_type}), "
              f"{src.tuner_gain_count} gain steps")
        x = src.read_data(1 << 15)
        print(f"  stream: {len(x)} samples  "
              f"rms={np.sqrt(np.mean(np.abs(x) ** 2)):.4f} "
              f"peak={np.max(np.abs(x)):.4f} dc={np.mean(x):.5f} "
              f"dropped={src.dropped}")
    finally:
        src.close()


def smoke():
    """One tiny end-to-end block on whatever backend is active (the
    reference's `-test` hook, pySDR.py:126-128)."""
    import numpy as np
    from pysdr_tpu.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu.models.receiver import ReceiverBank
    from pysdr_tpu.tables import Mode
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=2048,
                         foffset_hz=60e3,
                         receivers=(ReceiverConfig(fc_hz=100e6,
                                                   mode=Mode.AM),))
    bank = ReceiverBank(cfg)
    d = bank.design
    t = np.arange(d.in_block) / d.fs_in
    x = (0.5 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
         * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
    t0 = time.perf_counter()
    audio = bank.step(x)
    dt = time.perf_counter() - t0
    rms = float(np.sqrt(np.mean(audio.real ** 2)))
    print(f"smoke: 1 block ({d.in_block} samples) compiled+ran in "
          f"{dt:.1f}s, audio rms={rms:.4f} "
          f"{'OK' if rms > 1e-3 else 'SILENT?'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pysdr_tpu.probe")
    ap.add_argument("--replay", type=str, default=None)
    ap.add_argument("--rtl-tcp", type=str, default=None,
                    metavar="HOST:PORT",
                    help="probe a live rtl_tcp server")
    ap.add_argument("--smoke", action="store_true",
                    help="compile+run one block end to end")
    ap.add_argument("--devices", type=int, default=0,
                    help="emulate N CPU devices")
    args = ap.parse_args(argv)
    if args.devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={args.devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    elif os.environ.get("JAX_PLATFORMS"):
        import jax
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    probe_devices()
    probe_native()
    probe_synth()
    if args.replay:
        if not os.path.exists(args.replay):
            print(f"error: {args.replay} not found", file=sys.stderr)
            return 2
        probe_replay(args.replay)
    if args.rtl_tcp:
        try:
            probe_rtl_tcp(args.rtl_tcp)
        except (OSError, ConnectionError, TimeoutError) as e:
            print(f"rtl_tcp {args.rtl_tcp}: {e}", file=sys.stderr)
            return 2
    if args.smoke:
        smoke()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
