"""Multi-host distributed initialization + scaling harness.

The reference is strictly single-host (SURVEY.md §2.10 row 5: mp.Pipe/
Queue/Event intra-host only). This framework scales across hosts with
`jax.distributed.initialize`: every host runs the same program, the mesh
is built over the GLOBAL device list, and the in-graph collectives
(ppermute halos, channel shards) ride the device interconnect within a
host and the network across hosts — no application-level message
passing at all.

Usage (one command per host):

    python -m pysdr_tpu.parallel.distributed \
        --coordinator HOST0:1234 --nprocs 4 --proc-id $I [--demo rx|chan]

The coordinator address, process count and process id are always given
explicitly (flags, or PYSDR_TPU_NPROCS for the count). The module also
backs the multi-process CPU test
(tests/test_distributed.py) which emulates hosts with subprocesses.
"""

from __future__ import annotations

import argparse
import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process; no-op (and
    False) for single-process runs so the same entry point serves both.

    Without flags this stays single-process LOUDLY (each process building
    a local-only mesh with pid=0 everywhere is exactly the silent failure
    to avoid)."""
    import jax
    if num_processes is None:
        num_processes = int(os.environ.get("PYSDR_TPU_NPROCS", "1"))
    if num_processes <= 1 and coordinator is None:
        print("init_distributed: single-process (no --coordinator/"
              "--nprocs flags)", flush=True)
        return False
    kw = {}
    if coordinator:
        kw["coordinator_address"] = coordinator
    if num_processes:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    return True


def global_mesh(n_stream: int = 1):
    """Mesh over the GLOBAL device list (all hosts)."""
    import jax
    from pysdr_tpu.parallel.mesh import make_mesh
    return make_mesh(n_stream=n_stream, devices=jax.devices())


def demo_receiver(n_stream: int):
    """One sharded stream-processor step over the global mesh; prints a
    digest every host can cross-check (collectives-correctness probe)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pysdr_tpu.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu.models.receiver import ReceiverBank
    from pysdr_tpu.parallel import stream as stream_mod
    from pysdr_tpu.tables import Mode

    mesh = global_mesh(n_stream=n_stream)
    n_ch = mesh.shape["ch"]
    rxs = tuple(ReceiverConfig(fc_hz=100e6 + 20e3 * i, mode=Mode.AM,
                               agc_enabled=False)
                for i in range(max(n_ch, 1)))
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=128,
                         foffset_hz=60e3, receivers=rxs)
    bank = ReceiverBank(cfg)
    d = bank.design
    seg = 4 * d.in_block
    proc, halo = stream_mod.make_stream_processor(bank, mesh, seg)
    n_total = mesh.shape["stream"] * seg
    t = np.arange(n_total) / d.fs_in
    x = (0.5 * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
    from pysdr_tpu.ops import cplx
    from jax.sharding import NamedSharding, PartitionSpec as P
    xp = jax.device_put(cplx.pack(x), NamedSharding(mesh, P("stream")))
    audio = proc(xp, bank.params)
    digest = float(jnp.sum(jnp.abs(audio)))
    print(f"distributed rx ok: pid={jax.process_index()} "
          f"mesh={dict(mesh.shape)} halo={halo} digest={digest:.4f}",
          flush=True)
    return digest


def demo_streaming(n_stream: int):
    """TWO consecutive super-blocks through the STATE-CONTINUOUS
    streaming processor (parallel/stream.make_streaming_processor) over
    the global mesh: the carried RF tail and phase bases cross the
    process boundary between calls, so matching digests prove the
    repeated-call sharded path is collectives-correct multi-host."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pysdr_tpu.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu.models.receiver import ReceiverBank
    from pysdr_tpu.ops import cplx
    from pysdr_tpu.parallel import stream as stream_mod
    from pysdr_tpu.tables import Mode

    mesh = global_mesh(n_stream=n_stream)
    n_ch = mesh.shape["ch"]
    rxs = tuple(ReceiverConfig(fc_hz=100e6 + 20e3 * i, mode=Mode.AM,
                               agc_enabled=False)
                for i in range(max(n_ch, 1)))
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=128,
                         foffset_hz=60e3, receivers=rxs)
    bank = ReceiverBank(cfg)
    d = bank.design
    seg = 4 * d.in_block
    proc, halo = stream_mod.make_streaming_processor(bank, mesh, seg)
    n_total = mesh.shape["stream"] * seg
    tail = jnp.zeros((halo, 2), jnp.float32)
    nb = jnp.zeros((bank.n_rx,), jnp.int32)
    bb = jnp.zeros((bank.n_rx,), jnp.int32)
    dstate = bank.state.ch.demod
    digest = 0.0
    for call in range(2):
        t = (call * n_total + np.arange(n_total)) / d.fs_in
        x = (0.5 * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
        xp = jax.device_put(cplx.pack(x),
                            NamedSharding(mesh, P("stream")))
        audio, nb, bb, tail, dstate, _ = proc(
            xp, bank.params, tail, nb, bb, dstate)
        digest += float(jnp.sum(jnp.abs(audio)))
    print(f"distributed streaming ok: pid={jax.process_index()} "
          f"mesh={dict(mesh.shape)} halo={halo} digest={digest:.4f}",
          flush=True)
    return digest


def demo_channelizer():
    """One sharded channelizer step over the global 'ch' mesh."""
    import jax
    import numpy as np
    from pysdr_tpu.models.channelizer_bank import (ChannelizerBank,
                                                   ChannelizerBankConfig,
                                                   ChannelSettings)
    from pysdr_tpu.parallel import chanshard
    from pysdr_tpu.parallel.mesh import single_axis_mesh
    from pysdr_tpu.tables import Mode

    mesh = single_axis_mesh("ch", devices=jax.devices())
    nd = len(jax.devices())
    n_ch = 8 * nd
    cfg = ChannelizerBankConfig(
        fs_in=n_ch * 48e3, n_channels=n_ch, fs_out=48e3, out_block=128,
        fc_hz=100e6,
        channels=tuple(ChannelSettings(mode=Mode.AM, agc_enabled=False)
                       for _ in range(n_ch)))
    cb = ChannelizerBank(cfg)
    proc, specs = chanshard.make_channelizer_processor(cb, mesh)
    state_p, params, w_re, w_im = chanshard.shard_inputs(cb, mesh, specs)
    offs = np.fft.fftfreq(n_ch, 1.0 / cfg.fs_in)
    t = np.arange(cb.in_block) / cfg.fs_in
    x = np.exp(2j * np.pi * offs[1] * t).astype(np.complex64)
    from pysdr_tpu.ops import cplx
    from jax.sharding import NamedSharding, PartitionSpec as P
    xp = jax.device_put(cplx.pack(x), NamedSharding(mesh, P()))
    state_p, audio = proc(state_p, xp, params, w_re, w_im)
    import jax.numpy as jnp
    digest = float(jnp.sum(jnp.abs(audio)))
    print(f"distributed chan ok: pid={jax.process_index()} n_ch={n_ch} "
          f"digest={digest:.4f}", flush=True)
    return digest


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pysdr_tpu.parallel.distributed")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--n-stream", type=int, default=1)
    ap.add_argument("--demo", choices=["rx", "chan", "streaming", "both"],
                    default="both")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="emulate N local CPU devices per process")
    args = ap.parse_args(argv)

    if args.cpu_devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")

    init_distributed(args.coordinator, args.nprocs, args.proc_id)
    if args.demo in ("rx", "both"):
        demo_receiver(args.n_stream)
    if args.demo in ("chan", "both"):
        demo_channelizer()
    if args.demo in ("streaming", "both"):
        demo_streaming(args.n_stream)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
