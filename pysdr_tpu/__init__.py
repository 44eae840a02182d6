"""pysdr_tpu — a JAX software-defined-radio framework, run on NVIDIA GPUs.

Brand-new design (not a port) with the capabilities of aa2il/pySDR
(studied at /root/reference; see SURVEY.md). The reference's mutable
state + thread hot loop (reference receiver.py:684-782) becomes a pure,
jit-compiled block-processing graph:

    process_block(state, iq_block, cfg) -> (state, audio, taps)

All control-plane mutations (retune, mode change, filter swap) are new
config values applied between blocks — mirroring the reference's
block-boundary mutation discipline (reference receiver.py:633-680).

Layout:
  ops/       pure-JAX + Pallas DSP kernels (NCO, FIR, resample, demod, AGC...)
  models/    composed receivers: single channel, channel bank, RTTY decoder
  parallel/  mesh/sharding: channel-axis + stream-axis (halo) parallelism
  io/        .dat record/replay, wav, synthetic sources
  runtime/   streaming executive, watchdog, profiler, control plane
  native/    C++ host runtime (ring buffer, file streamer, format conv)
  utils/     small helpers
"""

__version__ = "0.1.0"

from pysdr_tpu import tables  # noqa: F401
from pysdr_tpu.rates import up_dn, rate_plan  # noqa: F401
from pysdr_tpu.config import ReceiverConfig, PipelineConfig  # noqa: F401
