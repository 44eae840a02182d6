"""The one matmul precision of the step path.

Every matrix product and convolution in the device step (the resampler's
slab matmuls, the channelizer's DFT transform, the direct-conv FIRs and
the RTTY matched filter) goes through `dot` / `matmul_precision` here,
so the CPU suite and the GPU run the same arithmetic with no branch on
the backend: float32 operands and products (`lax.Precision.HIGHEST`).

HIGHEST was chosen on the H100 against the backend default (TF32 tensor
cores) and bf16 operands with float32 sums (PERF.md, precision table,
measured with probes/matmul_precision.py): at the bank4 and chan64
shapes the three step times lie within the spread of repeated runs (the
slab and DFT matmuls are skinny and memory-bound), and only HIGHEST keeps
the GPU audio within float32 rounding of the CPU reference; bf16
operands fall below the 60 dB GPU-vs-CPU bound on chan64. An explicitly
set `jax_default_matmul_precision` keeps its meaning: the products then
defer to it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PRECISION = jax.lax.Precision.HIGHEST


def matmul_precision():
    """`precision=` for the step's products: PRECISION, or None (defer to
    the config) when the user set jax_default_matmul_precision."""
    if jax.config.jax_default_matmul_precision is not None:
        return None
    return PRECISION


def dot(a, b):
    """a @ b accumulated in float32 at the step's matmul precision."""
    return jnp.dot(a, b, precision=matmul_precision(),
                   preferred_element_type=jnp.float32)
