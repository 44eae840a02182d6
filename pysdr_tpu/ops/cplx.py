"""Packed complex at the jit boundary, and the host<->device wire formats.

Policy, enforced by these helpers:

  * complex64 appears only INSIDE a jitted computation;
  * every jit boundary value (inputs, outputs, carried state, params,
    stored constants) is float32 with a trailing re/im axis of size 2.

The policy was first forced by an accelerator runtime that could not
transfer complex64. The GPU can, so packing state and params is no
longer needed; it stays because the RF and audio wire formats below
(CS8/CS16 pairs in, int16/mu-law int8 pairs out) are interleaved re/im
pairs anyway, and dropping the packing of state and params is a
separate change (ROADMAP C2).

`pack`/`unpack` convert on device (free — a layout op fused by XLA);
`pack_tree`/`unpack_tree` handle whole state/param pytrees with a static
bool mask recording which leaves are complex.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack(z):
    """complex (...,) -> float32 (..., 2). Works on jnp or np arrays."""
    if isinstance(z, np.ndarray) or np.isscalar(z):
        z = np.asarray(z)
        return np.stack([z.real.astype(np.float32),
                         z.imag.astype(np.float32)], -1)
    return jnp.stack([jnp.real(z).astype(jnp.float32),
                      jnp.imag(z).astype(jnp.float32)], -1)


def unpack(p):
    """float32 (..., 2) -> complex64 (...,)."""
    if isinstance(p, np.ndarray):
        return (p[..., 0] + 1j * p[..., 1]).astype(np.complex64)
    return jax.lax.complex(p[..., 0], p[..., 1])


def is_complex(x) -> bool:
    return jnp.iscomplexobj(x)


def pack_tree(tree):
    """Pack every complex leaf. Returns (packed_tree, mask) where mask is a
    same-structure pytree of python bools (static)."""
    leaves, treedef = jax.tree.flatten(tree)
    mask = [bool(jnp.iscomplexobj(l)) for l in leaves]
    packed = [pack(l) if m else l for l, m in zip(leaves, mask)]
    return jax.tree.unflatten(treedef, packed), \
        jax.tree.unflatten(treedef, mask)


def unpack_tree(packed, mask):
    return jax.tree.map(lambda p, m: unpack(p) if m else p, packed, mask)


# -- wire formats: RF blocks may cross the host->device boundary as raw
# int8/int16 sample pairs (CS8/CS16, what real SDR ADCs produce — RTL is
# 8-bit, SDRplay 14-bit, SURVEY §2.8) at 1/4 / 1/2 the bytes of float32
# pairs; dequantization happens ON DEVICE inside the step jit so the
# transfer ships the small ints.

WIRE_SCALES = {"i8": 127.0, "i16": 32767.0}
WIRE_DTYPES = {"i8": np.int8, "i16": np.int16, "f32": np.float32}


def dequantize(x_p):
    """Traced: int8/int16 (..., 2) wire block -> float32; f32 passthrough.
    The dtype is a trace-time property, so this costs nothing for f32 and
    one fused elementwise convert for the int formats."""
    if x_p.dtype == jnp.int8:
        return x_p.astype(jnp.float32) * jnp.float32(1.0 / 127.0)
    if x_p.dtype == jnp.int16:
        return x_p.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
    return x_p


# Audio-return wire: the audio leaving the device is half the transport
# for a many-channel bank; i16 halves it again and i8 quarters it. Unlike
# the RF ADC wire (full scale exactly 1.0), demodulated audio
# legitimately overshoots unity during AGC/filter transients, so the
# audio wire carries 4x headroom (clip at |x| = 4.0):
#   * i16: linear, ~78 dB SNR on unit-level audio;
#   * i8: mu-law companded (mu=255, the G.711 law) — linear i8 under the
#     4x headroom would leave only ~32 dB and fall off 6 dB per halving
#     of level, while mu-law holds a level-independent ~37 dB over the
#     whole AGC range: monitoring quality, the point of the chan64
#     many-channel return (decode is a 256-entry host LUT, ~free).
AUDIO_WIRE_HEADROOM = 4.0
_MU = 255.0


def _mulaw_decode_lut() -> np.ndarray:
    q = np.arange(-128, 128, dtype=np.float32) / 127.0
    x = np.sign(q) * ((1.0 + _MU) ** np.abs(np.clip(q, -1, 1)) - 1.0) / _MU
    return (x * AUDIO_WIRE_HEADROOM).astype(np.float32)


_MULAW_LUT = _mulaw_decode_lut()


def quantize_audio_wire(xp, wire: str):
    """Traced: float32 packed audio pairs -> int16/int8 ON DEVICE."""
    if wire == "f32":
        return xp
    if wire == "i8":
        y = jnp.clip(xp * jnp.float32(1.0 / AUDIO_WIRE_HEADROOM), -1.0, 1.0)
        c = jnp.sign(y) * jnp.log1p(_MU * jnp.abs(y)) \
            * jnp.float32(1.0 / np.log1p(_MU))
        return jnp.round(c * 127.0).astype(jnp.int8)
    s = jnp.float32(32767.0 / AUDIO_WIRE_HEADROOM)
    return jnp.clip(jnp.round(xp * s), -32767.0, 32767.0) \
        .astype(jnp.int16)


def dequantize_audio_host(q: np.ndarray) -> np.ndarray:
    """Host: audio wire block -> float32 pairs (inverse of
    quantize_audio_wire); f32 passes through."""
    if q.dtype == np.int8:
        return _MULAW_LUT[q.astype(np.int16) + 128]
    if q.dtype == np.int16:
        return q.astype(np.float32) \
            * np.float32(AUDIO_WIRE_HEADROOM / 32767.0)
    return q


def quantize_host(xp: np.ndarray, wire: str) -> np.ndarray:
    """Host: float32 (..., 2) packed pairs -> wire dtype. Full scale is
    |x| = 1.0 (ADC convention); values beyond clip like an ADC would."""
    if wire == "f32":
        return xp
    s = WIRE_SCALES[wire]
    return np.clip(np.rint(xp * s), -s, s).astype(WIRE_DTYPES[wire])


def to_host(z_dev_packed) -> np.ndarray:
    """Device packed pair -> host numpy complex64."""
    return unpack(np.asarray(z_dev_packed))


def to_device(z_np):
    """Host complex -> device packed pair."""
    return jnp.asarray(pack(np.asarray(z_np)))
