"""Matmul precision on the device: step time and audio quality per choice.

For each candidate matmul precision ("highest" = float32 products, the
package's choice in ops/precision.py; "default" = the backend's float32
default, TF32 on Hopper; "bf16" = bfloat16 operands with float32 sums),
substituted for `ops.precision.dot` in this process only, this measures,
on the default device:

  * the bank4 and chan64 step times (chip_smoke.py's configurations,
    device-resident random blocks, median of 5 windows of 20 steps);
  * the golden AM, NFM and USB+AGC SNRs against the SciPy chain;
  * each bank4 receiver's tone over the spectral floor on the synthetic
    source;
  * the bank4 and chan64 audio against one CPU step at HIGHEST (fit SNR).

The first setting is measured again at the end, so the table shows the
drift between repeats. Run from the repository root:

    python probes/matmul_precision.py [--small] [--out OUT.json]

(--small runs chip_smoke.py's toy sizes, for a dry run on the CPU.)
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ORDER = ("highest", "default", "bf16", "highest")


def _dot_default(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.DEFAULT,
                   preferred_element_type=jnp.float32)


def _dot_bf16(a, b):
    return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


SZ = cs.FULL


def _banks():
    from pysdr_tpu import app as app_mod
    from pysdr_tpu.models.receiver import ReceiverBank
    args = app_mod.build_parser().parse_args(SZ["bank4"])
    cfg = app_mod.build_config(args)
    src, _, _ = app_mod.build_source(args, cfg)
    bank = ReceiverBank(cfg)
    cargs = app_mod.build_parser().parse_args(
        SZ["chan64"] + ["--audio-wire", "f32"])
    cb, csrc, _ = app_mod.build_channelizer(cargs)
    return bank, src, cb, csrc


def step_ms(bank, n_in: int, iters: int = 20, reps: int = 5) -> float:
    key = jax.random.PRNGKey(0)
    xs = [jax.random.normal(jax.random.fold_in(key, i), (n_in, 2))
          for i in range(4)]
    st = bank.state
    st, out = bank._step(st, xs[0], bank.params)
    jax.block_until_ready(out)
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        for i in range(iters):
            st, out = bank._step(st, xs[i % 4], bank.params)
        jax.block_until_ready((st, out))
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(times)


def run_blocks(bank, blocks, device=None):
    st, params, outs = bank.state, bank.params, []
    step = bank._step
    if device is not None:
        st, params = jax.device_put(st, device), jax.device_put(params,
                                                                device)
        step = jax.jit(bank._step_impl)
    for x in blocks:
        st, out = step(st, jax.device_put(x, device) if device else
                       jax.numpy.asarray(x), params)
        outs.append(cs._unpack_audio(out, bank.n_rx))
    return np.concatenate(outs, axis=1)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    global SZ
    SZ = cs.SMALL if opts.small else cs.FULL
    out_path = opts.out
    from pysdr_tpu.ops import cplx, precision
    from pysdr_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "rows": []}
    try:
        res["nvidia_smi"] = cs.nvidia_smi()
    except Exception as e:  # noqa: BLE001 — a CPU dry run has none
        res["nvidia_smi"] = [repr(e)]
    print(json.dumps(res), flush=True)

    bank, src, cb, csrc = _banks()
    n_par = 3
    b4_blocks = [cplx.pack(src.read_data(bank.design.in_block))
                 for _ in range(n_par)]
    c64_blocks = [cplx.pack(csrc.read_data(cb.in_block))
                  for _ in range(n_par)]
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        ref4 = run_blocks(bank, b4_blocks, cpu)
        ref64 = run_blocks(cb, c64_blocks, cpu)
    fs = bank.design.fs_out
    tones = cs.expected_tones(["AM", "NFM", "USB", "CW"])

    dots = {"highest": precision.dot, "default": _dot_default,
            "bf16": _dot_bf16}
    for mode in ORDER:
        precision.dot = dots[mode]
        jax.clear_caches()
        bank, src, cb, csrc = _banks()
        row = {"precision": mode,
               "bank4_step_ms": step_ms(bank, bank.design.in_block),
               "chan64_step_ms": step_ms(cb, cb.in_block)}
        bank, src, cb, csrc = _banks()
        a4 = run_blocks(bank, b4_blocks)
        a64 = run_blocks(cb, c64_blocks)
        row["bank4_vs_cpu_db"] = min(
            cs.fit_snr_db(ref4[c].real, a4[c].real) for c in range(4))
        row["chan64_vs_cpu_db"] = min(
            cs.fit_snr_db(ref64[c].real, a64[c].real)
            for c in range(0, cb.n_ch, 4))
        # tone floor on 8 fresh synthetic blocks (the first is settle)
        syn = run_blocks(bank, [cplx.pack(src.read_data(
            bank.design.in_block)) for _ in range(8)])
        row["bank4_tone_db"] = [
            cs.tone_over_floor(syn[i, syn.shape[1] // 4:].real, fs)[1]
            for i in range(4)]
        row["bank4_tone_hz"] = [
            cs.tone_over_floor(syn[i, syn.shape[1] // 4:].real, fs)[0]
            for i in range(4)]
        row["expected_tone_hz"] = tones
        row["golden_db"] = {k: v[0] for k, v in cs.golden_snrs().items()}
        print(json.dumps(row), flush=True)
        res["rows"].append(row)
    precision.dot = dots["highest"]
    if out_path:
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
