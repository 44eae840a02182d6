"""Device-step anatomy of bank4 and chan64 from a jax.profiler trace.

Traces a few device steps of each bank (chip_smoke.py's configurations,
device-resident random blocks), reads the trace with
jax.profiler.ProfileData, and attributes every device kernel to a stage
of the step through the compiled HLO's op_name metadata: the banks wrap
their stages in jax.named_scope (STAGES below; anything else is
"other"). Reports, per bank:

  * host wall ms per step, untraced and traced;
  * device busy us per step (union of kernel intervals) and the idle
    share of the traced window;
  * per-stage device us per step and share of the busy time, and the
    top kernels;
  * XLA's cost analysis (flops, bytes accessed), and for a device_kind
    listed in bench.PEAKS the roofline share of the step against the
    published float32 and memory peaks (an unknown kind gets none);
  * what a large bf16 matmul and a large copy reach on this card, as the
    achievable references.

    python probes/profile_device_step.py [--small] [--no-command-buffer]
                                         [--out DIR]

--no-command-buffer runs XLA without CUDA command buffers, so that every
kernel event names its HLO op; the stage shares then cover the library
kernels (cuBLAS gemms) too, at the cost of per-kernel launch overhead.

Writes DIR/profile.json (default: the current directory; profile_nocb.json
with --no-command-buffer) and prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402

STAGES = ("dequantize", "mix_resample", "channel_resample", "branch_filter",
          "channel_transform", "af_filter", "demod", "wire_out")
ITERS = 10


def stage_of(op_name: str) -> str | None:
    """Innermost known stage in an op_name path, or None. Transforms wrap
    a scope's name (vmap(demod))."""
    hit = None
    for part in op_name.split("/"):
        while (m := re.fullmatch(r"\w+\((.*)\)", part)):
            part = m.group(1)
        if part in STAGES:
            hit = part
    return hit


def hlo_stage_map(hlo_text: str) -> dict:
    """HLO instruction name -> stage, from the compiled module's text. An
    instruction without a stage of its own (a fusion whose metadata was
    dropped) takes the most common stage inside its called computation."""
    comp_stages: dict = collections.defaultdict(collections.Counter)
    inst: dict = {}
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and " = " not in line:
            comp = head.group(1)
            continue
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        calls = re.search(r"calls=%?([\w.\-]+)", line)
        st = stage_of(op.group(1)) if op else None
        inst[m.group(1)] = (st, calls.group(1) if calls else None)
        if comp and st:
            comp_stages[comp][st] += 1
    out = {}
    for name, (st, calls) in inst.items():
        if st is None and calls and comp_stages.get(calls):
            st = comp_stages[calls].most_common(1)[0][0]
        out[name] = st or "other"
    return out


def device_events(trace_dir: str):
    """[(plane, line, name, start_ns, dur_ns, hlo_op)] for the events on
    device planes that carry an hlo_op stat, and event counts by line."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    assert paths, f"no trace under {trace_dir}"
    pd = ProfileData.from_file(sorted(paths)[-1])
    evs, lines = [], collections.Counter()
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    # the CPU backend runs its ops on host threads: a dry run reads those
    for plane in planes or [p for p in pd.planes
                            if p.name.startswith("/host:CPU")]:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = stats.get("hlo_op")
                lines[(plane.name, line.name, hlo is not None)] += 1
                if hlo is None:
                    continue
                evs.append((plane.name, line.name, ev.name,
                            float(ev.start_ns), float(ev.duration_ns),
                            str(hlo)))
    return evs, {f"{p} | {ln} | hlo_op={h}": n
                 for (p, ln, h), n in lines.items()}


def busy_ns(intervals) -> float:
    """Length of the union of [start, start+dur) intervals."""
    total, end = 0.0, None
    for s, d in sorted(intervals):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def anatomy(label: str, bank, n_in: int, peaks: dict | None) -> dict:
    import jax
    key = jax.random.PRNGKey(0)
    xs = [jax.random.normal(jax.random.fold_in(key, i), (n_in, 2))
          for i in range(4)]
    st = bank.state
    compiled = bank._step.lower(st, xs[0], bank.params).compile()
    stage = hlo_stage_map(compiled.as_text())
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    flops = float(ca.get("flops", 0.0))
    nbytes = float(ca.get("bytes accessed", 0.0))
    st, out = bank._step(st, xs[0], bank.params)
    jax.block_until_ready(out)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(ITERS):
            st, out = bank._step(st, xs[i % 4], bank.params)
        jax.block_until_ready((st, out))
        walls.append((time.perf_counter() - t0) / ITERS * 1e3)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        with jax.profiler.trace(td):
            for i in range(ITERS):
                st, out = bank._step(st, xs[i % 4], bank.params)
            jax.block_until_ready((st, out))
        traced_ms = (time.perf_counter() - t0) / ITERS * 1e3
        evs, line_counts = device_events(td)
    res = {"wall_ms_per_step": statistics.median(walls),
           "wall_ms_windows": walls, "traced_wall_ms_per_step": traced_ms,
           "trace_lines": line_counts, "flops": flops,
           "bytes_accessed": nbytes}
    if not evs:
        res["error"] = "no device events with an hlo_op stat"
        return res
    # kernels launched from an XLA command buffer carry hlo_op
    # "command_buffer"; their kernel name is the fusion's name with "_"
    # for "." (library kernels such as cuBLAS gemms stay unattributed)
    by_kernel = {re.sub(r"[.\-]", "_", k): v for k, v in stage.items()}

    def stage_for(name, hlo):
        if hlo in stage:
            return stage[hlo]
        return by_kernel.get(re.sub(r"[.\-]", "_", name), "other")

    per_stage = collections.Counter()
    per_kernel = collections.Counter()
    for _, _, name, _, dur, hlo in evs:
        per_stage[stage_for(name, hlo)] += dur
        per_kernel[(name, hlo, stage_for(name, hlo))] += dur
    span = max(s + d for _, _, _, s, d, _ in evs) - min(
        s for _, _, _, s, _, _ in evs)
    busy = busy_ns([(s, d) for _, _, _, s, d, _ in evs])
    kernel_sum = sum(per_stage.values())
    dev_us = busy / 1e3 / ITERS
    res.update({
        "device_busy_us_per_step": dev_us,
        "kernel_sum_us_per_step": kernel_sum / 1e3 / ITERS,
        "idle_share_of_kernel_span": 1.0 - busy / span if span else None,
        "stage_us_per_step": {k: v / 1e3 / ITERS
                              for k, v in per_stage.most_common()},
        "stage_share": {k: v / kernel_sum for k, v in per_stage.most_common()},
        "top_kernels": [
            {"kernel": n[:80], "hlo_op": h, "stage": s,
             "us_per_step": v / 1e3 / ITERS}
            for (n, h, s), v in per_kernel.most_common(15)],
        "achieved_gb_per_s": nbytes / (dev_us * 1e-6) / 1e9,
        "achieved_tflop_per_s": flops / (dev_us * 1e-6) / 1e12,
    })
    if peaks:
        t_mem = nbytes / (peaks["hbm_gb_per_s"] * 1e9)
        t_f32 = flops / (peaks["f32_tflop_per_s"] * 1e12)
        res["roofline_share"] = max(t_mem, t_f32) / (dev_us * 1e-6)
        res["roofline_bound"] = "memory" if t_mem >= t_f32 else "f32 flops"
    print(f"{label}: wall {res['wall_ms_per_step']:.3f} ms/step, device "
          f"busy {dev_us:.1f} us/step, idle share "
          f"{res['idle_share_of_kernel_span']:.3f}; stages "
          + ", ".join(f"{k} {100 * v:.1f}%"
                      for k, v in res["stage_share"].items()), flush=True)
    return res


def references(peaks: dict | None) -> dict:
    """What a large bf16 matmul and a large copy reach on this device."""
    import jax
    import jax.numpy as jnp
    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))
    cp = jax.jit(lambda x: x + 1.0)
    big = jnp.ones((1 << 28,), jnp.float32)         # 1 GiB
    out = {}
    for name, f, arg, work in (("bf16_matmul_tflop_per_s", mm, a,
                                2.0 * n ** 3 / 1e12),
                               ("copy_gb_per_s", cp, big,
                                2.0 * big.size * 4 / 1e9)):
        jax.block_until_ready(f(arg))
        t0 = time.perf_counter()
        for _ in range(10):
            r = f(arg)
        jax.block_until_ready(r)
        out[name] = work * 10 / (time.perf_counter() - t0)
    if peaks:
        out["bf16_matmul_share_of_peak"] = (out["bf16_matmul_tflop_per_s"]
                                            / peaks["bf16_tflop_per_s"])
        out["copy_share_of_peak"] = (out["copy_gb_per_s"]
                                     / peaks["hbm_gb_per_s"])
    print(f"references: {json.dumps(out)}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="chip_smoke.py's toy sizes (a CPU dry run)")
    ap.add_argument("--no-command-buffer", action="store_true",
                    help="XLA without CUDA command buffers (per-kernel "
                         "HLO attribution)")
    ap.add_argument("--out", default=".")
    opts = ap.parse_args()
    if opts.no_command_buffer:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    import jax
    from pysdr_tpu import app as app_mod
    from pysdr_tpu.models.receiver import ReceiverBank
    from pysdr_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    sz = cs.SMALL if opts.small else cs.FULL
    dev = jax.devices()[0]
    peaks = bench.PEAKS.get(dev.device_kind)
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "peaks": peaks,
           "xla_flags": os.environ.get("XLA_FLAGS", "")}
    try:
        res["nvidia_smi"] = cs.nvidia_smi()
    except Exception as e:  # noqa: BLE001 — a CPU dry run has none
        res["nvidia_smi"] = [repr(e)]
    print(json.dumps(res), flush=True)
    args = app_mod.build_parser().parse_args(sz["bank4"])
    bank = ReceiverBank(app_mod.build_config(args))
    res["bank4"] = anatomy("bank4", bank, bank.design.in_block, peaks)
    args = app_mod.build_parser().parse_args(sz["chan64"]
                                             + ["--audio-wire", "f32"])
    cb, _, _ = app_mod.build_channelizer(args)
    res["chan64"] = anatomy("chan64", cb, cb.in_block, peaks)
    if not opts.small:
        res["references"] = references(peaks)
    os.makedirs(opts.out, exist_ok=True)
    name = "profile_nocb.json" if opts.no_command_buffer else "profile.json"
    with open(os.path.join(opts.out, name), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
