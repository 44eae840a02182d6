import os

import numpy as np
import pytest

from pysdr_tpu.runtime import native


@pytest.fixture(autouse=True)
def _native_lib():
    # decided per test, never at import: every worker imports this file
    if not native.available():
        pytest.skip("native library could not be built here")


def _leftovers():
    return [f for f in os.listdir(native._DIR) if f.startswith(".libsdrio.")]


def test_build_renames_a_complete_library_into_place(monkeypatch):
    """The build compiles under a private name and renames it over the
    library path in one step, hash sidecar after: a concurrent loader
    sees the old file or the new one, never a partial one."""
    calls = []
    real_replace = os.replace

    def spy(src, dst):
        with open(src, "rb") as f:
            calls.append((src, dst, f.read(4)))
        real_replace(src, dst)

    monkeypatch.setattr(native.os, "replace", spy)
    assert native._build()
    assert [d for _, d, _ in calls] == [native._LIB_PATH, native._HASH_PATH]
    src, _, magic = calls[0]
    assert src != native._LIB_PATH and magic == b"\x7fELF"
    assert not native._stale()
    assert _leftovers() == []


def test_failed_build_leaves_library_and_no_temp(monkeypatch):
    before = os.stat(native._LIB_PATH).st_ino

    def boom(*a, **k):
        raise OSError("no compiler")

    monkeypatch.setattr(native.subprocess, "run", boom)
    assert native._build() is False
    assert os.stat(native._LIB_PATH).st_ino == before
    assert _leftovers() == []


def test_native_ring_roundtrip(rng):
    r = native.NativeRing("t", 4096)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
         ).astype(np.complex64)
    assert r.push(x) == 1000
    assert r.nsamps == 1000
    y = r.pull(1000)
    np.testing.assert_array_equal(x, y)


def test_native_ring_wrap(rng):
    r = native.NativeRing("t", 256)
    for _ in range(10):
        x = (rng.standard_normal(200) + 1j * rng.standard_normal(200)
             ).astype(np.complex64)
        assert r.push(x) == 200
        np.testing.assert_array_equal(r.pull(200), x)


def test_native_ring_overflow_drops_excess(rng):
    r = native.NativeRing("t", 128)
    x = np.arange(200, dtype=np.complex64)
    pushed = r.push(x)
    assert pushed == 128
    assert r.overflows == 72
    np.testing.assert_array_equal(r.pull(128), x[:128])


def test_native_streamer_complex64(tmp_path, rng):
    from pysdr_tpu.io import datfile
    x = (rng.standard_normal(50000) + 1j * rng.standard_normal(50000)
         ).astype(np.complex64)
    p = str(tmp_path / "s.dat")
    datfile.write_dat(p, x, fs=2.048e6, fc=7.1e6)
    s = native.NativeStreamer(p)
    assert s.srate == 2.048e6 and s.fc == 7.1e6
    a = s.read_data(20000)
    b = s.read_data(30000)
    np.testing.assert_array_equal(np.concatenate([a, b]), x)
    s.close()


def test_native_streamer_cs16(tmp_path, rng):
    from pysdr_tpu.io import datfile
    # int16 IQ container: nchan=1, each complex sample stored as an
    # interleaved re,im int16 pair (already-quantized raw passthrough)
    n = 10000
    raw = (rng.integers(-32768, 32767, size=2 * n)).astype(np.int16)
    w = datfile.DatWriter(str(tmp_path / "i16.dat"), fs=1e6, nchan=1,
                          dtype="int16", tag="raw_iq")
    w.save_data(raw)
    w.close()
    s = native.NativeStreamer(str(tmp_path / "i16.dat"))
    a = s.read_packed(n)
    expect = raw.astype(np.float32).reshape(n, 2) / 32768.0
    np.testing.assert_allclose(a, expect, atol=1e-6)
    s.close()


def test_native_streamer_loop(tmp_path, rng):
    from pysdr_tpu.io import datfile
    x = np.arange(1000, dtype=np.complex64)
    p = str(tmp_path / "l.dat")
    datfile.write_dat(p, x, fs=1e3)
    s = native.NativeStreamer(p, loop=True)
    a = s.read_data(2500)
    np.testing.assert_array_equal(a[:1000], x)
    np.testing.assert_array_equal(a[1000:2000], x)
    np.testing.assert_array_equal(a[2000:], x[:500])
    s.close()


def test_app_replay_uses_native_streamer(tmp_path):
    """The app's --replay path picks the C++ streamer when built and
    produces the same demodulated audio as the Python reader."""
    import wave
    import numpy as np
    from pysdr_tpu import app as app_mod
    from pysdr_tpu.io import datfile

    fs = 512e3
    n = 1 << 19
    t = np.arange(n) / fs
    m = 0.5 * np.sin(2 * np.pi * 400.0 * t)
    x = ((1 + m) * np.exp(2j * np.pi * 120e3 * t)).astype(np.complex64)
    path = str(tmp_path / "cap.dat")
    w = datfile.DatWriter(path, fs=fs, fc=100e6 - 120e3)
    w.save_data(x)
    w.close()

    def run(tag, extra):
        args = app_mod.build_parser().parse_args(
            ["--replay", path, "--no-loop", "--fc", "100.0",
             "--block", "4096", "--wav", str(tmp_path / tag)] + extra)
        a = app_mod.App(args)
        a.run()
        return a

    a_native = run("onat", [])
    a_python = run("opy", ["--no-native"])
    from pysdr_tpu.runtime.native import NativeStreamer
    assert isinstance(a_native.source, NativeStreamer)
    assert not isinstance(a_python.source, NativeStreamer)
    assert a_native.ex.n_blocks == a_python.ex.n_blocks > 0

    def wav_pcm(prefix):
        wv = wave.open(prefix + "_rx0.wav")
        return np.frombuffer(wv.readframes(wv.getnframes()), np.int16)

    pa = wav_pcm(str(tmp_path / "onat"))
    pb = wav_pcm(str(tmp_path / "opy"))
    assert len(pa) == len(pb)
    np.testing.assert_allclose(pa.astype(np.float32),
                               pb.astype(np.float32), atol=1.0)


def test_native_cu8_matches_numpy_lut():
    """The C++ CU8 converter (used by the rtl_tcp source when built)
    agrees with the numpy LUT fallback at the float32 ulp."""
    import numpy as np

    from pysdr_tpu.io import rtltcp
    from pysdr_tpu.runtime import native

    raw = np.arange(512, dtype=np.uint8)
    a = native.convert_cu8(raw)
    b = rtltcp._CU8_LUT[raw].reshape(-1, 2)
    # C++ multiplies by 1/127.5f, numpy divides: last-ulp differences
    np.testing.assert_allclose(a, b, atol=2e-7)
