"""chip_smoke.py's own checks, exercised on the CPU: the device gate that
refuses a CPU-only backend, and the tone, quiet-channel and SNR helpers
on audio made here."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from pysdr_tpu.runtime.audio import WavSink

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 48000.0


def _write_wav(path, x):
    w = WavSink(path, FS)
    w.write(x.astype(np.complex64))
    w.close()


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_device()
    assert "needs a GPU" in str(e.value)


def test_script_fails_without_accelerator():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout, p.stdout


def test_tone_check_passes_on_wav(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(int(FS)) / FS
    x = 0.5 * np.sin(2 * np.pi * 400.0 * t) + 1e-4 * rng.standard_normal(
        len(t))
    path = str(tmp_path / "tone.wav")
    _write_wav(path, x)
    fs, y = chip_smoke.read_wav(path)
    assert fs == FS and len(y) == len(t)
    db = chip_smoke.check_tone("t", y[len(y) // 2:], fs, 400.0)
    assert db >= chip_smoke.TONE_FLOOR_DB


@pytest.mark.parametrize("case", ["noise", "wrong_freq"])
def test_tone_check_rejects(tmp_path, case):
    rng = np.random.default_rng(1)
    t = np.arange(int(FS)) / FS
    x = 0.1 * rng.standard_normal(len(t))
    if case == "wrong_freq":
        x = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    path = str(tmp_path / "x.wav")
    _write_wav(path, x)
    fs, y = chip_smoke.read_wav(path)
    with pytest.raises(AssertionError):
        chip_smoke.check_tone("t", y, fs, 400.0)


def test_quiet_channel_level():
    rng = np.random.default_rng(2)
    t = np.arange(int(FS)) / FS
    noise = rng.standard_normal(len(t))
    quiet = chip_smoke.level_over_band(noise, FS, [300.0, 500.0],
                                       chip_smoke.QUIET_BAND_HZ)
    loud = chip_smoke.level_over_band(
        noise + 0.5 * np.sin(2 * np.pi * 300.0 * t), FS, [300.0, 500.0],
        chip_smoke.QUIET_BAND_HZ)
    assert quiet < chip_smoke.QUIET_DB < loud


def test_fit_snr_helper():
    rng = np.random.default_rng(3)
    t = np.arange(20000) / FS
    ref = np.sin(2 * np.pi * 700.0 * t)
    err = 1e-3 * rng.standard_normal(len(t))
    snr = chip_smoke.fit_snr_db(ref, 0.25 * ref + err)
    # the fit scales the test by ~4 onto ref, so the residual is ~4e:
    # SNR = var(ref) / (16 var(e))
    assert snr == pytest.approx(10 * np.log10(0.5 / 16e-6), abs=1.0)
    assert chip_smoke.fit_snr_db(ref, rng.standard_normal(len(t))) < 10.0


def test_expected_tones():
    assert chip_smoke.expected_tones(["AM", "NFM", "USB", "CW"]) == [
        400.0, 800.0, 1200.0, 700.0]


def test_replay_capture_fits_the_i8_wire(tmp_path):
    from pysdr_tpu.io import datfile
    path = str(tmp_path / "cap.dat")
    chip_smoke.write_replay_capture(path, chip_smoke.SMALL["bank4"],
                                    seconds=0.25)
    rd = datfile.DatReader(path)
    assert rd.header.dtype == "int8"
    x = rd.read_data(1 << 20)
    assert len(x) == int(0.25 * rd.srate)
    # four stations at 0.15 each plus AM peaks: inside full scale
    assert np.max(np.abs(x.real)) < 0.9 and np.max(np.abs(x.imag)) < 0.9


@pytest.mark.parametrize("extra", [[], ["--four"]], ids=["one", "four"])
def test_cpu_rehearsal_runs_every_phase(extra):
    """The whole script at toy sizes on CPU devices: every phase's
    plumbing and checks, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"]
                       + extra, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    assert "cpu rehearsal ok" in p.stdout
    assert '"ok"' not in p.stdout.splitlines()[-1]
