"""rtl_tcp network source: protocol client + fake server + full app
chain (the network path to live RTL hardware — reference reaches
dongles over USB via librtlsdr, BUILD_RTL:37-99; here the dongle's
standard rtl_tcp server stands in)."""

import numpy as np

from pysdr_tpu import app as app_mod
from pysdr_tpu.io import rtltcp


def _am_iq(fs, n, offset_hz, audio_hz=400.0, amp=0.4):
    t = np.arange(n) / fs
    m = 0.5 * np.sin(2 * np.pi * audio_hz * t)
    return (amp * (1 + m) * np.exp(2j * np.pi * offset_hz * t)
            ).astype(np.complex64)


def test_rtltcp_handshake_commands_and_stream():
    fs = 256e3
    iq = _am_iq(fs, 1 << 16, offset_hz=60e3)
    srv = rtltcp.FakeRtlTcpServer(iq)
    try:
        src = rtltcp.RtlTcpSource("127.0.0.1", srv.port, fs=fs,
                                  fc=100e6, gain_db=28.0, ppm=-2)
        assert src.tuner == "R820T"
        x = src.read_data(1 << 15)
        assert x.dtype == np.complex64 and len(x) == 1 << 15
        # CU8 quantization floor: the stream matches the source signal
        err = x - iq[: 1 << 15]
        snr = 10 * np.log10(float(np.sum(np.abs(iq[:1 << 15]) ** 2))
                            / float(np.sum(np.abs(err) ** 2)))
        assert snr > 35.0, snr
        # packed fast path agrees
        xp = src.read_packed(4096)
        assert xp.shape == (4096, 2) and xp.dtype == np.float32
        # device bring-up commands arrived in setupSDR order
        src.set_gain(12.0)
        src.set_freq_correction(3.0)
        src.close()
        import time
        time.sleep(0.2)
        cmds = dict()
        for c, v in srv.commands:
            cmds.setdefault(c, []).append(v)
        assert cmds[rtltcp.CMD_SET_SAMPLE_RATE] == [int(fs)]
        assert int(100e6) in cmds[rtltcp.CMD_SET_FREQ]
        assert 280 in cmds[rtltcp.CMD_SET_GAIN]     # 28.0 dB -> 0.1 dB
        assert 120 in cmds[rtltcp.CMD_SET_GAIN]
        assert cmds[rtltcp.CMD_SET_FREQ_CORR][0] == (-2) & 0xFFFFFFFF
    finally:
        srv.stop()


def test_rtltcp_direct_sampling_autoswitch():
    """Tuning below 24 MHz auto-switches to direct sampling like
    librtlsdr (reference direct-sampling auto-switch,
    receiver.py:671-680)."""
    fs = 256e3
    srv = rtltcp.FakeRtlTcpServer(_am_iq(fs, 1 << 14, 10e3))
    try:
        src = rtltcp.RtlTcpSource("127.0.0.1", srv.port, fs=fs, fc=100e6)
        src.set_freq(7.0e6)            # HF -> direct sampling mode 2
        assert src.direct_sampling == 2
        src.set_freq(100e6)            # back to quadrature
        assert src.direct_sampling == 0
        src.close()
        import time
        time.sleep(0.2)
        ds = [v for c, v in srv.commands
              if c == rtltcp.CMD_SET_DIRECT_SAMPLING]
        assert ds == [2, 0]
    finally:
        srv.stop()


def test_rtltcp_overflow_drops_oldest():
    fs = 256e3
    srv = rtltcp.FakeRtlTcpServer(_am_iq(fs, 1 << 16, 60e3))
    try:
        src = rtltcp.RtlTcpSource("127.0.0.1", srv.port, fs=fs, fc=100e6,
                                  ring_samples=1 << 14)
        import time
        time.sleep(1.0)                # server floods the tiny ring
        assert src.dropped > 0
        x = src.read_data(1 << 12)     # stream still coherent
        assert len(x) == 1 << 12
        src.close()
    finally:
        srv.stop()


def test_app_rtltcp_full_chain(tmp_path):
    """--rtl-tcp through the COMPLETE app: fake dongle -> network CU8 ->
    executive -> AM demod -> wav carries the 400 Hz tone; the viewerless
    device model (gain/ppm) programs the dongle."""
    import wave

    fs = 256e3
    # the app derives foffset = min(0.25*fs, 120e3) = 64 kHz for 1 RX;
    # put the station AT the dial: offset from SDR center = +64 kHz
    iq = _am_iq(fs, 1 << 17, offset_hz=64e3)
    srv = rtltcp.FakeRtlTcpServer(iq, rate_sps=2 * fs)
    try:
        prefix = str(tmp_path / "net")
        args = app_mod.build_parser().parse_args(
            ["--rtl-tcp", f"127.0.0.1:{srv.port}", "--fs", "0.256",
             "--fc", "100.0", "--block", "4096", "--blocks", "8",
             "--rf-gain", "28", "--wav", prefix])
        a = app_mod.App(args)
        a.run()
        w = wave.open(prefix + "_rx0.wav")
        d = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(
            -1, w.getnchannels())[:, 0].astype(np.float32)
        assert len(d) >= 4096 * 6
        seg = d[len(d) // 2:]
        sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        pk = np.fft.rfftfreq(len(seg), 1.0 / w.getframerate())[
            5 + np.argmax(sp[5:])]
        assert abs(pk - 400.0) < 10.0, pk
        # the dongle was programmed: srate, center freq, manual gain
        cmds = [c for c, _ in srv.commands]
        assert rtltcp.CMD_SET_SAMPLE_RATE in cmds
        assert rtltcp.CMD_SET_FREQ in cmds
        assert (rtltcp.CMD_SET_GAIN, 280) in srv.commands
    finally:
        srv.stop()


def test_rtltcp_device_follow_retune():
    """An out-of-passband retune posted to the running app re-tunes the
    networked dongle (CMD_SET_FREQ with the new center)."""
    fs = 256e3
    iq = _am_iq(fs, 1 << 16, offset_hz=64e3)
    srv = rtltcp.FakeRtlTcpServer(iq, rate_sps=4 * fs)
    try:
        args = app_mod.build_parser().parse_args(
            ["--rtl-tcp", f"127.0.0.1:{srv.port}", "--fs", "0.256",
             "--fc", "100.0", "--block", "4096"])
        a = app_mod.App(args)
        a.ex.run(n_blocks=2)
        a.ex.post("retune", 0, 145.2e6)       # far outside the passband
        a.ex.run(n_blocks=4)
        a.source.close()
        import time
        time.sleep(0.2)
        freqs = [v for c, v in srv.commands if c == rtltcp.CMD_SET_FREQ]
        # startup tune + follow tune to the new center (dial - foffset)
        assert int(145.2e6 - 64e3) in freqs, freqs
    finally:
        srv.stop()


def test_probe_rtl_tcp(capsys):
    """python -m pysdr_tpu.probe --rtl-tcp dumps the server identity
    and a stream sample."""
    from pysdr_tpu import probe

    fs = 256e3
    srv = rtltcp.FakeRtlTcpServer(_am_iq(fs, 1 << 15, 60e3))
    try:
        rc = probe.main(["--rtl-tcp", f"127.0.0.1:{srv.port}"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "tuner=R820T" in out and "rms=" in out
    finally:
        srv.stop()


def test_rtltcp_auto_reconnect_survives_server_bounce():
    """A dropped rtl_tcp session re-establishes itself with capped
    retries and re-programs srate/freq/gain/ppm from the device-model
    state (reference watchdog.py:96-123 network retry discipline).
    The stream must survive a full server bounce mid-stream."""
    import time

    fs = 256e3
    iq = _am_iq(fs, 1 << 16, offset_hz=60e3)
    srv = rtltcp.FakeRtlTcpServer(iq)
    src = None
    srv2 = None
    try:
        src = rtltcp.RtlTcpSource(
            "127.0.0.1", srv.port, fs=fs, fc=100e6, gain_db=28.0,
            ppm=-2, timeout=1.0, reconnect=20, reconnect_wait=0.05,
            ring_samples=1 << 16)
        x1 = src.read_data(1 << 14, timeout=5.0)
        assert len(x1) == 1 << 14

        port = srv.port
        srv.stop()                      # bounce: kill the server...
        # a device command issued during the outage must not block the
        # caller (it is sent by the writer thread / recovered by the
        # reconnect re-program)
        t0 = time.monotonic()
        src.set_gain(7.0)
        assert time.monotonic() - t0 < 0.1
        time.sleep(0.2)
        srv2 = rtltcp.FakeRtlTcpServer(iq, port=port)   # ...and revive

        # the pump notices EOF and re-establishes on its own
        deadline = time.monotonic() + 10.0
        while src.reconnects == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert src.reconnects >= 1
        # the stream resumes: drain past any pre-bounce ring backlog,
        # then a fresh full block arrives from the new session
        src.read_data(src._rsize // 2, timeout=20.0)
        x2 = src.read_data(1 << 14, timeout=20.0)
        assert len(x2) == 1 << 14
        src.close()
        time.sleep(0.2)
        # the new session was re-programmed in setupSDR order from the
        # shadows: srate, freq, manual gain (latest = 7.0 dB), ppm
        cmds = dict()
        for c, v in srv2.commands:
            cmds.setdefault(c, []).append(v)
        assert cmds[rtltcp.CMD_SET_SAMPLE_RATE] == [int(fs)]
        assert int(100e6) in cmds[rtltcp.CMD_SET_FREQ]
        assert 70 in cmds[rtltcp.CMD_SET_GAIN]
        assert cmds[rtltcp.CMD_SET_FREQ_CORR][0] == (-2) & 0xFFFFFFFF
        src = None
    finally:
        if src is not None:
            src.close()
        if srv2 is not None:
            srv2.stop()


def test_rtltcp_outage_longer_than_consumer_timeout_survives():
    """A consumer's read timeout must not fire while the pump thread is
    mid-reconnect: the retry budget (attempts x backoff) can legitimately
    span the consumer's window, and aborting there would make the
    configured --rtl-tcp-retries budget unusable for any outage longer
    than one read timeout. The window counts only healthy-connection
    silence."""
    import threading
    import time

    fs = 256e3
    iq = _am_iq(fs, 1 << 15, offset_hz=60e3)
    srv = rtltcp.FakeRtlTcpServer(iq)
    src = None
    revived = []
    try:
        src = rtltcp.RtlTcpSource(
            "127.0.0.1", srv.port, fs=fs, fc=100e6, timeout=0.3,
            reconnect=60, reconnect_wait=0.2, ring_samples=1 << 14)
        src.read_data(1 << 12, timeout=5.0)
        port = srv.port
        srv.stop()                       # outage begins...

        def revive():
            time.sleep(2.5)              # ...and outlasts the 1 s reads
            revived.append(rtltcp.FakeRtlTcpServer(iq, port=port))
        t = threading.Thread(target=revive, daemon=True)
        t.start()
        # drain any ring backlog, then demand fresh data on a 1 s
        # consumer window — shorter than the outage. Pre-fix this raised
        # TimeoutError('no data for 1 s') while _re_establish was still
        # inside its retry budget.
        deadline = time.monotonic() + 20.0
        got = 0
        while got < (1 << 15) and time.monotonic() < deadline:
            got += len(src.read_data(1 << 12, timeout=1.0))
        t.join()
        assert got >= 1 << 15
        assert src.reconnects >= 1
    finally:
        if src is not None:
            src.close()
        srv.stop()
        for s in revived:
            s.stop()


def test_rtltcp_reconnect_exhaustion_raises_loudly():
    """A dead radio with reconnect retries exhausted must raise, not
    masquerade as a clean end-of-stream (the r4 fail-loudly invariant
    extends to the auto-reconnect path)."""
    import pytest

    fs = 256e3
    srv = rtltcp.FakeRtlTcpServer(_am_iq(fs, 1 << 15, 60e3))
    src = rtltcp.RtlTcpSource(
        "127.0.0.1", srv.port, fs=fs, fc=100e6, timeout=0.5,
        reconnect=2, reconnect_wait=0.05, ring_samples=1 << 15)
    try:
        src.read_data(1 << 13, timeout=5.0)
        srv.stop()                       # ...and never comes back
        with pytest.raises(ConnectionError, match="gave up"):
            # drain the backlog then demand more: the pump exhausts its
            # retries against the dead port and marks the source dead
            for _ in range(64):
                src.read_data(1 << 13, timeout=10.0)
    finally:
        src.close()


def test_rtltcp_manual_gain_set_mid_run_survives_reconnect():
    """set_gain() after an AGC-mode bring-up pins MANUAL gain across a
    reconnect's device re-program (the shadow must carry the mode, not
    just the value)."""
    import time

    fs = 256e3
    iq = _am_iq(fs, 1 << 15, 60e3)
    srv = rtltcp.FakeRtlTcpServer(iq)
    srv2 = None
    src = rtltcp.RtlTcpSource(          # gain_db=None -> tuner AGC
        "127.0.0.1", srv.port, fs=fs, fc=100e6, timeout=1.0,
        reconnect=20, reconnect_wait=0.05, ring_samples=1 << 15)
    try:
        src.set_gain(7.0)               # operator pins manual gain
        port = srv.port
        srv.stop()
        time.sleep(0.2)
        srv2 = rtltcp.FakeRtlTcpServer(iq, port=port)
        deadline = time.monotonic() + 10.0
        while src.reconnects == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert src.reconnects >= 1
        src.close()
        time.sleep(0.2)
        cmds = srv2.commands
        modes = [v for c, v in cmds if c == rtltcp.CMD_SET_GAIN_MODE]
        gains = [v for c, v in cmds if c == rtltcp.CMD_SET_GAIN]
        assert modes == [1], modes      # manual, not AGC
        assert 70 in gains
    finally:
        if srv2 is not None:
            srv2.stop()
