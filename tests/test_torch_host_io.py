"""
The port's host IO against lidbox_tpu: the native C++ library, the audio IO
helpers, Kaldi ark/scp IO and the small feature helpers. The same files and
numpy inputs go through both packages.

Host IO is numpy (or the same C++ source) on both sides, so its outputs
must be exactly equal. The tensor helpers of ``features.audio`` are held to
the JAX functions within rtol 1e-6 (float32 rounding of the same formula).
"""
import ast
import ctypes
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lidbox_tpu
import lidbox_tpu.features as jfeatures
import lidbox_tpu.features.audio as jaudio
import lidbox_tpu_torch
import lidbox_tpu_torch.features as tfeatures
import lidbox_tpu_torch.features.audio as taudio
from lidbox_tpu import native as jnative
from lidbox_tpu import testutil
from lidbox_tpu.features import io as jio
from lidbox_tpu.features import kaldi_io as jkaldi
from lidbox_tpu_torch import native as tnative
from lidbox_tpu_torch.features import io as tio
from lidbox_tpu_torch.features import kaldi_io as tkaldi

RATE = 16000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's native library, loaded again where this process's
    first load lost a build race.

    ``lidbox_tpu.native`` builds ``libaudioio.so`` with ``g++ -o`` straight
    into its final path. A process that opens it while another process is
    still writing it marks the library unavailable for its whole life, and
    every JAX decode in that process takes the Python fallback. The port's
    loader builds into a temporary file and renames it, so the port's
    library loading while the JAX one does not means the JAX file was torn
    then: by now the other build has finished, and a fresh load sees the
    whole file. A JAX library that really cannot load stays unavailable,
    and the tests that compare with it fail."""
    if tnative.available() and not jnative.available():
        for _ in range(10):
            jnative._lib = None
            jnative._build_failed = False
            if jnative.load_library() is not None:
                break
            time.sleep(1.0)
    yield


def encode_mp3(path, signal, rate):
    """Encode a mono float32 signal as mp3 with the system libmp3lame."""
    lame = ctypes.CDLL("libmp3lame.so.0")
    lame.lame_init.restype = ctypes.c_void_p
    lame.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    lame.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    for name in ("lame_set_in_samplerate", "lame_set_num_channels",
                 "lame_set_mode"):
        getattr(lame, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lame.lame_init_params.argtypes = [ctypes.c_void_p]
    lame.lame_close.argtypes = [ctypes.c_void_p]
    gfp = lame.lame_init()
    lame.lame_set_in_samplerate(gfp, int(rate))
    lame.lame_set_num_channels(gfp, 1)
    lame.lame_set_mode(gfp, 3)  # MONO
    assert lame.lame_init_params(gfp) >= 0
    pcm = np.ascontiguousarray(signal, np.float32)
    buf = ctypes.create_string_buffer(int(1.25 * pcm.size) + 7200)
    ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = lame.lame_encode_buffer_ieee_float(gfp, ptr, ptr, pcm.size, buf,
                                           len(buf))
    assert n >= 0
    data = buf.raw[:n]
    n = lame.lame_encode_flush(gfp, buf, len(buf))
    data += buf.raw[:n]
    lame.lame_close(gfp)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_io")
    sig = testutil.noisy_sinewave(200, RATE, 0.2, 1.2, seed=3)
    wav = str(root / "tone.wav")
    jio.write_mono_wav(wav, sig, RATE)
    stereo = str(root / "stereo.wav")
    pcm = (np.clip(np.stack([sig, -0.5 * sig], 1), -1, 1) * 32767).astype("<i2")
    import wave
    with wave.open(stereo, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(RATE)
        f.writeframes(pcm.tobytes())
    truncated = str(root / "truncated.wav")
    with open(wav, "rb") as f:
        data = f.read()
    with open(truncated, "wb") as f:
        f.write(data[:len(data) // 2])
    junk = str(root / "junk.wav")
    with open(junk, "wb") as f:
        f.write(b"\x00" * 128)
    mp3 = encode_mp3(str(root / "tone.mp3"), sig, RATE)
    return {"sig": sig, "wav": wav, "stereo": stereo, "truncated": truncated,
            "junk": junk, "mp3": mp3, "root": root}


def test_native_builds_into_the_port_build_dir():
    """The port's library is its own copy, built by g++ into
    lidbox_tpu_torch/_build/, never next to the source."""
    assert tnative.available()
    assert tnative._LIB == os.path.join(ROOT, "lidbox_tpu_torch", "_build",
                                        "libaudioio.so")
    assert os.path.exists(tnative._LIB)
    assert not os.path.exists(os.path.join(ROOT, "lidbox_tpu_torch", "native",
                                           "libaudioio.so"))
    with open(os.path.join(ROOT, "lidbox_tpu", "native", "audioio.cpp")) as a, \
            open(os.path.join(ROOT, "lidbox_tpu_torch", "native",
                              "audioio.cpp")) as b:
        ref, ours = a.read(), b.read()
    # the same C++ below the header comment
    assert ref[ref.index("#include"):] == ours[ours.index("#include"):]


def test_native_never_loads_the_jax_library():
    """A process that decodes through the port maps only the port's
    libaudioio.so (lidbox_tpu blocked from import)."""
    code = "\n".join([
        "import os, sys, tempfile",
        "sys.modules['lidbox_tpu'] = None",
        "import numpy as np",
        "from lidbox_tpu_torch import native",
        "from lidbox_tpu_torch.features import io",
        "p = os.path.join(tempfile.mkdtemp(), 'x.wav')",
        "io.write_mono_wav(p, np.zeros(1600, np.float32), 16000)",
        "assert native.available() and io.read_wav(p)[1] == 16000",
        "print('MAPS', sorted({l.split()[-1] for l in open('/proc/self/maps')",
        "                      if l.rstrip().endswith('libaudioio.so')}))"])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    maps = ast.literal_eval(proc.stdout.split("MAPS", 1)[1].strip())
    assert maps == [os.path.join(ROOT, "lidbox_tpu_torch", "_build",
                                 "libaudioio.so")]


@pytest.mark.parametrize("what", ["wav", "stereo", "mp3", "read_audio_mp3"])
def test_decode_matches_jax_package(files, what, monkeypatch):
    """wav (mono, stereo) and mp3 (system libmpg123) decode bit-equal in
    both packages; the port's Python wav parser equals its native one."""
    reader = {"wav": "read_wav", "stereo": "read_wav", "mp3": "read_mp3",
              "read_audio_mp3": "read_audio"}[what]
    path = files["mp3" if "mp3" in what else what]
    ours, rate = getattr(tio, reader)(path)
    ref, ref_rate = getattr(jio, reader)(path)
    assert rate == ref_rate == RATE
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if what in ("wav", "stereo"):
        monkeypatch.setenv("LIDBOX_NO_NATIVE", "1")
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_build_failed", False)
        python_parsed, _ = tio.read_wav(path)
        np.testing.assert_array_equal(python_parsed, ours)


def test_native_fallback_is_logged(caplog, monkeypatch):
    """Without the native library (LIDBOX_NO_NATIVE) the port logs that it
    uses the Python IO, as the JAX package does."""
    monkeypatch.setenv("LIDBOX_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    logger = lidbox_tpu_torch.get_logger()
    logger.addHandler(caplog.handler)
    try:
        assert not tnative.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            tnative.read_wav("x.wav")
    finally:
        logger.removeHandler(caplog.handler)
    assert any("pure-Python" in r.getMessage() for r in caplog.records)


def test_invalid_mp3_raises_like_jax(files, tmp_path):
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError) as ref:
        jio.read_mp3(str(bad))
    with pytest.raises(ValueError) as ours:
        tio.read_mp3(str(bad))
    assert str(ours.value) == str(ref.value)


def test_native_entry_points_match(files):
    sig = files["sig"]
    assert tnative.mp3_supported() == jnative.mp3_supported()
    assert tnative.mp3_info(files["mp3"]) == jnative.mp3_info(files["mp3"])
    np.testing.assert_array_equal(tnative.resample_linear(sig, RATE, 8000),
                                  jnative.resample_linear(sig, RATE, 8000))
    np.testing.assert_array_equal(tnative.rms_frames(sig, 160),
                                  jnative.rms_frames(sig, 160))


@pytest.mark.parametrize("name", ["wav", "stereo", "truncated", "junk",
                                  "missing"])
def test_wav_header_is_valid(files, name):
    path = files.get(name, str(files["root"] / "missing.wav"))
    assert tio.wav_header_is_valid(path) == jio.wav_header_is_valid(path)
    assert tio.wav_header_is_valid(path) == (name in ("wav", "stereo"))


@pytest.mark.parametrize("ratio", [0.9, 1.1, 1.0])
def test_resample_matches(files, ratio):
    sig = files["sig"]
    ours, rate = tio.resample(sig, int(ratio * RATE), RATE)
    ref, ref_rate = jio.resample(sig, int(ratio * RATE), RATE)
    assert rate == ref_rate
    np.testing.assert_array_equal(ours, ref)


def test_wav_to_pcm_data_and_write(files, tmp_path):
    sig = files["sig"]
    assert tio.wav_to_pcm_data(sig, RATE) == jio.wav_to_pcm_data(sig, RATE)
    tio.write_mono_wav(tmp_path / "t.wav", sig, RATE)
    jio.write_mono_wav(tmp_path / "j.wav", sig, RATE)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    header, _ = tio.wav_to_pcm_data(sig, RATE)
    assert struct.unpack("<I", header[24:28])[0] == RATE


def test_webrtcvad_absent_raises_the_same_import_error(files):
    with pytest.raises(ImportError) as ref:
        jio.get_webrtcvad_decisions(files["sig"], RATE)
    with pytest.raises(ImportError) as ours:
        tio.get_webrtcvad_decisions(files["sig"], RATE)
    assert str(ours.value) == str(ref.value)


def test_iter_metadata_file(tmp_path):
    p = tmp_path / "id2path"
    p.write_text("a /x/a.wav\nb /x/b c.wav\nbad\n\nc /x/c.wav\n")
    assert (list(lidbox_tpu_torch.iter_metadata_file(p, 2))
            == list(lidbox_tpu.iter_metadata_file(p, 2)))
    assert (list(lidbox_tpu_torch.iter_metadata_file(p, 3))
            == list(lidbox_tpu.iter_metadata_file(p, 3)))


def _mats(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return {f"utt{i:02d}": rng.normal(0, 1, (10 + 3 * i, 8)).astype(
        np.float32 if i % 2 == 0 else np.float64) for i in range(n)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kaldi_archives_read_across_packages(tmp_path, writer):
    """Archives written by either package read in both, bit-equal; the
    writers produce the same bytes."""
    mats = _mats()
    w_mod, r_mod = (jkaldi, tkaldi) if writer == "jax" else (tkaldi, jkaldi)
    spec = f"ark,scp:{tmp_path}/f.ark,{tmp_path}/f.scp"
    with w_mod.MatrixWriter(spec) as w:
        for k, m in mats.items():
            w(k, m)
    with jkaldi.MatrixWriter(f"ark:{tmp_path}/ref.ark") as w:
        for k, m in mats.items():
            w(k, m)
    assert (tmp_path / "f.ark").read_bytes() == (tmp_path / "ref.ark").read_bytes()
    entries = r_mod.read_scp(tmp_path / "f.scp")
    assert entries == w_mod.read_scp(tmp_path / "f.scp")
    for k, rx in entries:
        np.testing.assert_array_equal(r_mod.read_mat(rx), mats[k])
        ours = tfeatures.load_tensor_from_kaldi_archive(rx)
        ref = jfeatures.load_tensor_from_kaldi_archive(rx)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    for (k, m), (k2, m2) in zip(r_mod.read_ark(tmp_path / "f.ark"),
                                jkaldi.read_ark(tmp_path / "f.ark")):
        assert k == k2
        np.testing.assert_array_equal(m, m2)
    lazy = r_mod.load_scp(tmp_path / "f.scp")
    np.testing.assert_array_equal(lazy["utt01"], mats["utt01"])


@pytest.mark.parametrize("helper", ["peak_normalize", "peak_normalize_zero",
                                    "db_to_power", "fft_frequencies",
                                    "melspectrograms", "num_non_finite"])
def test_feature_helpers_match(helper):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.3, (2, 300)).astype(np.float32)
    if helper.startswith("peak_normalize"):
        if helper.endswith("zero"):
            x = np.zeros_like(x)
        ours = taudio.peak_normalize(torch.as_tensor(x), dBFS=-3.0).numpy()
        ref = np.asarray(jaudio.peak_normalize(x, dBFS=-3.0))
    elif helper == "db_to_power":
        ours = taudio.db_to_power(torch.as_tensor(40 * x)).numpy()
        ref = np.asarray(jaudio.db_to_power(40 * x))
    elif helper == "fft_frequencies":
        ours = taudio.fft_frequencies(RATE, 512, device="cpu").numpy()
        ref = np.asarray(jaudio.fft_frequencies(RATE, 512))
        assert ours.dtype == ref.dtype == np.float32
    elif helper == "melspectrograms":
        S = np.abs(rng.normal(0, 1, (2, 7, 257))).astype(np.float32)
        ours = taudio.melspectrograms(torch.as_tensor(S), RATE, num_mel_bins=24,
                                      fmin=20.0, fmax=7000.0).numpy()
        ref = np.asarray(jaudio.melspectrograms(S, RATE, num_mel_bins=24,
                                                fmin=20.0, fmax=7000.0))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
        return
    else:
        x[0, 3], x[1, 7], x[1, 8] = np.nan, np.inf, -np.inf
        ours = int(tfeatures.num_non_finite(torch.as_tensor(x)))
        assert ours == int(jfeatures.num_non_finite(x)) == 3
        return
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=HELPER_RTOL, atol=0)
    if helper == "peak_normalize":
        assert torch.device("cpu") == taudio.peak_normalize(
            torch.as_tensor(x)).device


def test_fft_frequencies_needs_cuda_when_asked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            taudio.fft_frequencies(RATE, 512)
