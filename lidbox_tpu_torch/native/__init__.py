"""
Native (C++) host IO, bound via ctypes (a copy of ``lidbox_tpu.native``).

Audio decode, wav header validation, resampling and framewise RMS in
``native/audioio.cpp``: host code around the device path, not a kernel.
ctypes calls drop the GIL, so a Python thread pool decoding through this
library runs truly in parallel, which keeps the host loader ahead of the
device.

The library is built with g++ at first use into
``lidbox_tpu_torch/_build/libaudioio.so`` (never next to the source). Every
entry point has a pure-Python counterpart in ``features.io``, taken, with a
logged warning, when no compiler is present or ``LIDBOX_NO_NATIVE`` is set:
that is host IO, not a device fallback.
"""
import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from lidbox_tpu_torch import get_logger

logger = get_logger("native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "audioio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(BUILD_DIR, "libaudioio.so")

_lib = None
_lock = threading.Lock()
_build_failed = False


def build_library(src, lib, flags=("-march=native", "-funroll-loops")):
    """Compile ``src`` with g++ into the shared library ``lib`` when it is
    missing or older than its source; raises CalledProcessError (with the
    compiler's output) or OSError on failure."""
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", *flags, "-shared", "-fPIC", "-std=c++17", src,
           "-o", tmp]
    logger.info("Building native library: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if os.environ.get("LIDBOX_NO_NATIVE"):
        logger.warning("LIDBOX_NO_NATIVE is set; using pure-Python audio IO")
        _build_failed = True
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            build_library(_SRC, _LIB)
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.CalledProcessError) as e:
            logger.warning("native audio library unavailable (%s); "
                           "using pure-Python IO", e)
            _build_failed = True
            return None
        lib.la_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.la_read_wav.restype = ctypes.c_int
        lib.la_read_wav_into.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
        lib.la_read_wav_into.restype = ctypes.c_long
        lib.la_wav_header_is_valid.argtypes = [ctypes.c_char_p]
        lib.la_wav_header_is_valid.restype = ctypes.c_int
        lib.la_resample_linear.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.la_resample_linear.restype = ctypes.c_long
        lib.la_rms_frames.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        lib.la_rms_frames.restype = ctypes.c_long
        lib.la_read_mp3.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.la_read_mp3.restype = ctypes.c_int
        lib.la_mp3_supported.argtypes = []
        lib.la_mp3_supported.restype = ctypes.c_int
        lib.la_mp3_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int)]
        lib.la_mp3_info.restype = ctypes.c_int
        lib.la_free.argtypes = [ctypes.c_void_p]
        lib.la_free.restype = None
        _lib = lib
        logger.info("Loaded native audio library %s", _LIB)
    return _lib


def available():
    return load_library() is not None


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _take_samples(lib, out, n):
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.la_free(out)


def read_wav(path):
    """Decode a wav to (mono float32, sample_rate) natively; raises on
    failure (callers fall back to the Python decoder)."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    rate = ctypes.c_int()
    err = lib.la_read_wav(str(path).encode(), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(rate))
    if err != 0:
        raise ValueError(f"native wav decode failed ({err}) for {path}")
    return _take_samples(lib, out, n.value), rate.value


def mp3_supported():
    """True when the native mp3 decoder (system libmpg123) is usable."""
    lib = load_library()
    return lib is not None and bool(lib.la_mp3_supported())


def read_mp3(path):
    """Decode an mp3 to (mono float32, sample_rate) via the system
    libmpg123 (channel-mean mono, like the reference's read_mp3,
    lidbox/features/audio.py:26-34); raises on failure."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long()
    rate = ctypes.c_int()
    err = lib.la_read_mp3(str(path).encode(), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(rate))
    if err != 0:
        raise ValueError(f"native mp3 decode failed ({err}) for {path}")
    return _take_samples(lib, out, n.value), rate.value


def mp3_info(path):
    """(sample_count, sample_rate) of an mp3 via an mpg123 frame scan,
    without decoding."""
    lib = _require()
    n = ctypes.c_long()
    rate = ctypes.c_int()
    err = lib.la_mp3_info(str(path).encode(), ctypes.byref(n),
                          ctypes.byref(rate))
    if err != 0:
        raise ValueError(f"native mp3 scan failed ({err}) for {path}")
    return n.value, rate.value


def wav_header_is_valid(path):
    return bool(_require().la_wav_header_is_valid(str(path).encode()))


def resample_linear(signal, in_rate, out_rate):
    lib = _require()
    signal = np.ascontiguousarray(signal, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    m = lib.la_resample_linear(
        signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(signal), int(in_rate), int(out_rate), ctypes.byref(out))
    if m < 0:
        raise ValueError(f"native resample failed ({m})")
    return _take_samples(lib, out, m)


def rms_frames(signal, step):
    lib = _require()
    signal = np.ascontiguousarray(signal, np.float32)
    out = np.empty(len(signal) // step, np.float32)
    n = lib.la_rms_frames(
        signal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(signal), int(step),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if n < 0:
        raise ValueError("native rms failed")
    return out[:n]
