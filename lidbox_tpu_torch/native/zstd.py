"""
Zstandard decoding and CRC-32C for the Orbax reader (``train/orbax.py``),
bound via ctypes to ``native/zstd.cpp`` (host code, not a kernel).

The library is built with g++ at first use into
``lidbox_tpu_torch/_build/libzstd.so``. There is no fallback: a failed
build raises with the compiler's message, and no Python zstd package is
imported even where one exists, so every machine runs this decoder.
ctypes drops the GIL for the call, so threads decode in parallel.
"""
import ctypes
import os
import subprocess
import threading

from lidbox_tpu_torch.native import BUILD_DIR, build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd.cpp")
_LIB = os.path.join(BUILD_DIR, "libzstd.so")

_lib = None
_lock = threading.Lock()


def load_library():
    """The decoder library, built first when missing or stale; raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            build_library(_SRC, _LIB, flags=())
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"building {_SRC} failed:\n{e.stderr}") from e
        except OSError as e:  # no g++
            raise RuntimeError(f"building {_SRC} failed: {e}") from e
        lib = ctypes.CDLL(_LIB)
        lib.zs_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.zs_decompress.restype = ctypes.c_int
        lib.zs_error.argtypes = [ctypes.c_int]
        lib.zs_error.restype = ctypes.c_char_p
        lib.zs_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.zs_crc32c.restype = ctypes.c_uint32
        lib.zs_free.argtypes = [ctypes.c_void_p]
        lib.zs_free.restype = None
        _lib = lib
    return _lib


def decompress(data):
    """The content of every zstd frame in ``data`` (bytes), concatenated;
    raises ValueError on corrupt data or a failed content checksum."""
    lib = load_library()
    data = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    code = lib.zs_decompress(data, len(data), ctypes.byref(out),
                             ctypes.byref(n))
    if code != 0:
        raise ValueError(f"zstd: {lib.zs_error(code).decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.zs_free(out)


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``, as an int."""
    data = bytes(data)
    return int(load_library().zs_crc32c(data, len(data)))
