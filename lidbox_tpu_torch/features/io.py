"""
Host-side audio IO: wav/mp3 decode, encode, resampling, header validation
and WebRTC VAD decisions, in numpy, scipy and the standard library
(counterpart of ``lidbox_tpu.features.io``; reference:
lidbox/features/audio.py:17-47, 77-97, 377-396).

These run on the host data-loading threads. Decoding goes through the
native library (``lidbox_tpu_torch.native``) when it builds, and through the
Python bodies below when it does not.
"""
import os
import wave

import numpy as np

try:
    import miniaudio as _miniaudio
except ImportError:  # optional dependency
    _miniaudio = None

try:
    import scipy.signal as _scipy_signal
except ImportError:
    _scipy_signal = None


def read_wav(path):
    """Decode a PCM wav file to (mono float32 signal in [-1, 1], sample_rate).

    Channels are merged by averaging, as tf.audio.decode_wav + mean
    (reference: lidbox/features/audio.py:17-23). 8/16/32-bit PCM. Uses the
    native decoder when it is available (ctypes drops the GIL, so
    thread-pool decode parallelizes); this Python body is the fallback."""
    from lidbox_tpu_torch import native
    if native.available():
        try:
            return native.read_wav(path)
        except ValueError:
            pass  # unusual wav layout: fall through to the Python parser
    with wave.open(str(path), "rb") as f:
        nch = f.getnchannels()
        width = f.getsampwidth()
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width} in {path}")
    if nch > 1:
        data = data.reshape(-1, nch).mean(axis=1)
    return data, rate


def read_mp3(path):
    """Decode an mp3 to (mono float32 signal, sample_rate)
    (reference: lidbox/features/audio.py:26-34, which used miniaudio).

    Prefers the native decoder (the system libmpg123 through
    ``lidbox_tpu_torch.native``); falls back to miniaudio when present."""
    from lidbox_tpu_torch import native
    if native.available() and native.mp3_supported():
        try:
            return native.read_mp3(path)
        except ValueError:
            if _miniaudio is None:
                raise
            # a stream the strict native decoder rejects (e.g. a
            # mid-stream format change): let miniaudio try
    if _miniaudio is None:
        raise ImportError(
            "mp3 decoding needs the native libmpg123 decoder or miniaudio; "
            "neither is available")
    audio = _miniaudio.mp3_read_file_f32(str(path))
    data = np.array(audio.samples, np.float32).reshape(-1, audio.nchannels)
    return data.mean(axis=1), audio.sample_rate


def read_audio(path):
    """Dispatch on file suffix."""
    p = str(path)
    if p.lower().endswith(".mp3"):
        return read_mp3(p)
    return read_wav(p)


def write_mono_wav(path, signal, sample_rate):
    """Encode a float32 [-1, 1] mono signal as 16-bit PCM wav
    (reference: lidbox/features/audio.py:77-85)."""
    signal = np.asarray(signal, np.float32)
    pcm = np.clip(signal * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(int(sample_rate))
        f.writeframes(pcm.tobytes())
    return path


def wav_to_pcm_data(signal, sample_rate):
    """(44-byte riff header, s16le PCM body) of the encoded signal, as used
    to feed WebRTC VAD (reference: lidbox/features/audio.py:88-97)."""
    signal = np.asarray(signal, np.float32)
    pcm = np.clip(signal * 32767.0, -32768, 32767).astype("<i2").tobytes()
    body_size = len(pcm)
    header = (b"RIFF" + (36 + body_size).to_bytes(4, "little") + b"WAVE"
              + b"fmt " + (16).to_bytes(4, "little")
              + (1).to_bytes(2, "little")            # PCM
              + (1).to_bytes(2, "little")            # mono
              + int(sample_rate).to_bytes(4, "little")
              + int(sample_rate * 2).to_bytes(4, "little")
              + (2).to_bytes(2, "little")
              + (16).to_bytes(2, "little")
              + b"data" + body_size.to_bytes(4, "little"))
    return header, pcm


def resample(signal, in_rate, out_rate):
    """FFT resampling, equal to scipy.signal.resample as used by the
    reference (lidbox/features/audio.py:37-47)."""
    if in_rate == out_rate:
        return np.asarray(signal, np.float32), out_rate
    if _scipy_signal is None:
        raise ImportError("scipy is required for resampling")
    new_num = int(len(signal) * out_rate / in_rate)
    return _scipy_signal.resample(np.asarray(signal), new_num).astype(np.float32), out_rate


def wav_header_is_valid(path):
    """RIFF magic + declared-data-fits-in-file check
    (reference: lidbox/features/audio.py:377-396).

    Chunk-aware on both paths: real-world wavs carry extra RIFF chunks
    (LIST/INFO, fact), so the header is not always 44 bytes; the check
    validates that the declared data chunk fits inside the file. Uses the
    native validator when available; the Python fallback parses via the
    stdlib wave module and never reads the file body."""
    from lidbox_tpu_torch import native
    if native.available():
        try:
            return native.wav_header_is_valid(path)
        except (RuntimeError, ValueError):
            pass  # fall through to the Python check
    try:
        with open(path, "rb") as f:
            if f.read(4) != b"RIFF":
                return False
        with wave.open(str(path), "rb") as f_in:
            body = f_in.getnframes() * f_in.getnchannels() * f_in.getsampwidth()
        # the minimal RIFF/fmt/data framing is 44 bytes; extra chunks only
        # grow the header, so >= catches truncation without rejecting them
        return body + 44 <= os.path.getsize(path)
    except (OSError, wave.Error, EOFError):
        return False


def get_webrtcvad_decisions(signal, sample_rate, vad_frame_ms=10,
                            aggressiveness=0, min_non_speech_frames=0):
    """WebRTC VAD decisions over non-overlapping windows, with short
    non-speech runs reverted to speech. PCM is computed internally (the
    reference's call passed swapped arguments, lidbox/data/steps.py:449-452).
    Requires the optional ``webrtcvad`` package."""
    try:
        import webrtcvad
    except ImportError as e:
        raise ImportError("webrtcvad is required for WebRTC VAD") from e
    _, pcm = wav_to_pcm_data(signal, sample_rate)
    vad_step = int(sample_rate * vad_frame_ms / 1000)
    vad_step_bytes = 2 * vad_step
    n = len(signal) // vad_step
    decisions = np.ones(n, dtype=bool)
    vad = webrtcvad.Vad(aggressiveness)
    non_speech_begin = -1
    for f_idx, i in enumerate(range(0, len(pcm) - len(pcm) % vad_step_bytes, vad_step_bytes)):
        if f_idx >= n:
            break
        if not vad.is_speech(pcm[i:i + vad_step_bytes], sample_rate):
            decisions[f_idx] = False
            if non_speech_begin < 0:
                non_speech_begin = f_idx
        else:
            if 0 <= non_speech_begin and f_idx - non_speech_begin < min_non_speech_frames:
                decisions[non_speech_begin:f_idx] = True
            non_speech_begin = -1
    return decisions
