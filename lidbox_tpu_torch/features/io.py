"""
Host-side wav IO in numpy and the standard library (counterpart of
``lidbox_tpu.features.io``; wav only — mp3 decoding is not ported).
"""
import wave

import numpy as np


def read_wav(path):
    """Decode a PCM wav file to (mono float32 signal in [-1, 1], sample_rate).

    Channels are merged by averaging, as tf.audio.decode_wav + mean
    (reference: lidbox/features/audio.py:17-23). 8/16/32-bit PCM."""
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


def read_audio(path):
    """Decode an audio file; only wav is supported by the port."""
    p = str(path)
    if p.lower().endswith(".mp3"):
        raise NotImplementedError("mp3 decoding is not ported (ROADMAP "
                                  "queue 1, item 8): convert to wav")
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
