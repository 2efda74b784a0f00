"""16-bit PCM: what an int16 feed carries."""
import numpy as np


def pcm_values(signals):
    """What a 16-bit PCM feed carries, as floats: int16 samples over 32768;
    float waveforms in [-1, 1] first rounded to the nearest of x * 32768
    and clipped to the int16 range."""
    x = np.asarray(signals)
    if x.dtype == np.int16:
        return x.astype(np.float64) / 32768.0
    x = np.rint(x.astype(np.float64) * 32768.0)
    return np.clip(x, -32768, 32767) / 32768.0
