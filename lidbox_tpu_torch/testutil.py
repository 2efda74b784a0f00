"""
Synthetic audio generators and hypothesis strategies for tests and the
examples (a copy of ``lidbox_tpu.testutil``; reference: lidbox/testutil.py,
whose librosa tone/chirp generators are numpy here).
"""
import numpy as np


def sinewave(frequency, sample_rate, duration_sec, amplitude=1.0):
    t = np.arange(int(sample_rate * duration_sec), dtype=np.float64) / sample_rate
    return (amplitude * np.sin(2.0 * np.pi * frequency * t)).astype(np.float32)


def linear_chirp(fmin, fmax, sample_rate, duration_sec):
    t = np.arange(int(sample_rate * duration_sec), dtype=np.float64) / sample_rate
    phase = 2.0 * np.pi * (fmin * t + (fmax - fmin) * t * t / (2.0 * duration_sec))
    return np.sin(phase).astype(np.float32)


def peak_normalize_np(signal, dBFS=-3.0):
    peak = np.max(np.abs(signal))
    return (10.0 ** (dBFS / 20.0)) * signal / max(peak, 1e-12)


def noisy_sinewave(frequency, sample_rate, noise_level, duration_sec, seed=0):
    """Sine + uniform noise, peak normalized to -3 dBFS
    (reference: lidbox/testutil.py:16-21)."""
    rng = np.random.default_rng(seed)
    wave = sinewave(frequency, sample_rate, duration_sec)
    noise = noise_level * rng.uniform(-1, 1, wave.size).astype(np.float32)
    return peak_normalize_np(wave + noise)


def chirps(sample_rate, duration_sec, seed=0):
    """Noisy up/down chirps (reference: lidbox/testutil.py:22-26)."""
    rng = np.random.default_rng(seed)
    up = linear_chirp(200, sample_rate // 2 - 100, sample_rate, duration_sec)
    down = linear_chirp(sample_rate // 2 - 100, 200, sample_rate, duration_sec)
    noise = 0.1 * rng.uniform(-1, 1, up.size).astype(np.float32)
    return peak_normalize_np(up + noise), peak_normalize_np(down + noise)


# "Formant" center triplets (Hz) for the synthetic LID corpus: four
# languages whose spectral envelopes overlap enough that a trained model
# lands in the mid-accuracy regime, where training-semantics differences
# (initializers, optimizer epsilons, schedule handling) are visible in
# converged quality — the quality-parity experiment's corpus
# (tools/exp_quality_parity.py; BASELINE "C_avg parity" target).
LID_FORMANTS = {
    0: (500.0, 1500.0, 2500.0),
    1: (620.0, 1750.0, 2650.0),
    2: (450.0, 1250.0, 2850.0),
    3: (560.0, 1600.0, 2400.0),
}


def synthetic_lid_utterance(rng, formants, sample_rate=16000,
                            duration_sec=2.0, jitter=0.08,
                            noise_floor=0.35):
    """One synthetic 'utterance': noise-excited resonances at jittered
    language-specific formant frequencies, syllable-rate amplitude
    modulation, plus a white-noise floor. Class identity lives in the
    spectral envelope (like real LID cues), per-utterance variability in
    the formant jitter, bandwidths, modulation and noise draw."""
    n = int(sample_rate * duration_sec)
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    spec = np.fft.rfft(rng.normal(0.0, 1.0, n))
    env = np.zeros_like(freqs)
    for f0, amp in zip(formants, (1.0, 0.8, 0.6)):
        f = f0 * rng.uniform(1.0 - jitter, 1.0 + jitter)
        bw = rng.uniform(70.0, 140.0)
        env += amp * np.exp(-0.5 * ((freqs - f) / bw) ** 2)
    voiced = np.fft.irfft(spec * env, n)
    voiced /= np.std(voiced) + 1e-8
    t = np.arange(n) / sample_rate
    am = 0.55 + 0.45 * np.sin(2.0 * np.pi * rng.uniform(2.5, 6.5) * t
                              + rng.uniform(0.0, 2.0 * np.pi))
    sig = am * voiced + noise_floor * rng.normal(0.0, 1.0, n)
    return peak_normalize_np(sig.astype(np.float32))


def synthetic_lid_corpus(num_per_class, sample_rate=16000, duration_sec=2.0,
                         seed=0, num_classes=4, **kwargs):
    """[N, T] float32 signals + [N] int32 labels, num_per_class utterances
    per language (see synthetic_lid_utterance)."""
    rng = np.random.default_rng(seed)
    signals, labels = [], []
    for lang in range(num_classes):
        formants = LID_FORMANTS[lang % len(LID_FORMANTS)]
        for _ in range(num_per_class):
            signals.append(synthetic_lid_utterance(
                rng, formants, sample_rate, duration_sec, **kwargs))
            labels.append(lang)
    order = rng.permutation(len(labels))
    return (np.stack(signals)[order],
            np.asarray(labels, np.int32)[order])


def spectrogram_shapes():
    """Hypothesis strategy for random spectrogram batches, shape
    [1-10, 1-400, 1-100], values within ±1e3
    (reference: lidbox/testutil.py:29-35)."""
    from hypothesis import strategies as st
    from hypothesis.extra import numpy as st_np
    return st_np.arrays(
        np.float32,
        st.tuples(st.integers(1, 10), st.integers(1, 400), st.integers(1, 100)),
        elements=st.floats(-1e3, 1e3, width=32))
