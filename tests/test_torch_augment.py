"""
The port's on-device augmentation against lidbox_tpu's, on the CPU.

The JAX package draws its random values from ``jax.random`` keys, which
torch cannot reproduce; each test below reproduces the JAX draws from the
same key and feeds them to the port's deterministic apply.

- Helpers of ``features/audio.py`` (RMS, the SNR mixers, FIR filtering,
  run-length smoothing, the energy VAD, remove_silence) against
  ``lidbox_tpu.features.audio``: atol 1e-6 (tests/test_on_device.py's
  budget); VAD decisions and run lengths exactly. fir_filter also against
  scipy.signal.lfilter in float64 (atol 1e-5).
- The stages (noise bank, noise mixing, speed change, VAD compaction, FIR,
  SpecAugment) against lidbox_tpu.data.on_device fed the same draws:
  atol 1e-6, exact for the noise bank, the lengths and the masks. The speed
  change rounds its positions as the JAX package's jitted program does:
  the measured max error against it is 0 on these draws, and both are
  within 1e-5 of a float64 evaluation (JAX's own test allows 5e-3 against
  a float64 oracle).
- The whole chain with every stage on and augment_prob 0.5 at b4 x 0.5 s,
  ``stft_method: "pallas"`` (JAX's kernel in interpret mode, the port's
  plain version): features within atol 1e-4 + rtol 1e-4, frame masks
  exact.
- The draws: ranges, the gate's share, and the keyed generator.
- The repaired fault: validation batches featurized through an augmenting
  fn each draw from their own generator, keyed (0, i).
"""
import os

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lidbox_tpu.data import on_device as jdev
from lidbox_tpu.features import audio as jaudio
from lidbox_tpu.features import io as jio
from lidbox_tpu_torch.data import on_device as tdev
from lidbox_tpu_torch.features import audio as taudio
from lidbox_tpu_torch.train.loop import keyed_generator

torch.set_num_threads(2)

RATE = 16000
ATOL = 1e-6


def t(x):
    return torch.as_tensor(np.array(x))


def speechlike(rng, batch, samples, gap=(2000, 4400)):
    """Tones in noise with a silent stretch (the VAD drops it)."""
    time = np.arange(samples) / RATE
    x = (np.sin(2 * np.pi * rng.uniform(150, 900, (batch, 1)) * time)
         + 0.2 * rng.normal(0, 1, (batch, samples)))
    x[:, gap[0]:gap[1]] = 0.0
    return (0.5 * x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = speechlike(rng, 4, 8000)
    lengths = np.array([8000, 7777, 6000, 3001], np.int32)
    noise = rng.normal(0, 0.3, (4, 8000)).astype(np.float32)
    mask = np.arange(8000)[None, :] < lengths[:, None]
    return x, lengths, noise, mask


def _helper_cases(x, lengths, noise, mask):
    snr = np.array([5.0, 10.0, 15.5, 20.0], np.float32)
    fir = np.random.default_rng(1).normal(0, 1, 10).astype(np.float32)
    bits = np.array([1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1], bool)
    return {
        "dBFS_to_linear": (lambda m: m.dBFS_to_linear(-25.0), ()),
        "root_mean_square": (lambda m, a: m.root_mean_square(a, axis=-1),
                             (x,)),
        "masked_rms": (lambda m, a, k: m._masked_rms(a, k, axis=-1,
                                                     keepdims=True),
                       (x, mask)),
        "snr_mixer": (lambda m, c, n: m.snr_mixer(c, n, 12.5),
                      (x[0], noise[0])),
        "snr_mixer_batch": (lambda m, c, n, s, k: m.snr_mixer_batch(
            c, n, s, mask=k), (x, noise, snr, mask)),
        "fir_filter": (lambda m, a, f: m.fir_filter(a, f), (x[1], fir)),
        "run_length_encoding": (lambda m, b: m.run_length_encoding(b),
                                (bits,)),
        "invert_too_short": (
            lambda m, b: m.invert_too_short_consecutive_false(b, 3), (bits,)),
        "vad_decisions": (lambda m, a: m.framewise_rms_energy_vad_decisions(
            a, RATE, 10, min_non_speech_ms=60, strength=0.1), (x[0],)),
        "vad_decisions_batch": (
            lambda m, a, n: m.framewise_rms_energy_vad_decisions_batch(
                a, n, RATE, 10, min_non_speech_ms=60, strength=0.1),
            (x, lengths)),
        "remove_silence": (lambda m, a: m.remove_silence(
            a, RATE, min_non_speech_ms=100), (x[2],)),
    }


HELPERS = list(_helper_cases(*[np.zeros((4, 8000), np.float32)] * 4))


@pytest.mark.parametrize("name", HELPERS)
def test_audio_helper_matches_jax(data, name):
    fn, args = _helper_cases(*data)[name]
    ours = fn(taudio, *[t(a) for a in args])
    ref = fn(jaudio, *[jnp.asarray(a) for a in args])
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape, (o.shape, r.shape)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, atol=ATOL, rtol=0)


def test_fir_filter_is_lfilter(data):
    x = data[0]
    firs = np.random.default_rng(2).normal(0, 1, (4, 10)).astype(np.float32)
    out = taudio.fir_filter(t(x), t(firs)).numpy()
    for i in range(4):
        ref = scipy.signal.lfilter(firs[i].astype(np.float64), 1.0,
                                   x[i].astype(np.float64))
        np.testing.assert_allclose(out[i], ref, atol=1e-5)
    gen = torch.Generator().manual_seed(3)
    one = taudio.random_gaussian_fir_filter(gen, t(x[0]), 10)
    taps = torch.randn(10, generator=torch.Generator().manual_seed(3))
    assert torch.equal(one, taudio.fir_filter(t(x[0]), taps))


@pytest.fixture(scope="module")
def noise_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(4)
    paths = []
    for i, seconds in enumerate((0.3, 0.7, 1.0)):
        p = root / "sub" / f"n{i}.wav" if i else root / f"n{i}.wav"
        p.parent.mkdir(exist_ok=True)
        jio.write_mono_wav(str(p), rng.uniform(-0.6, 0.6, int(RATE * seconds))
                           .astype(np.float32), RATE)
        paths.append(str(p))
    return root, paths


@pytest.fixture(scope="module")
def banks(noise_files):
    _, paths = noise_files
    ours = tdev.build_noise_bank(paths, RATE, max_seconds=1.0, device="cpu")
    ref = jdev.build_noise_bank(paths, RATE, max_seconds=1.0)
    return ours, ref


def test_noise_bank_matches_jax(banks):
    (ours, our_len), (ref, ref_len) = banks
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(our_len.numpy(), np.asarray(ref_len))
    assert our_len.tolist() == [int(RATE * 0.3), int(RATE * 0.7), RATE]


def jax_noise_draws(key, batch, bank, samples, snr_range):
    k_idx, k_snr, k_off = jax.random.split(key, 3)
    idx = jax.random.randint(k_idx, (batch,), 0, bank.shape[0])
    snr = jax.random.uniform(k_snr, (batch,), minval=snr_range[0],
                             maxval=snr_range[1])
    off = jax.random.randint(k_off, (batch,), 0, bank.shape[1] - samples + 1)
    return t(idx).long(), t(snr), t(off).long()


@pytest.mark.parametrize("masked", [False, True])
def test_mix_noise_matches_jax(data, banks, masked):
    x, lengths = data[0][:, :6000], data[1].clip(max=6000)
    (ours, _), (ref, ref_len) = banks
    for seed in range(3):
        key = jax.random.PRNGKey(10 + seed)
        expected = np.asarray(jdev.mix_noise_from_bank(
            key, jnp.asarray(x), ref, ref_len, (5.0, 20.0),
            lengths=jnp.asarray(lengths) if masked else None))
        got = tdev.mix_noise_from_bank(
            t(x), ours, *jax_noise_draws(key, 4, ref, 6000, (5.0, 20.0)),
            lengths=t(lengths) if masked else None).numpy()
        np.testing.assert_allclose(got, expected, atol=ATOL, rtol=0)


def test_speed_change_matches_jax(data):
    """Against the JAX package's jitted speed change (the form its train
    step runs, where XLA rounds each position once): the same positions,
    weights and lengths. Both stay within 1e-5 of a float64 evaluation of
    the same interpolation, where the unjitted JAX function, which rounds
    i * ratio first, is 3.8e-4 away."""
    x, lengths = data[0], data[1]
    worst = oracle_worst = 0.0
    jitted = jax.jit(jdev.random_speed_change_batch, static_argnums=3)
    for seed, speed_range in ((0, (0.9, 1.1)), (1, (0.85, 1.3)),
                              (2, (0.5, 2.0))):
        key = jax.random.PRNGKey(20 + seed)
        out, new_len = jitted(key, jnp.asarray(x), jnp.asarray(lengths),
                              speed_range)
        ratio = np.asarray(jax.random.uniform(
            key, (4,), minval=speed_range[0], maxval=speed_range[1]))
        ours, our_len = tdev.random_speed_change_batch(t(x), t(lengths),
                                                       t(ratio))
        ours = ours.numpy()
        np.testing.assert_array_equal(our_len.numpy(), np.asarray(new_len))
        worst = max(worst, float(np.abs(ours - np.asarray(out)).max()))
        pos = np.arange(8000)[None, :] * ratio.astype(np.float64)[:, None]
        lo = np.floor(pos).astype(np.int64)
        padded = np.pad(x.astype(np.float64), ((0, 0), (0, 1)))
        rows = np.arange(4)[:, None]
        exact = (padded[rows, np.clip(lo, 0, 8000)] * (1 - (pos - lo))
                 + padded[rows, np.clip(lo + 1, 0, 8000)] * (pos - lo))
        valid = np.arange(8000)[None, :] < our_len.numpy()[:, None]
        oracle_worst = max(oracle_worst, float(np.abs(
            np.where(valid, exact - ours, 0.0)).max()))
        assert not ours[~valid].any()
    assert worst <= ATOL, worst
    assert oracle_worst <= 1e-5, oracle_worst


@pytest.mark.parametrize("min_non_speech_ms", [0, 300])
def test_vad_compaction_matches_jax(data, min_non_speech_ms):
    x, lengths = data[0], data[1]
    out, new_len = jdev.energy_vad_compact_batch(
        jnp.asarray(x), jnp.asarray(lengths), RATE,
        min_non_speech_ms=min_non_speech_ms)
    ours, our_len = tdev.energy_vad_compact_batch(
        t(x), t(lengths), RATE, min_non_speech_ms=min_non_speech_ms)
    np.testing.assert_array_equal(our_len.numpy(), np.asarray(new_len))
    np.testing.assert_allclose(ours.numpy(), np.asarray(out), atol=ATOL,
                               rtol=0)
    if min_non_speech_ms == 0:  # the silent stretch went
        assert (our_len.numpy() < lengths).all()


def test_random_fir_matches_jax(data):
    x = data[0]
    key = jax.random.PRNGKey(5)
    expected = np.asarray(jdev.random_fir(key, jnp.asarray(x), 10))
    firs = jax.random.normal(key, (4, 10), jnp.float32)
    np.testing.assert_allclose(tdev.random_fir(t(x), t(firs)).numpy(),
                               expected, atol=ATOL, rtol=0)


def jax_spec_draws(key, shape, aug):
    B, T, C = shape
    keys = jax.random.split(key, 4)
    out = [None] * 4
    if aug.specaug_time_masks:
        out[0] = jax.random.randint(keys[0], (B, aug.specaug_time_masks), 0,
                                    max(T - 1, 1))
        out[1] = jax.random.randint(keys[1], (B, aug.specaug_time_masks), 0,
                                    aug.specaug_time_width + 1)
    if aug.specaug_freq_masks:
        out[2] = jax.random.randint(keys[2], (B, aug.specaug_freq_masks), 0,
                                    max(C - 1, 1))
        out[3] = jax.random.randint(keys[3], (B, aug.specaug_freq_masks), 0,
                                    aug.specaug_freq_width + 1)
    return tuple(None if v is None else t(v).long() for v in out)


@pytest.mark.parametrize("masks", [(2, 2), (1, 0), (0, 3)])
def test_spec_augment_matches_jax(masks):
    feats = np.random.default_rng(6).normal(0, 1, (3, 50, 24)).astype(
        np.float32)
    aug = tdev.AugmentConfig(specaug_time_masks=masks[0], specaug_time_width=10,
                             specaug_freq_masks=masks[1], specaug_freq_width=6)
    key = jax.random.PRNGKey(7)
    expected = np.asarray(jdev.spec_augment(
        key, jnp.asarray(feats), time_masks=masks[0], time_width=10,
        freq_masks=masks[1], freq_width=6))
    got = tdev.spec_augment(t(feats), *jax_spec_draws(key, feats.shape, aug))
    np.testing.assert_array_equal(got.numpy(), expected)


CHAIN = {"snr_range": [5, 20], "augment_prob": 0.5, "fir_coefs": 10,
         "speed_range": [0.9, 1.1], "vad": True,
         "specaug": {"time_masks": 2, "freq_masks": 2}}
FEATURES = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": 64},
            "stft_method": "pallas"}


def jax_chain_draws(key, aug, batch, samples, bank, feats_shape):
    """The JAX chain's draws from ``key``, in the port's draws layout
    (lidbox_tpu/data/on_device.py:362-409)."""
    k_gate, k_speed, k_noise, k_fir, k_spec = jax.random.split(key, 5)
    return {
        "gate": t(jax.random.bernoulli(k_gate, aug.augment_prob, (batch,))),
        "speed": t(jax.random.uniform(k_speed, (batch,),
                                      minval=aug.speed_range[0],
                                      maxval=aug.speed_range[1])),
        "noise": jax_noise_draws(k_noise, batch, bank, samples, aug.snr_range),
        "fir": t(jax.random.normal(k_fir, (batch, aug.fir_coefs),
                                   jnp.float32)),
        "spec": jax_spec_draws(k_spec, feats_shape, aug)}


@pytest.fixture(scope="module")
def chain(noise_files, banks):
    """Every stage on, b4 x 0.5 s, through both packages."""
    root, _ = noise_files
    conf = dict(FEATURES, on_device_augment=dict(
        CHAIN, noise_datadir=str(root), noise_max_seconds=1.0))
    ours = tdev.feature_fn_from_config(RATE, conf, device="cpu")
    ref = jdev.feature_fn_from_config(RATE, conf)
    # a 325 ms silence: longer than the VAD's 300 ms smoothing, so it goes
    x = speechlike(np.random.default_rng(8), 4, 8000, gap=(1000, 6200))
    key = jax.random.PRNGKey(9)
    saved = os.environ.get("LIDBOX_PALLAS_INTERPRET")
    os.environ["LIDBOX_PALLAS_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            jf, jm = jax.jit(ref)(key, jnp.asarray(x))
    finally:
        if saved is None:
            del os.environ["LIDBOX_PALLAS_INTERPRET"]
        else:
            os.environ["LIDBOX_PALLAS_INTERPRET"] = saved
    aug = tdev.augment_config_from_dict(CHAIN)
    draws = jax_chain_draws(key, aug, 4, 8000, banks[1][0], jf.shape)
    tf, tm = ours(None, t(x), draws=draws)
    return (np.asarray(jf), np.asarray(jm)), (tf.numpy(), tm.numpy()), draws


def test_whole_chain_matches_jax(chain):
    (jf, jm), (tf, tm), draws = chain
    gate = draws["gate"].numpy()
    assert gate.any() and not gate.all()  # both kinds of row
    assert tf.shape == jf.shape == (4, 48, 64)
    np.testing.assert_array_equal(tm, jm)
    assert not tm[:, -1].any()  # the VAD shortened every row
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-4)


def test_chain_runs_its_stages_in_order(noise_files):
    """on_stage reports each stage that ran, in the chain's order; with
    augment_prob 0 every row equals the clean chain's."""
    root, _ = noise_files
    aug = dict(CHAIN, noise_datadir=str(root), noise_max_seconds=1.0)
    fn = tdev.feature_fn_from_config(
        RATE, dict(FEATURES, on_device_augment=aug), device="cpu")
    x = t(speechlike(np.random.default_rng(10), 4, 8000))
    seen = []
    fn(torch.Generator().manual_seed(0), x, on_stage=seen.append)
    assert seen == ["draw", "vad", "speed", "noise", "fir", "features",
                    "specaug"]
    off = tdev.feature_fn_from_config(RATE, dict(FEATURES, on_device_augment=dict(
        aug, augment_prob=0.0)), device="cpu")
    clean = tdev.feature_fn_from_config(RATE, dict(FEATURES, on_device_augment={
        "vad": True, "speed_range": None}), device="cpu")
    gated, gm = off(torch.Generator().manual_seed(1), x)
    plain, pm = clean(None, x)
    assert torch.equal(gated, plain) and torch.equal(gm, pm)


def test_gate_keeps_whole_rows(noise_files, banks):
    """augment_prob 0.5: every row is either the augmented or the clean
    chain's row, and both occur (tests/test_on_device.py's check)."""
    root, _ = noise_files
    x = t(speechlike(np.random.default_rng(11), 16, 8000))
    aug = dict(CHAIN, vad=False, speed_range=None)
    fns = {p: tdev.feature_fn_from_config(RATE, dict(
        FEATURES, on_device_augment=dict(
            aug, augment_prob=p, noise_datadir=str(root),
            noise_max_seconds=1.0)), device="cpu")
        for p in (0.5, 1.0, 0.0)}
    augment = tdev.augment_config_from_dict(dict(aug, augment_prob=1.0))
    draws = tdev.draw_augmentation(torch.Generator().manual_seed(12),
                                   augment, 16, 8000, banks[0][0])
    draws["spec"] = tdev.draw_spec_augment(
        torch.Generator().manual_seed(13), augment, (16, 48, 64))
    gates = {0.5: torch.arange(16) % 3 == 0,
             0.0: torch.zeros(16, dtype=torch.bool)}
    outs = {p: fn(None, x, draws=dict(draws, **(
        {"gate": gates[p]} if p in gates else {}))) for p, fn in fns.items()}
    for i in range(16):
        expected = outs[1.0] if i % 3 == 0 else outs[0.0]
        assert torch.equal(outs[0.5][i], expected[i])
    assert not torch.equal(outs[1.0], outs[0.0])


def test_draws_ranges_and_gate_share():
    aug = tdev.augment_config_from_dict(dict(CHAIN, augment_prob=0.3))
    bank = torch.zeros(3, 9000)
    gen = torch.Generator().manual_seed(14)
    n = 20000
    d = tdev.draw_augmentation(gen, aug, n, 8000, bank)
    assert set(d) == {"gate", "speed", "noise", "fir"}
    assert abs(d["gate"].float().mean().item() - 0.3) < 0.015
    assert 0.9 <= d["speed"].min() and d["speed"].max() < 1.1
    idx, snr, off = d["noise"]
    assert 5.0 <= snr.min() and snr.max() < 20.0
    assert set(idx.unique().tolist()) == {0, 1, 2}
    assert off.min() == 0 and off.max() == 1000
    assert d["fir"].shape == (n, 10)
    assert abs(d["fir"].std().item() - 1.0) < 0.02
    ts, tw, fs, fw = tdev.draw_spec_augment(gen, aug, (n, 48, 64))
    assert ts.max() == 46 and tw.max() == 20 and fs.max() == 62
    assert fw.max() == 8 and min(ts.min(), tw.min(), fs.min(), fw.min()) == 0
    assert tdev.draw_augmentation(None, tdev.AugmentConfig(), 4, 8000) == {}


def test_keyed_generator_depends_on_its_key_only():
    def draw(*key):
        return torch.rand(4, generator=keyed_generator("cpu", *key))

    assert torch.equal(draw(42, 3, 7), draw(42, 3, 7))
    assert not torch.equal(draw(42, 3, 7), draw(42, 4, 7))
    assert not torch.equal(draw(42, 3, 7), draw(43, 3, 7))


def test_validation_batches_draw_their_own_augmentation(noise_files):
    """The repaired fault: _featurize_val gave an augmenting fn no
    generator. Batch i now draws from keyed_generator(device, 0, i), as
    the JAX package keys it fold_in(PRNGKey(0), i): two identical batches
    get different noise, and a second pass gets the same features."""
    root, _ = noise_files
    fn = tdev.feature_fn_from_config(RATE, dict(FEATURES, on_device_augment={
        "snr_range": [5, 20], "noise_datadir": str(root),
        "noise_max_seconds": 1.0}), device="cpu")
    x = speechlike(np.random.default_rng(15), 4, 8000)
    batches = [(x, np.arange(4)), (x, np.arange(4))]
    first = tdev._featurize_val(fn, batches, torch.device("cpu"))
    again = tdev._featurize_val(fn, batches, torch.device("cpu"))
    assert not torch.equal(first[0]["input"], first[1]["input"])
    for a, b in zip(first, again):
        assert torch.equal(a["input"], b["input"])
    assert torch.equal(first[1]["input"],
                       fn(keyed_generator("cpu", 0, 1), t(x)))


@pytest.mark.parametrize("case", ["datadir", "mp3", "empty", "no_source"])
def test_noise_sources_from_config(noise_files, tmp_path, case):
    root, paths = noise_files
    aug = {"snr_range": [5, 20], "noise_max_seconds": 1.0}
    if case == "datadir":  # wav files found recursively, in sorted order
        x = t(speechlike(np.random.default_rng(16), 4, 8000))
        found, listed = (tdev.feature_fn_from_config(RATE, dict(
            FEATURES, on_device_augment=dict(aug, **source)), device="cpu")(
                torch.Generator().manual_seed(17), x)
            for source in ({"noise_datadir": str(root)},
                           {"noise_paths": sorted(paths)}))
        assert torch.equal(found, listed)
        return
    if case == "mp3":  # an mp3 noise file reaches the mp3 decoder: an
        # undecodable one raises what the JAX package raises for it
        (tmp_path / "clip.mp3").write_bytes(b"")
        conf = dict(FEATURES, on_device_augment=dict(
            aug, noise_datadir=str(tmp_path)))
        with pytest.raises(Exception) as ref:
            jdev.feature_fn_from_config(RATE, conf)
        with pytest.raises(type(ref.value), match="mp3"):
            tdev.feature_fn_from_config(RATE, conf, device="cpu")
        return
    if case == "empty":
        aug["noise_datadir"] = str(tmp_path)
    with pytest.raises(ValueError, match="contains no|no noise source"):
        tdev.feature_fn_from_config(RATE, dict(FEATURES, on_device_augment=aug),
                                    device="cpu")
