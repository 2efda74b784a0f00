"""
Dataset-agnostic metadata utilities over tables (counterpart of
``lidbox_tpu.meta.utils``; reference: lidbox/meta/utils.py).

A table is a dict of equal-length columns (lists, or numpy arrays for
numbers and flags) with a unique ``"id"`` column, where the JAX package
holds a pandas DataFrame indexed by utterance id. Required columns:
``id, path, label, split``; optional ``client_id`` (speaker),
``duration`` (seconds), ``target`` (int class). Functions that sort the
DataFrame index in the JAX package return tables sorted by ``"id"``; the
others keep the row order. The samplers draw what pandas'
``sample(..., random_state=)`` draws for the same ``random_state``, and
the per-label duration totals are Kahan sums, as pandas' groupby sum.
"""
import collections
import csv
import itertools
import math
import os
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REQUIRED_COLUMNS = ("path", "label", "split")
# Columns read from a CSV as strings whatever their content; the others
# become int64 or float64 arrays when every value parses as one, as
# pandas.read_csv infers them (pandas would also turn numeric ids into
# integers; ids stay strings here, as every table of this package has them).
STRING_COLUMNS = ("id", "path", "label", "split", "client_id")


def num_rows(table):
    return len(next(iter(table.values()))) if table else 0


def take_rows(table, rows):
    """The table's rows at the integer positions ``rows``, in that order."""
    rows = np.asarray(rows, np.intp)
    return {k: (v[rows] if isinstance(v, np.ndarray) else [v[i] for i in rows])
            for k, v in table.items()}


def where(table, column, value):
    """The rows whose ``column`` equals ``value``, in table order
    (``df[df[column] == value]``)."""
    return take_rows(table, [i for i, v in enumerate(table[column])
                             if v == value])


def sort_by_id(table):
    return take_rows(table, sorted(range(num_rows(table)),
                                   key=lambda i: table["id"][i]))


def set_unique_index(table, col="id"):
    """Check that ``col`` holds unique values (pandas' set_index with a
    uniqueness check) and return the table with it as ``"id"``, row order
    kept. Shared by the metadata loaders."""
    table = dict(table)
    if col != "id":
        table["id"] = table.pop(col)
    ids = [str(i) for i in table["id"]]
    dupes = [i for i, n in collections.Counter(ids).items() if n > 1]
    if dupes:
        raise ValueError(f"duplicate utterance ids, e.g. {dupes[:5]}")
    table["id"] = ids
    return table


def concat(tables):
    """Rows of ``tables`` one after another (``pd.concat(...,
    verify_integrity=True)``): duplicate ids raise. A column missing from a
    table is None in its rows."""
    tables = [t for t in tables if num_rows(t)]
    if not tables:
        return {}
    columns = list(dict.fromkeys(k for t in tables for k in t))
    out = {}
    for k in columns:
        parts = [t[k] if k in t else [None] * num_rows(t) for t in tables]
        if all(isinstance(p, np.ndarray) for p in parts):
            out[k] = np.concatenate(parts)
        else:
            out[k] = [v for p in parts for v in p]
    return set_unique_index(out)


def read_csv(path, delimiter=",", usecols=None):
    """A CSV file with a header row as a table: ``STRING_COLUMNS`` stay
    strings (an empty cell is None, pandas' NaN), other columns become
    int64 or float64 arrays when every value parses (an empty float cell
    is NaN), as ``pd.read_csv`` infers them."""
    with open(path, encoding="utf-8", newline="") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    keep = [i for i, h in enumerate(header) if usecols is None or h in usecols]
    table = {}
    for i in keep:
        values = [r[i] if i < len(r) else "" for r in body]
        table[header[i]] = ([v if v else None for v in values]
                            if header[i] in STRING_COLUMNS
                            else _infer_column(values))
    return table


def _infer_column(values):
    for dtype in (np.int64, np.float64):
        try:
            if dtype is np.int64:
                return np.asarray([int(v) for v in values], np.int64)
            return np.asarray([float(v) if v.strip() else math.nan
                               for v in values], np.float64)
        except ValueError:
            continue
    return values


def _is_missing(value):
    return value is None or (isinstance(value, (float, np.floating))
                             and math.isnan(value))


def verify_integrity(meta, max_threads=None):
    """Raise unless: all required columns present, no missing values, every
    audio path exists on disk (checked with a thread pool), and splits are
    disjoint by speaker ``client_id`` (reference:
    lidbox/meta/utils.py:21-50)."""
    missing = set(REQUIRED_COLUMNS) - set(meta)
    if missing:
        raise ValueError(f"{len(missing)} missing metadata columns: {sorted(missing)}")
    if any(_is_missing(v) for col in meta.values() for v in col):
        raise ValueError("NaNs in metadata")

    if max_threads is None or max_threads > 0:
        with ThreadPoolExecutor(max_workers=max_threads) as pool:
            exists = list(pool.map(os.path.exists, meta["path"], chunksize=100))
    else:
        exists = [os.path.exists(p) for p in meta["path"]]
    num_invalid = sum(not ok for ok in exists)
    if num_invalid:
        raise FileNotFoundError(f"{num_invalid} audio paths do not exist")

    if "client_id" in meta:
        split2spk = {}
        for split, spk in zip(meta["split"], meta["client_id"]):
            split2spk.setdefault(split, set()).add(spk)
        for a, b in itertools.combinations(split2spk, 2):
            common = split2spk[a] & split2spk[b]
            if common:
                raise ValueError(
                    f"splits {a!r} and {b!r} share {len(common)} speakers")


def _wav_duration(path):
    with wave.open(str(path), "rb") as f:
        return f.getnframes() / f.getframerate()


def _audio_duration(path):
    """Duration in seconds by suffix: wav header inspection, or an mpg123
    frame scan for mp3 (no decode; a full decode when the scan rejects the
    stream or libmpg123 is unavailable)."""
    if str(path).lower().endswith(".mp3"):
        from lidbox_tpu_torch import native
        if native.available() and native.mp3_supported():
            try:
                n, rate = native.mp3_info(path)
                return n / rate
            except ValueError:
                pass  # scan-rejected stream: fall through to a full decode
        from lidbox_tpu_torch.features import io as audio_io
        sig, rate = audio_io.read_mp3(path)
        return len(sig) / rate
    return _wav_duration(path)


def read_audio_durations(meta, max_threads=None, duration_fn=_audio_duration):
    """Duration in seconds for each row's audio file, threaded, in row
    order (reference: lidbox/meta/utils.py:53-67; any ``duration_fn(path)``
    can be plugged)."""
    paths = list(meta["path"])
    if max_threads is None or max_threads > 0:
        with ThreadPoolExecutor(max_workers=max_threads) as pool:
            durations = list(pool.map(duration_fn, paths, chunksize=1000))
    else:
        durations = [duration_fn(p) for p in paths]
    return np.asarray(durations, np.float32)


def _random_state(state):
    """pandas' ``common.random_state``: an int (or array, or bit generator)
    seeds a new RandomState, a RandomState or Generator is used as it is,
    None is numpy's global state."""
    if state is None:
        return np.random
    if isinstance(state, (np.random.RandomState, np.random.Generator)):
        return state
    return np.random.RandomState(state)


def _sample_rows(n_rows, n, replace, random_state):
    """Row positions of ``DataFrame.sample(n=n, replace=replace,
    random_state=random_state)`` on a frame of ``n_rows`` rows."""
    return _random_state(random_state).choice(
        n_rows, size=n, replace=replace).astype(np.intp, copy=False)


def _kahan_sum(values):
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total


def _duration_stats(meta):
    """{label: rows} in sorted label order, and each label's total and
    median duration (``groupby("label")`` sum and median)."""
    dur = np.asarray(meta["duration"], np.float64)
    rows = collections.defaultdict(list)
    for i, label in enumerate(meta["label"]):
        rows[label].append(i)
    rows = {label: rows[label] for label in sorted(rows)}
    total = {label: _kahan_sum(dur[r]) for label, r in rows.items()}
    median = {label: float(np.median(dur[r])) for label, r in rows.items()}
    return rows, total, median


def random_oversampling(meta, copy_flag="is_copy", random_state=None):
    """Duration-weighted random oversampling: duplicate rows (with
    replacement) per minority label until each label's total speech duration
    approaches the majority label's; copies get ids suffixed ``_copy_<n>``
    and ``is_copy=True`` (reference: lidbox/meta/utils.py:73-115).

    Sample counts = (duration deficit) / (median utterance duration of the
    label), as in the reference. Returns the table sorted by id.
    """
    if copy_flag not in meta:
        meta = dict(meta, **{copy_flag: np.zeros(num_rows(meta), bool)})
    rows, total, median = _duration_stats(meta)
    target_label = max(total, key=lambda label: total[label])
    copies = []
    for label in rows:
        n = int((total[target_label] - total[label]) / median[label])
        if label == target_label or n <= 0:
            continue
        picks = _sample_rows(len(rows[label]), n, True, random_state)
        sampled = take_rows(meta, np.asarray(rows[label])[picks])
        sampled["id"] = [f"{row_id}_copy_{i}"
                         for i, row_id in enumerate(sampled["id"])]
        sampled[copy_flag] = np.ones(n, bool)
        copies.append(sampled)
    if not copies:
        return sort_by_id(meta)
    return sort_by_id(concat(copies + [meta]))


def random_oversampling_on_split(meta, split, random_state=None):
    """Oversample only rows of one split, keep the rest untouched
    (reference: lidbox/meta/utils.py:118-122)."""
    meta = dict(meta, is_copy=np.zeros(num_rows(meta), bool))
    part = where(meta, "split", split)
    rest = take_rows(meta, [i for i, s in enumerate(meta["split"])
                            if s != split])
    return sort_by_id(concat([random_oversampling(
        part, random_state=random_state), rest]))


def random_undersampling(meta, target_label, random_state=None):
    """Duration-weighted undersampling: labels with more total speech than
    ``target_label`` are sampled down (without replacement) to
    target-duration / median-duration rows
    (reference: lidbox/meta/utils.py:125-152). Returns the table sorted by
    id."""
    rows, total, median = _duration_stats(meta)
    target_dur = total[target_label]
    sampled_parts, sampled_labels = [], []
    for label, label_dur in total.items():
        if label_dur > target_dur:
            n = int(target_dur / median[label])
            if n > len(rows[label]):
                raise ValueError(
                    f"sample size {n} larger than population {len(rows[label])}")
            picks = _sample_rows(len(rows[label]), n, False, random_state)
            sampled_parts.append(take_rows(meta,
                                           np.asarray(rows[label])[picks]))
            sampled_labels.append(label)
    if not sampled_parts:
        return sort_by_id(meta)
    rest = take_rows(meta, [i for i, label in enumerate(meta["label"])
                            if label not in sampled_labels])
    return sort_by_id(concat(sampled_parts + [rest]))


def random_undersampling_on_split(meta, split, target_label, random_state=None):
    """(reference: lidbox/meta/utils.py:155-158)"""
    part = where(meta, "split", split)
    rest = take_rows(meta, [i for i, s in enumerate(meta["split"])
                            if s != split])
    return sort_by_id(concat([random_undersampling(
        part, target_label, random_state=random_state), rest]))


def generate_label2target(meta):
    """Labels to integer targets by lexicographic enumeration; adds a
    ``target`` column (reference: lidbox/meta/utils.py:161-169)."""
    label2target = collections.OrderedDict(
        (label, target) for target, label in enumerate(sorted(set(meta["label"]))))
    meta = dict(meta, target=np.asarray(
        [label2target[l] for l in meta["label"]], np.int32))
    return meta, label2target
