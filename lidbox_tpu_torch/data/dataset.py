"""
Host-side streaming dataset (counterpart of ``lidbox_tpu.data.dataset``,
copied: the port imports nothing of lidbox_tpu).

A Dataset is a lazy, replayable stream of ``dict[str, np.ndarray | scalar]``
elements. Host threads do the IO-bound work (decode, chunk bookkeeping,
shuffling, caching); numerical feature work is batched onto the device by
``data.device_pipeline``. Every transformation returns a new Dataset and
iteration re-runs the whole chain (like tf.data, datasets are factories,
not exhausted iterators).

The disk cache (``cache_to_file``) writes the JAX package's format: pickle
records of ``batch_size`` elements and a ``<path>.done`` marker, so a cache
written by either package reads in the other.
"""
import collections
import itertools
import os
import pickle
import queue
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from lidbox_tpu_torch import RANDOM_SEED, get_logger

logger = get_logger("data")


class Dataset:
    """A replayable stream of element dicts."""

    def __init__(self, gen_factory):
        self._gen_factory = gen_factory

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_elements(elements):
        elements = list(elements)
        return Dataset(lambda: iter(elements))

    @staticmethod
    def from_dict_of_lists(init_data):
        """Columnar dict {key: [v0, v1, ...]} -> row elements, the analogue
        of Dataset.from_tensor_slices on the metadata dict
        (reference: lidbox/data/steps.py:776-800)."""
        keys = list(init_data.keys())
        n = len(init_data[keys[0]])
        for k in keys:
            if len(init_data[k]) != n:  # data validation must survive -O
                raise ValueError(
                    f"ragged init_data column {k!r}: "
                    f"{len(init_data[k])} rows vs {n}")

        def gen():
            for i in range(n):
                yield {k: init_data[k][i] for k in keys}
        return Dataset(gen)

    # -- transformations ----------------------------------------------------

    def map(self, fn, num_parallel_calls=None, deterministic=True):
        """Element-wise transform; with ``num_parallel_calls`` the function
        runs on a thread pool (the host analogue of tf.data's parallel map).

        ``deterministic=True`` (default) preserves element order by blocking
        on the oldest in-flight future — one straggler can idle the pool
        once the 2x window drains. ``deterministic=False`` yields results
        as they complete (tf.data's ``deterministic=False``), removing the
        head-of-line blocking for decode-heavy pipelines whose downstream
        shuffles anyway."""
        if num_parallel_calls in (None, 0, 1):
            def gen():
                for x in self._gen_factory():
                    yield fn(x)
            return Dataset(gen)

        if not deterministic:
            def gen_unordered():
                with ThreadPoolExecutor(max_workers=num_parallel_calls) as pool:
                    it = self._gen_factory()
                    pending = set()
                    try:
                        for x in itertools.islice(it, 2 * num_parallel_calls):
                            pending.add(pool.submit(fn, x))
                        while pending:
                            done, pending = wait(pending,
                                                 return_when=FIRST_COMPLETED)
                            for fut in done:
                                yield fut.result()
                                try:
                                    nxt = next(it)
                                except StopIteration:
                                    continue
                                pending.add(pool.submit(fn, nxt))
                    finally:
                        for f in pending:
                            f.cancel()
            return Dataset(gen_unordered)

        def gen_parallel():
            with ThreadPoolExecutor(max_workers=num_parallel_calls) as pool:
                window = collections.deque()
                it = self._gen_factory()
                try:
                    for x in itertools.islice(it, 2 * num_parallel_calls):
                        window.append(pool.submit(fn, x))
                    for x in it:
                        yield window.popleft().result()
                        window.append(pool.submit(fn, x))
                    while window:
                        yield window.popleft().result()
                finally:
                    for f in window:
                        f.cancel()
        return Dataset(gen_parallel)

    def filter(self, predicate):
        def gen():
            for x in self._gen_factory():
                if predicate(x):
                    yield x
        return Dataset(gen)

    def flat_map(self, fn):
        """fn(element) -> iterable of elements, flattened in order."""
        def gen():
            for x in self._gen_factory():
                yield from fn(x)
        return Dataset(gen)

    def shuffle(self, buffer_size, seed=None):
        """Buffered shuffle (reference: lidbox/data/steps.py:997-999)."""
        if buffer_size <= 0:
            return self

        def gen():
            rng = np.random.default_rng(RANDOM_SEED if seed is None else seed)
            buf = []
            for x in self._gen_factory():
                buf.append(x)
                if len(buf) >= buffer_size:
                    i = rng.integers(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf
        return Dataset(gen)

    def batch(self, batch_size, drop_remainder=False):
        """Stack consecutive elements into batched dicts. All arrays under a
        key must share a shape (use group_by_axis_length or padded_batch for
        ragged data)."""
        def gen():
            batch = []
            for x in self._gen_factory():
                batch.append(x)
                if len(batch) == batch_size:
                    yield _stack_elements(batch)
                    batch = []
            if batch and not drop_remainder:
                yield _stack_elements(batch)
        return Dataset(gen)

    def unbatch(self):
        def gen():
            for b in self._gen_factory():
                n = _batch_len(b)
                for i in range(n):
                    yield {k: v[i] for k, v in b.items()}
        return Dataset(gen)

    def prefetch(self, buffer_size=2):
        """Run the upstream pipeline in a background thread with a bounded
        queue, overlapping host decode and feature extraction with the
        consumer."""
        def gen():
            q = queue.Queue(maxsize=max(1, buffer_size))
            done = object()
            err = []
            stop = threading.Event()  # consumer abandoned the stream

            def _put(item):
                # never block forever: an abandoned consumer would otherwise
                # pin this thread and the suspended upstream on a full queue
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def worker():
                try:
                    for x in self._gen_factory():
                        if not _put(x):
                            return  # closes the upstream generator chain
                except BaseException as e:  # propagate into consumer
                    err.append(e)
                finally:
                    _put(done)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            try:
                while True:
                    x = q.get()
                    if x is done:
                        if err:
                            raise err[0]
                        return
                    yield x
            finally:
                stop.set()
                try:  # unblock a put stuck on the full queue right now
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
        return Dataset(gen)

    def take(self, n):
        def gen():
            yield from itertools.islice(self._gen_factory(), n)
        return Dataset(gen)

    def concatenate(self, other):
        def gen():
            yield from self._gen_factory()
            yield from other._gen_factory()
        return Dataset(gen)

    def cache_to_memory(self):
        store = []
        loaded = threading.Event()
        lock = threading.Lock()

        def gen():
            if loaded.is_set():
                yield from store
                return
            # only ONE iterator fills the cache; a concurrent second pass
            # streams the source independently instead of blocking on the
            # filler (which may be slow, or abandoned mid-epoch — holding a
            # lock across yields deadlocks any concurrent reader)
            if not lock.acquire(blocking=False):
                yield from self._gen_factory()
                return
            try:
                if loaded.is_set():
                    yield from store
                    return
                tmp = []
                for x in self._gen_factory():
                    tmp.append(x)
                    yield x
                store.extend(tmp)
                loaded.set()
            finally:
                lock.release()
        return Dataset(gen)

    def cache_to_file(self, path, batch_size=64):
        """Pickle-shard disk cache; first pass writes, later passes read
        (the analogue of tf.data's batched .cache(filename),
        reference: lidbox/data/steps.py:371-392).

        Elements are pickled in records of ``batch_size`` (one dump per
        record), matching the reference's batch-before-cache layout —
        per-element dumps are dominated by pickle call overhead on small
        elements. Old per-element cache files remain readable (a record is
        either a list of elements or a single element dict)."""
        path = str(path)
        batch_size = max(int(batch_size), 1)

        def gen():
            done_marker = path + ".done"
            if os.path.exists(done_marker):
                with open(path, "rb") as f:
                    while True:
                        try:
                            record = pickle.load(f)
                        except EOFError:
                            return
                        if isinstance(record, list):
                            yield from record
                        else:
                            yield record
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                record = []
                for x in self._gen_factory():
                    record.append(x)
                    if len(record) == batch_size:
                        pickle.dump(record, f,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                        record = []
                    yield x
                if record:
                    pickle.dump(record, f, protocol=pickle.HIGHEST_PROTOCOL)
            with open(done_marker, "w") as f:
                f.write("ok")
        return Dataset(gen)

    @staticmethod
    def sample_from_datasets(datasets, weights=None, seed=None):
        """Randomly interleave elements from several datasets until all are
        exhausted (reference augment merge: lidbox/data/steps.py:226-229)."""
        def gen():
            rng = np.random.default_rng(RANDOM_SEED if seed is None else seed)
            iters = [d._gen_factory() for d in datasets]
            w = np.asarray(weights if weights is not None else
                           [1.0 / len(iters)] * len(iters), np.float64)
            alive = list(range(len(iters)))
            while alive:
                probs = w[alive] / w[alive].sum()
                pick = rng.choice(len(alive), p=probs)
                try:
                    yield next(iters[alive[pick]])
                except StopIteration:
                    alive.pop(pick)
        return Dataset(gen)

    # -- consumption --------------------------------------------------------

    def __iter__(self):
        return self._gen_factory()

    def as_numpy_iterator(self):
        return self._gen_factory()

    def collect(self):
        return list(self._gen_factory())


def _stack_elements(elements):
    keys = elements[0].keys()
    out = {}
    for k in keys:
        vals = [e[k] for e in elements]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating, bool, np.bool_)):
            out[k] = np.asarray(vals)
        else:
            out[k] = list(vals)
    return out


def _batch_len(batch):
    for v in batch.values():
        try:
            return len(v)
        except TypeError:
            continue
    raise ValueError("cannot infer batch length")


def pick_bucket(value, buckets):
    """Smallest bucket >= value; values beyond the largest bucket round up
    to the next multiple of it. The one bucketing policy shared by host
    padded batching and the device feature extractor."""
    buckets = sorted(int(b) for b in buckets)
    for b in buckets:
        if value <= b:
            return b
    top = buckets[-1]
    return -(-int(value) // top) * top


def padded_batch(elements, key, pad_axis=0, buckets=None):
    """Stack ragged arrays under ``key`` by right-padding along ``pad_axis``
    to the max (or next bucket) length; adds ``<key>_length`` with the
    original lengths."""
    lengths = np.asarray([e[key].shape[pad_axis] for e in elements], np.int32)
    target = int(lengths.max())
    if buckets is not None:
        target = pick_bucket(target, buckets)
    out = []
    for e in elements:
        arr = e[key]
        n = arr.shape[pad_axis]
        if n > target:
            sl = [slice(None)] * arr.ndim
            sl[pad_axis] = slice(0, target)
            arr = arr[tuple(sl)]
        elif n < target:
            widths = [(0, 0)] * arr.ndim
            widths[pad_axis] = (0, target - n)
            arr = np.pad(arr, widths)
        out.append({**e, key: arr})
    batch = _stack_elements(out)
    batch[key + "_length"] = np.minimum(lengths, target)
    return batch
