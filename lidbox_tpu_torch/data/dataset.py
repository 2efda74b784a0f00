"""
Host-side streaming dataset: the part of ``lidbox_tpu.data.dataset`` that
serving uses, copied (the port imports nothing of lidbox_tpu).

A Dataset is a replayable stream of ``dict[str, np.ndarray | scalar]``
elements; every transformation returns a new Dataset and iteration re-runs
the whole chain (like tf.data, datasets are factories, not exhausted
iterators).
"""
import queue
import threading

import numpy as np


class Dataset:
    """A replayable stream of element dicts."""

    def __init__(self, gen_factory):
        self._gen_factory = gen_factory

    def map(self, fn):
        """Element-wise transform."""
        def gen():
            for x in self._gen_factory():
                yield fn(x)
        return Dataset(gen)

    def flat_map(self, fn):
        """fn(element) -> iterable of elements, flattened in order."""
        def gen():
            for x in self._gen_factory():
                yield from fn(x)
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

    def __iter__(self):
        return self._gen_factory()


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
