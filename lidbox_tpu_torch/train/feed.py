"""
The training feed that ``Trainer.fit`` and ``on_device.fit_signals`` drive
(one design for the feeds of ``lidbox_tpu.train.loop.Trainer.fit`` and
``lidbox_tpu.data.on_device.fit_signals``).

A ``Feed`` streams an epoch, staging the host batches on one producer
thread (``Trainer._staged``) past a mesh's feed-parity guard, or replays the
epoch-1 cache (``cache_staged``) from the device. Every step is one call of
the caller's ``step(state, inputs, generator) -> (state, loss)`` (a
``graphs.StepProgram``) on a dict of step inputs, a device tensor or None
per name. Their layout is the caller's: ``fit``'s feature batches ({input,
target, input_mask, example_mask}) or the fused path's waveforms ({signals,
targets, example_mask}, ``on_device``), staged by the caller's functions,
which also say where a cached stack's example rows are (``plain_rows``
where every batch of a stack is its B rows).
"""
import itertools

import numpy as np
import torch

from lidbox_tpu_torch import RANDOM_SEED, get_logger, parallel
from lidbox_tpu_torch.train import graphs

logger = get_logger("train.feed")


def to_device(value, device):
    """A numpy array or tensor on ``device``: host data bound for a CUDA
    device is pinned and copied with ``non_blocking`` on the current
    stream, so the copy is ordered before every later kernel of it."""
    t = torch.as_tensor(value)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _tree_device_nbytes(tree):
    """Bytes a staged tree (tensors and arrays in dicts, lists and tuples)
    pins: the staged-cache accounting unit, compared against
    _cache_budget_bytes."""
    if isinstance(tree, dict):
        return sum(_tree_device_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_device_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


def _cache_budget_bytes(limit=None, device=None):
    """Device memory available to ``cache_staged``: ``limit``
    (Trainer.cache_bytes_limit) when given, else on a CUDA device 90% of
    the total less what is in use (``torch.cuda.mem_get_info``), else +inf
    (the CPU)."""
    if limit is not None:
        return float(limit)
    if device is not None and torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return 0.9 * float(total) - float(total - free)
    return float("inf")


def _signature_runs_contiguous(sigs):
    """True when every distinct value in ``sigs`` appears as one contiguous
    run: then stack-major cached replay reproduces the original sequence
    exactly (``consolidate``)."""
    runs = 1 + sum(a != b for a, b in zip(sigs, sigs[1:]))
    return runs == len(set(sigs))


def grouped(batches, spd, signature):
    """Consecutive batches of one ``signature`` in lists of up to ``spd``
    (one stacked transfer each)."""
    buf, sig = [], None
    for b in batches:
        s = signature(b)
        if buf and s != sig:
            yield buf
            buf = []
        sig = s
        buf.append(b)
        if len(buf) == spd:
            yield buf
            buf = []
    if buf:
        yield buf


def step_inputs(stack, i):
    """Step ``i`` of a dict of stacked step inputs."""
    return {k: None if v is None else v[i] for k, v in stack.items()}


def consolidate(entries, stacked=False, preserve_order=False):
    """Staged entries, (count, step inputs) pairs, as per-shape device
    stacks for whole-epoch replay: a list of {"stack": name -> [K, ...]
    tensor or None, "counts": the K steps' counts}, one per step input
    signature, in order of first appearance. With ``stacked`` an entry is a
    group: [k, ...] inputs and a list of k counts. Consolidation holds the
    entries and the stacks at once (~2x the corpus); the caller releases
    the entries after.

    ``preserve_order=True`` (the cache_shuffle=False contract: replay epoch
    1's sequence exactly) returns None when the signatures interleave (e.g.
    padded buckets A, B, A), since stack-major replay would reorder them;
    the caller keeps per-entry replay."""
    lead = 1 if stacked else 0
    sigs = [tuple(sorted((k, None) if v is None
                         else (k, tuple(v.shape[lead:]), str(v.dtype))
                         for k, v in inputs.items()))
            for _, inputs in entries]
    if preserve_order and not _signature_runs_contiguous(sigs):
        return None
    groups = {}
    for (count, inputs), sig in zip(entries, sigs):
        g = groups.setdefault(sig, {"parts": [], "counts": []})
        g["parts"].append(inputs)
        g["counts"].extend(count if stacked else [count])
    join = torch.cat if stacked else torch.stack
    return [{"stack": {k: None if v is None else join([p[k] for p in
                                                      g["parts"]])
                       for k, v in g["parts"][0].items()},
             "counts": g["counts"]} for g in groups.values()]


def plain_rows(stack):
    """Where a stack's example rows are, for a rows replay: (B, name ->
    (source, R) or None), each source a stack [K, R, ...] seen as its K * R
    rows, so that row r of the corpus is row (r // B) * R + r % B of it. In
    a plain stack every batch is B examples: R == B."""
    B = next(v.shape[1] for v in stack.values() if v is not None)
    return B, {k: None if v is None
               else (v.reshape((-1,) + tuple(v.shape[2:])), B)
               for k, v in stack.items()}


class Feed:
    """The feed of one fit of ``trainer``: ``step(state, inputs,
    generator) -> (state, loss)`` over ``batches`` (a callable or a
    re-iterable collection of host batches). ``stage(batch)`` stages a host
    batch as step inputs, ``stage_group(batches)`` a list of same-signature
    ones as one transfer of [k, ...] stacked inputs; ``count(batch)`` gives
    its (rows, samples), ``signature(batch)`` what a group shares, ``rows``
    where a cached stack's example rows are.

    ``steps_per_dispatch`` batches go to a stacked transfer, an epoch stops
    at ``steps_per_epoch``; ``cache_staged`` keeps epoch 1 on the device as
    per-shape stacks, replayed in a fresh batch order (``cache_shuffle``
    True), with fresh batch compositions ("rows", from the global cache
    under a mesh) or in epoch 1's order (False; entry by entry where
    interleaved shapes would reorder it), held to the device's memory
    budget."""

    def __init__(self, trainer, step, batches, stage, stage_group, count,
                 signature, rows, steps_per_dispatch=1, steps_per_epoch=None,
                 cache_staged=False, cache_shuffle=True):
        self.trainer, self.step, self.batches = trainer, step, batches
        self.stage, self.stage_group = stage, stage_group
        self.count, self.signature, self.rows = count, signature, rows
        self.spd = max(1, int(steps_per_dispatch))
        self.steps_per_epoch = steps_per_epoch
        self.cache_staged, self.cache_shuffle = cache_staged, cache_shuffle
        self.stacks = None      # the cache: per-shape stacks,
        self.entries = None     # or epoch 1's entries, replayed in order
        self.cached_bytes = 0
        self.budget = None      # resolved at the first cached entry
        self.validation = None  # staged validation stacks (False: too big)
        # how many times its own rows a rank caches: the data size for a
        # mesh's rows replay, which runs from the global cache
        mesh = trainer.data_mesh
        self.rows_factor = (
            mesh.size if cache_shuffle == "rows"
            and parallel.mesh_spans_processes(mesh) else 1)

    @property
    def filling(self):
        """Whether the next epoch streams into the epoch-1 cache (a
        ``steps_per_epoch``-truncated epoch never does)."""
        return (self.cache_staged and self.steps_per_epoch is None
                and self.stacks is None and self.entries is None)

    def epoch(self, epoch):
        """Epoch ``epoch``'s steps, run as the iterator advances: yields
        (loss, rows, samples) after each step, the loss a 0-dim device
        tensor."""
        if self.stacks is not None:
            return self._replay(epoch)
        if self.entries is not None:
            return self._run(step for counts, inputs in self.entries
                             for step in self._split(counts, inputs))
        return self._stream()

    def _split(self, counts, inputs):
        """The (count, step inputs) pairs of a staged entry."""
        if self.spd == 1:
            return ((counts, inputs),)
        return ((c, step_inputs(inputs, i)) for i, c in enumerate(counts))

    def _run(self, steps):
        t = self.trainer
        for (rows, samples), inputs in steps:
            t.state, loss = self.step(t.state, inputs, t.generator)
            yield loss, rows, samples

    def _stream(self):
        t, spd = self.trainer, self.spd

        def batches():  # on the staging thread
            it = self.batches() if callable(self.batches) else self.batches
            if spd == 1:
                return it
            # a stacked group runs whole: cut the batches before grouping
            return grouped(itertools.islice(it, self.steps_per_epoch), spd,
                           self.signature)
        source = t._feed_parity_guard(t._staged(
            batches, put=self.stage_group if spd > 1 else self.stage,
            count_fn=((lambda g: [self.count(b) for b in g]) if spd > 1
                      else self.count)))
        collecting = [] if self.filling else None
        stop, steps = self.steps_per_epoch, 0
        try:
            for counts, inputs in source:
                if stop is not None and steps >= stop:
                    # one step a dispatch: the cut drops what the staging
                    # thread read past it (from a shared iterator too), as
                    # the JAX package's fit does
                    break
                if collecting is not None:
                    collecting.append((counts, inputs))
                    if not self._admit(inputs):
                        collecting = None
                if spd > 1:
                    steps += len(counts)
                    yield from self._run(self._split(counts, inputs))
                else:
                    steps += 1
                    t.state, loss = self.step(t.state, inputs, t.generator)
                    yield loss, *counts
        finally:
            # release the producer thread and its staged batches on every
            # exit (normal, a raising train step)
            source.close()
        if collecting:
            self._freeze(collecting)

    def _admit(self, inputs):
        """Count a cached entry against the device's memory budget; False,
        after a warning, once the cache no longer fits: consolidation
        holds the entries and the stacks at once (2x the staged bytes,
        1 + ranks x under a mesh's rows replay). Every epoch then streams,
        and so does validation."""
        self.cached_bytes += _tree_device_nbytes(inputs)
        if (1.0 + self.rows_factor) * self.cached_bytes <= self._budget():
            return True
        logger.warning(
            "cache_staged: staged training corpus (%.0f MB so far, ~2x "
            "transient during consolidation) exceeds the device memory "
            "budget (%.0f MB) — releasing the cache and streaming every "
            "epoch", self.cached_bytes / 1e6, self.budget / 1e6)
        self.cache_staged = False
        return False

    def _budget(self):
        """The cache's memory budget (``_cache_budget_bytes`` of
        ``Trainer.cache_bytes_limit``), resolved once; under a mesh the
        least over its ranks, so every rank takes the same cache-or-stream
        decision (the steps that follow it are collectives)."""
        if self.budget is None:
            t = self.trainer
            budget = _cache_budget_bytes(t.cache_bytes_limit, t.device)
            if parallel.mesh_spans_processes(t.mesh):
                budget = float(parallel.host_allgather(
                    np.float64(budget), t.mesh).min())
            self.budget = budget
        return self.budget

    def _freeze(self, entries):
        """Epoch 1's entries as the cache: per-shape stacks (their example
        rows for a rows replay), or the entries themselves where stacks
        would reorder a cache_shuffle=False replay."""
        stacks = consolidate(entries, stacked=self.spd > 1,
                             preserve_order=not self.cache_shuffle)
        if stacks is None:
            self.entries = entries
            return
        if self.cache_shuffle == "rows":
            for g in stacks:
                g["rows"] = self.rows(g.pop("stack"))
                if self.rows_factor > 1:
                    g["rows"] = self._global_rows(*g["rows"])
        self.stacks = stacks

    def _global_rows(self, B, view):
        """A mesh's rows replay: every rank's example rows of a stack
        gathered onto every rank ([K, ranks x B] rows a source, without
        padding rows), so a replayed batch can take rows other ranks
        cached, as the JAX package's flattened global cache does. Each rank
        then holds the whole corpus."""
        mesh = self.trainer.data_mesh
        out = {}
        for name, part in view.items():
            if part is not None:
                flat, R = part
                own = flat.reshape((-1, R) + tuple(flat.shape[1:]))[:, :B]
                every = parallel.all_gather_rows(own.transpose(0, 1),
                                                 mesh).transpose(0, 1)
                part = (every.reshape((-1,) + tuple(every.shape[2:])),
                        every.shape[1])
            out[name] = part
        return B * mesh.size, out

    def _replay(self, epoch):
        """A cached epoch: the stacks and their batches in a fresh order,
        or their rows in fresh batches, drawn from
        ``np.random.default_rng(RANDOM_SEED + epoch)`` as the JAX package
        draws them; with cache_shuffle=False in epoch 1's order."""
        rng = np.random.default_rng(RANDOM_SEED + epoch)
        shuffle = self.cache_shuffle
        n = len(self.stacks)
        for gi in (rng.permutation(n).tolist() if shuffle else range(n)):
            g = self.stacks[gi]
            K = len(g["counts"])
            if shuffle == "rows":
                yield from self._run(self._row_steps(g, rng))
            else:
                order = rng.permutation(K).tolist() if shuffle else range(K)
                yield from self._run((g["counts"][i],
                                      step_inputs(g["stack"], i))
                                     for i in order)

    def _row_steps(self, g, rng):
        """The steps of a rows replay of stack ``g``: ``idx``, drawn from
        ``rng``, is a host [K, B] permutation of its K * B example rows, and
        step k gathers rows idx[k] (this rank's columns under a mesh) on the
        device (``graphs.Gather``: on the card straight into the step's
        input buffer; no permuted copy). The only transfer is the index."""
        B, view = g["rows"]
        idx = rng.permutation(len(g["counts"]) * B).reshape(-1, B)
        if self.rows_factor > 1:  # the global cache's rows
            b, rank = B // self.rows_factor, self.trainer.data_mesh.rank
            idx = idx[:, rank * b:(rank + 1) * b]
        device = self.trainer.device
        at = {R: to_device((idx // B) * R + idx % B, device)
              for R in {part[1] for part in view.values()
                        if part is not None}}
        for k, count in enumerate(g["counts"]):
            yield count, {name: None if part is None
                          else graphs.Gather(part[0], at[part[1]][k])
                          for name, part in view.items()}

    def staged_validation(self, batches):
        """The validation set as per-shape stacks on the device, for
        ``Trainer.evaluate(..., staged=True)``: staged once through
        ``Trainer._staged``, on top of the cache, when twice its bytes
        (its consolidation) fit the budget. None (stream it) without
        ``cache_staged``, or, after a warning, when it does not fit.
        ``batches``: batch dicts, or a callable giving them."""
        if not self.cache_staged or self.validation is False:
            return None
        if self.validation is None:
            t = self.trainer
            entries = list(t._feed_parity_guard(t._staged(
                batches() if callable(batches) else batches), "validation"))
            vbytes = sum(_tree_device_nbytes(b) for _, b in entries)
            if self.cached_bytes + 2.0 * vbytes > self._budget():
                # keep the training cache (the bigger win)
                logger.warning(
                    "cache_staged: staged validation set (%.0f MB, ~2x "
                    "transient) on top of the training cache (%.0f MB) "
                    "exceeds the device memory budget (%.0f MB) — "
                    "streaming validation instead", vbytes / 1e6,
                    self.cached_bytes / 1e6, self.budget / 1e6)
                self.validation = False
                return None
            self.validation = consolidate(entries)
        return self.validation
