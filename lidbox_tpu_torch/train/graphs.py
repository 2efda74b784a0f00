"""
One program per train step: the port's counterpart of ``jax.jit(step,
donate_argnums=0)`` and of the ``lax.scan`` over a group or an epoch
(``lidbox_tpu/train/loop.py:393-399``, ``lidbox_tpu/data/on_device.py:922-1195``).

A :class:`StepProgram` runs a *donating* train step body, one that writes the
new parameters, batch statistics and optimizer moments into the tensors of
the state it was given and the loss into a 0-dim buffer, and reads nothing
from the device on the host. On a CUDA device the body is captured once per
input signature as a CUDA graph, and each step is one replay:

1. the step's inputs are copied into the graph's static buffers (device to
   device: a staged batch, a slice of a cached stack, or a row gather of
   it written straight into the buffer, :class:`Gather`);
2. the optimizer's per-step scalars (Adam's bias corrections, a schedule's
   step size: ``GradientTransformation.scalars``) are filled into 0-dim
   device buffers, with the very floats the eager step computes;
3. the augmentation generator, one generator registered with the graph, is
   re-seeded on the host with the step's key (``loop.key_seed``: what
   ``keyed_generator`` seeds a fresh generator with);
4. the graph is replayed; the dropout generator, registered too, advances
   as the eager step advances it;
5. the loss is cloned out of its buffer, and the step counts (``state.step``
   and the optimizer's counts) advance on the host.

The kernels count their own launches on the card (``logmel.launch_counts``),
so a replay's launches count as an eager step's do, and so do the launches
of a capture's warm-up steps, which are real (``WARMUP_STEPS`` for each of
the process's ``captures``).

K steps of grouped dispatch or of a cached epoch are K replays with no host
read between them. The signature, the key of the cache (jit's cache), is
the shapes and dtypes of the inputs and which are absent (packed targets,
no example mask), whether the step tracks lengths, the number of optimizer
scalars and the dropout generator. A captured graph holds the addresses of
the state's tensors: a step given another state's tensors (a restore, a new
state) drops the graphs and captures again.

Capture follows PyTorch's rule: warm-up on a side stream, on a clone of
the state (so the state, its counts and every generator are as they were
before it), then ``torch.cuda.graph`` on that stream. The graph holds the
addresses of the kernel's cached operands, so it keeps them
(``logmel.holding_operands``). A failed capture or replay raises.

On the CPU the donating step runs eagerly, which is what the caller asked
for. Three cases run it eagerly on the card too, by rule, logged once: a
mesh (its collectives go through the host), ``remat``, and a model that
packs its recurrent layers by host lengths when the batch has a frame mask
(``packs_by_host_lengths``). Either way the state is written in place.
"""
import collections
from typing import NamedTuple

import torch

from lidbox_tpu_torch import get_logger
from lidbox_tpu_torch.ops import logmel
from lidbox_tpu_torch.train import optimizers

logger = get_logger("train.graphs")

# warm-up steps on the side stream before a capture (lazy set-up: library
# handles, algorithm choices, the kernel's cached bases); their kernel
# launches are real and count on the card like any other
WARMUP_STEPS = 2
# kind -> steps captured in this process; each ran WARMUP_STEPS warm-up
# steps ("fused" ones launch the log-Mel kernel once a step)
captures = collections.Counter()


class Gather(NamedTuple):
    """Rows ``rows`` of ``source`` along its first axis: a row replay's
    batch, gathered by ``index_select`` into the step's input buffer."""
    source: torch.Tensor
    rows: torch.Tensor

    @property
    def shape(self):
        return (self.rows.shape[0],) + tuple(self.source.shape[1:])

    @property
    def dtype(self):
        return self.source.dtype

    def materialize(self):
        return self.source.index_select(0, self.rows)

    def gather_into(self, out):
        torch.index_select(self.source, 0, self.rows, out=out)


def _materialized(inputs):
    return {k: v.materialize() if isinstance(v, Gather) else v
            for k, v in inputs.items()}


def packs_by_host_lengths(module):
    """True when a module (or one of its submodules) is marked
    ``packs_by_host_lengths``: its masked forward copies the lengths to the
    host (``pack_padded_sequence``), which a graph cannot capture."""
    return any(getattr(m, "packs_by_host_lengths", False)
               for m in module.modules())


def eager_reason(trainer, masked):
    """Why a step of ``trainer`` is not captured on the card, or None.
    ``masked``: the batch carries a frame mask."""
    if trainer.mesh is not None:
        return "a mesh: its collectives go through the host"
    if trainer.remat:
        return "remat: the recompute rewinds the dropout generator on the host"
    if masked and packs_by_host_lengths(trainer.model.module):
        return ("a frame-masked batch for a model that packs its recurrent "
                "layers by host lengths")
    return None


def state_tensors(state):
    """Every tensor of a TrainState, in a fixed order."""
    out = list(state.params.values()) + list(state.batch_stats.values())

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            out.append(node)
    walk(state.opt_state)
    return out


def _clone_state(state):
    def clone(node):
        if isinstance(node, dict):
            return {k: clone(v) for k, v in node.items()}
        if isinstance(node, list):
            return [clone(v) for v in node]
        if isinstance(node, tuple):
            return tuple(clone(v) for v in node)
        return node.clone() if isinstance(node, torch.Tensor) else node
    return state.replace(params=clone(state.params),
                         batch_stats=clone(state.batch_stats),
                         opt_state=clone(state.opt_state))


def advance(state):
    """The host side of one donated step: the counts one step on, the
    tensors the same objects."""
    return state.replace(step=state.step + 1,
                         opt_state=optimizers.advance_counts(state.opt_state))


class _Captured(NamedTuple):
    graph: object
    inputs: dict       # name -> static input buffer (absent inputs: None)
    scalars: list      # 0-dim float32 buffers, the optimizer's scalars
    loss: torch.Tensor
    operands: list     # the cached kernel operands the graph reads
    generator: object  # the dropout generator it registered (kept alive)


def _plain_batch(trainer, inputs, augment_generator):
    return inputs


class StepProgram:
    """A train step run as one program per input signature.

    ``kind``: "features" (fit's feature batches) or "fused" (waveform
    batches featurized in the step, ``on_device``). ``batch(trainer,
    inputs, augment_generator) -> batch``: the feature batch of a step's
    inputs (``inputs``, a dict of tensors with None for an absent one; by
    default the inputs are the batch). The step is the
    trainer's donating step (``Trainer._donating_step``): on the card
    captured and replayed, eagerly on the CPU and under the eager rules
    (``eager_reason``). ``augment``: the step draws its augmentation from a
    generator keyed (trainer seed, step, 7); ``masked``: its batch carries
    a frame mask whatever the inputs (a length-tracking feature fn).
    ``eager=True``: the functional ``Trainer._train_step`` instead, with a
    fresh ``keyed_generator``, the reference the graphs are held to.

    ``program(trainer, state, inputs, generator) -> (state, loss)``, the
    state returned holding the same tensors, written in place (new tensors
    with ``eager=True``). The program holds no reference to the trainer:
    its graphs live until ``release`` or as long as the trainer's
    ``_programs`` hold it."""

    def __init__(self, kind, batch=None, augment=False, masked=False,
                 eager=False):
        self.kind = kind
        self.batch = batch or _plain_batch
        self.augment = augment
        self.masked = masked
        self.eager = eager
        self._captured = {}
        self._held = None       # the state tensors the graphs captured
        self._pool = None
        self._side = None
        self._augment_gen = None
        self._logged = set()

    # -- dispatch -------------------------------------------------------------

    def __call__(self, trainer, state, inputs, generator=None):
        from lidbox_tpu_torch.train.loop import key_seed, keyed_generator
        if self.eager:
            augment_gen = (keyed_generator(trainer.device, trainer.seed,
                                           state.step, 7)
                           if self.augment else None)
            return trainer._train_step(
                state, self.batch(trainer, _materialized(inputs),
                                  augment_gen), generator)
        reason = eager_reason(trainer, self.masked
                              or inputs.get("input_mask") is not None)
        if reason is not None and reason not in self._logged:
            self._logged.add(reason)
            logger.info("train step runs eagerly: %s", reason)
        scalars = trainer.optimizer.scalars(state.opt_state)
        seed = key_seed(trainer.seed, state.step, 7) if self.augment else None
        if reason is None and self._graphed(trainer):
            loss = self._replay(trainer, state, inputs, generator, scalars,
                                seed)
        else:
            loss = self._run_eagerly(trainer, state, inputs, generator,
                                     scalars, seed)
        return advance(state), loss

    def _graphed(self, trainer):
        return trainer.device.type == "cuda"

    def _augment_generator(self, device, seed):
        """The program's augmentation generator, seeded with ``seed``."""
        if self._augment_gen is None:
            self._augment_gen = torch.Generator(device=device)
        return self._augment_gen.manual_seed(seed)

    def _body(self, trainer, state, inputs, generator, augment_gen, scalars,
              loss):
        trainer._donating_step(state, self.batch(trainer, inputs,
                                                 augment_gen),
                               generator, scalars, loss)

    def _run_eagerly(self, trainer, state, inputs, generator, scalars, seed):
        device = trainer.device
        loss = torch.zeros((), dtype=torch.float32, device=device)
        self._body(trainer, state, _materialized(inputs), generator,
                   self._augment_generator(device, seed) if self.augment
                   else None,
                   [torch.tensor(v, dtype=torch.float32, device=device)
                    for v in scalars], loss)
        return loss

    def release(self):
        """Drop the captured graphs, their memory pool and their buffers."""
        self._captured.clear()
        self._held = self._pool = self._side = None

    # -- graphs ---------------------------------------------------------------

    @staticmethod
    def signature(inputs, scalars, generator, masked):
        return (tuple(sorted((k, None) if v is None
                             else (k, tuple(v.shape), v.dtype)
                             for k, v in inputs.items())),
                len(scalars), masked, id(generator))

    def _replay(self, trainer, state, inputs, generator, scalars, seed):
        held = state_tensors(state)
        if self._held is None or len(held) != len(self._held) or any(
                a is not b for a, b in zip(held, self._held)):
            self._captured.clear()  # another state's tensors: capture anew
            self._held = held
        key = self.signature(inputs, scalars, generator, self.masked)
        entry = self._captured.get(key)
        if entry is None:
            entry = self._capture(trainer, state, inputs, generator, scalars,
                                  seed)
            self._captured[key] = entry
        for name, value in inputs.items():
            buf = entry.inputs[name]
            if isinstance(value, Gather):
                value.gather_into(buf)
            elif value is not None and value is not buf:
                buf.copy_(value)
        for buf, value in zip(entry.scalars, scalars):
            buf.fill_(value)
        if self.augment:
            self._augment_generator(trainer.device, seed)
        entry.graph.replay()
        return entry.loss.clone()

    @staticmethod
    def static_buffers(device, inputs, scalars):
        """(input buffers holding ``inputs``, 0-dim scalar buffers holding
        ``scalars``, a 0-dim loss buffer): a captured step's static
        tensors, outside the graph's memory pool."""
        static = {}
        for name, value in inputs.items():
            if value is None:
                static[name] = None
            elif isinstance(value, Gather):
                static[name] = value.materialize()
            else:
                static[name] = value.clone()
        buffers = [torch.tensor(v, dtype=torch.float32, device=device)
                   for v in scalars]
        return static, buffers, torch.zeros((), dtype=torch.float32,
                                            device=device)

    def _capture(self, trainer, state, inputs, generator, scalars, seed):
        device = trainer.device
        current = torch.cuda.current_stream(device)
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        side = self._side
        static, buffers, loss = self.static_buffers(device, inputs, scalars)
        augment_gen = (self._augment_generator(device, seed) if self.augment
                       else None)
        generators = [g for g in (generator, augment_gen) if g is not None]
        saved = [g.get_state() for g in generators]
        saved_default = torch.cuda.get_rng_state(device)
        warm = _clone_state(state)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                if augment_gen is not None:
                    augment_gen.manual_seed(seed)
                self._body(trainer, warm, static, generator, augment_gen,
                           buffers, loss)
        current.wait_stream(side)
        del warm
        for g, s in zip(generators, saved):
            g.set_state(s)
        torch.cuda.set_rng_state(saved_default, device)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # thread_local: the staging thread may pin and copy the next
        # batches meanwhile, which "global" would refuse
        with logmel.holding_operands([]) as operands, torch.cuda.graph(
                graph, pool=self._pool, stream=side,
                capture_error_mode="thread_local"):
            self._body(trainer, state, static, generator, augment_gen,
                       buffers, loss)
        if self._pool is None:
            self._pool = graph.pool()
        captures[self.kind] += 1
        return _Captured(graph, static, buffers, loss, operands, generator)
