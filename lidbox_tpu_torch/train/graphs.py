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
no example mask), the number of optimizer scalars, the dropout generator
and ``remat``. A captured graph holds the addresses of
the state's tensors: a step given another state's tensors (a restore, a new
state) drops the graphs and captures again.

Capture follows PyTorch's rule: warm-up on a side stream, on a clone of
the state (so the state, its counts and every generator are as they were
before it), then ``torch.cuda.graph`` on that stream. The graph holds the
addresses of the kernel's cached operands, so it keeps them
(``logmel.holding_operands``). A failed capture or replay raises.

On the CPU the donating step runs eagerly, which is what the caller asked
for. A mesh of several ranks runs it eagerly on the card too, by rule,
logged once (``forward_reason``); either way the state is written in place.
The rule is the same for every program of this module, train steps and
forwards alike (the eval step, ``Trainer.predict``, the batch predict fn of
``util.make_batch_predict_fn`` and the streaming chunk of
``serve.StreamingClassifier``). A one-rank mesh, ``remat`` and a
frame-masked batch of a recurrent model
are captured: at one rank every collective returns its input, the remat
recompute rewinds the dropout generator through a generator registered
with the graph (``Trainer._rewind_point``), and the recurrent layers read
their lengths on the device (``layers.run_rnn``).

A :class:`ForwardProgram` is the same for a served or evaluated forward,
the port's counterpart of the JAX package's ``jax.jit`` per shape (the
feature extractor, ``make_batch_predict_fn``, the streaming chunk, the eval
step and ``Trainer.predict``): a body ``fn(**inputs)`` captured once per
input signature and replayed, its inputs copied into the static buffers
first (from pinned host memory, or on the card) and its outputs cloned out
of the graph's before the next replay can overwrite them. It keys its
graphs on the identity of the tensors the body reads (a model's parameters
and buffers, a state's): weights updated in place are served by the next
replay, replaced tensors are captured anew. Both kinds of program share
the capture (:class:`_Programs`): warm-up on a side stream, one memory
pool per program, ``capture_error_mode="thread_local"``, the kernel's
operands held; a failed capture or replay raises.

Each run of a program is a span while a torch.profiler runs
(``observability.span``): ``lidbox.graph.replay``, ``lidbox.graph.capture``
(the warm-up steps and the capture) or ``lidbox.graph.eager``, with the
program's ``kind`` and the kernel launches it made on the card
(``launches``: for a replay, one replay's, tallied over the capture's
warm-up steps; for a capture, its warm-up steps'; for an eager run, those
tallied while it ran). A train step is a ``lidbox.step`` span around its
run, carrying its ``kind`` and ``step``.
"""
import collections
import functools
import threading
from typing import NamedTuple

import torch

from lidbox_tpu_torch import get_logger
from lidbox_tpu_torch.ops import logmel
from lidbox_tpu_torch.train import observability, optimizers

logger = get_logger("train.graphs")

# warm-up steps on the side stream before a capture (lazy set-up: library
# handles, algorithm choices, the kernel's cached bases); their kernel
# launches are real and count on the card like any other
WARMUP_STEPS = 2
# kind -> programs captured in this process ("fused" and "features" train
# steps; "features", "stream", "forward" and "eval" forwards); each ran
# WARMUP_STEPS warm-up steps
captures = collections.Counter()
# kernel -> its launches made by those warm-up steps ("fused" steps and
# log-Mel feature programs launch the kernel once a step), tallied on the
# host as they launch (``logmel.tallying_launches``)
warmup_launches = collections.Counter()
_count_lock = threading.Lock()


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


def forward_reason(mesh):
    """Why a program under ``mesh`` is not captured on the card, or None:
    the one rule for the train and eval steps, ``Trainer.predict``, the
    batch predict fn (``util.make_batch_predict_fn``) and the streaming
    chunk (``serve.StreamingClassifier``). Only a mesh of several ranks has
    collectives that do something (at one rank each returns its input):
    over gloo they copy every tensor through the host, and NCCL's capture
    of a multi-rank mesh cannot be checked on a one-card machine, where
    NCCL refuses two ranks on one card."""
    if mesh is not None and mesh.size > 1:
        return ("a mesh of several ranks: its collectives are not captured "
                "(gloo copies through the host; NCCL's capture needs a card "
                "a rank)")
    return None


def eager_reason(trainer):
    """Why a step of ``trainer`` is not captured on the card, or None:
    ``forward_reason`` of its mesh. A frame-masked batch, ``remat`` and a
    one-rank mesh are captured."""
    return forward_reason(trainer.mesh)


def state_tensors(state):
    """Every tensor of a TrainState, in a fixed order."""
    return (list(state.params.values()) + list(state.batch_stats.values())
            + tensors_of(state.opt_state))


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
    launches: dict     # kernel -> its launches in one replay
    rewind: object = None  # remat's rewind point, registered too


class _Programs:
    """What a step program and a forward program share: the graphs by
    signature, the tensors they were captured on, one memory pool and one
    side stream, and the capture itself."""

    def __init__(self, kind, eager):
        self.kind = kind
        self.eager = eager
        self._captured = {}
        self._held = None       # the tensors the graphs read, by identity
        self._pool = None
        self._side = None
        self._logged = set()

    def _log_eager(self, what, reason):
        if reason is not None and reason not in self._logged:
            self._logged.add(reason)
            logger.info("%s runs eagerly: %s", what, reason)

    def _hold(self, held):
        """Key the graphs on the identity of ``held``: other tensors (a
        restore, a new state, replaced weights) drop them. Holding the
        tensors keeps a freed tensor's address from coming back as
        another's."""
        if self._held is None or len(held) != len(self._held) or any(
                a is not b for a, b in zip(held, self._held)):
            self._captured.clear()
            self._held = held

    def release(self):
        """Drop the captured graphs, their memory pool and their buffers."""
        self._captured.clear()
        self._held = self._pool = self._side = None

    def _replayed(self, entry):
        """``entry.graph`` replayed, in a ``lidbox.graph.replay`` span."""
        with observability.span("lidbox.graph.replay", kind=self.kind,
                                launches=entry.launches):
            entry.graph.replay()

    def _eagerly(self, run):
        """``run()`` in a ``lidbox.graph.eager`` span, which carries the
        kernel launches tallied while it ran."""
        with observability.span("lidbox.graph.eager",
                                kind=self.kind) as span:
            if span is None:
                return run()
            with logmel.tallying_launches(
                    collections.Counter()) as launched:
                out = run()
            span.attrs["launches"] = dict(launched)
            return out

    def _graph(self, device, warm, body, generators=()):
        """``body()`` captured as a CUDA graph on the program's side stream
        into its memory pool, after ``WARMUP_STEPS`` calls of ``warm()``
        there (lazy set-up: library handles, algorithm choices, the
        kernel's cached bases), with ``generators`` and the device's
        default generator put back as they were before the warm-up and
        ``generators`` registered with the graph; in a
        ``lidbox.graph.capture`` span, which carries the warm-up steps'
        launches. Returns (graph, the kernel operands it reads, what
        ``body()`` returned: tensors of the graph's pool, which each replay
        writes, kernel -> its launches in one replay)."""
        with observability.span("lidbox.graph.capture",
                                kind=self.kind) as span:
            current = torch.cuda.current_stream(device)
            if self._side is None:
                self._side = torch.cuda.Stream(device)
            side = self._side
            saved = [g.get_state() for g in generators]
            saved_default = torch.cuda.get_rng_state(device)
            side.wait_stream(current)
            with torch.cuda.stream(side), logmel.tallying_launches(
                    collections.Counter()) as launched:
                for _ in range(WARMUP_STEPS):
                    warm()
            current.wait_stream(side)
            del warm
            for g, s in zip(generators, saved):
                g.set_state(s)
            torch.cuda.set_rng_state(saved_default, device)
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            # thread_local: a staging or prefetch thread may pin, copy and
            # launch meanwhile, which "global" would refuse
            with logmel.holding_operands([]) as operands, torch.cuda.graph(
                    graph, pool=self._pool, stream=side,
                    capture_error_mode="thread_local"):
                result = body()
            if self._pool is None:
                self._pool = graph.pool()
            with _count_lock:  # programs of other threads capture too
                captures[self.kind] += 1
                warmup_launches.update(launched)
            if span is not None:
                span.attrs["launches"] = dict(launched)
        return graph, operands, result, {
            k: n // WARMUP_STEPS for k, n in launched.items()}


def _plain_batch(trainer, inputs, augment_generator):
    return inputs


class StepProgram(_Programs):
    """A train step run as one program per input signature.

    ``kind``: "features" (fit's feature batches) or "fused" (waveform
    batches featurized in the step, ``on_device``). ``batch(trainer,
    inputs, augment_generator) -> batch``: the feature batch of a step's
    inputs (``inputs``, a dict of tensors with None for an absent one; by
    default the inputs are the batch). The step is the
    trainer's donating step (``Trainer._donating_step``): on the card
    captured and replayed, eagerly on the CPU and under the eager rules
    (``eager_reason``). ``augment``: the step draws its augmentation from a
    generator keyed (trainer seed, step, 7).
    ``eager=True``: the functional ``Trainer._train_step`` instead, with a
    fresh ``keyed_generator``, the reference the graphs are held to.

    ``program(trainer, state, inputs, generator) -> (state, loss)``, the
    state returned holding the same tensors, written in place (new tensors
    with ``eager=True``). The program holds no reference to the trainer:
    its graphs live until ``release`` or as long as the trainer's
    ``_programs`` hold it."""

    def __init__(self, kind, batch=None, augment=False, eager=False):
        super().__init__(kind, eager)
        self.batch = batch or _plain_batch
        self.augment = augment
        self._augment_gen = None

    # -- dispatch -------------------------------------------------------------

    def __call__(self, trainer, state, inputs, generator=None):
        with observability.span("lidbox.step", request=state.step,
                                kind=self.kind, step=state.step):
            return self._step(trainer, state, inputs, generator)

    def _step(self, trainer, state, inputs, generator):
        from lidbox_tpu_torch.train.loop import key_seed, keyed_generator
        if self.eager:
            augment_gen = (keyed_generator(trainer.device, trainer.seed,
                                           state.step, 7)
                           if self.augment else None)
            return self._eagerly(lambda: trainer._train_step(
                state, self.batch(trainer, _materialized(inputs),
                                  augment_gen), generator))
        reason = eager_reason(trainer)
        self._log_eager("train step", reason)
        scalars = trainer.optimizer.scalars(state.opt_state)
        seed = key_seed(trainer.seed, state.step, 7) if self.augment else None
        if reason is None and self._graphed(trainer):
            loss = self._replay(trainer, state, inputs, generator, scalars,
                                seed)
        else:
            loss = self._eagerly(functools.partial(
                self._run_eagerly, trainer, state, inputs, generator,
                scalars, seed))
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

    # -- graphs ---------------------------------------------------------------

    @staticmethod
    def signature(inputs, scalars, generator):
        return (tuple(sorted((k, None) if v is None
                             else (k, tuple(v.shape), v.dtype)
                             for k, v in inputs.items())),
                len(scalars), id(generator))

    def _replay(self, trainer, state, inputs, generator, scalars, seed):
        self._hold(state_tensors(state))
        key = (self.signature(inputs, scalars, generator), trainer.remat)
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
        if entry.rewind is not None:
            entry.rewind.set_state(generator.get_state())
        self._replayed(entry)
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

    def _warm_step(self, trainer, state, static, generator, augment_gen,
                   seed, buffers, loss):
        if augment_gen is not None:
            augment_gen.manual_seed(seed)
        self._body(trainer, state, static, generator, augment_gen, buffers,
                   loss)

    def _capture(self, trainer, state, inputs, generator, scalars, seed):
        device = trainer.device
        static, buffers, loss = self.static_buffers(device, inputs, scalars)
        augment_gen = (self._augment_generator(device, seed) if self.augment
                       else None)
        rewind = (generator.clone_state()
                  if trainer.remat and generator is not None else None)
        body = functools.partial(self._body, trainer, state, static,
                                 generator, augment_gen, buffers, loss)
        if rewind is not None:
            body = functools.partial(_rewinding, body, trainer, rewind)
        # the warm-up steps run on a clone of the state, so the state is
        # as it was before them
        graph, operands, _, launches = self._graph(
            device,
            functools.partial(self._warm_step, trainer, _clone_state(state),
                              static, generator, augment_gen, seed, buffers,
                              loss),
            body, [g for g in (generator, augment_gen, rewind)
                   if g is not None])
        return _Captured(graph, static, buffers, loss, operands, generator,
                         launches, rewind)


def _rewinding(body, trainer, rewind):
    """``body()`` with ``rewind`` as the trainer's ``capture_rewind``, the
    rewind point of a remat step under capture
    (``Trainer._rewind_point``)."""
    trainer.capture_rewind = rewind
    try:
        return body()
    finally:
        trainer.capture_rewind = None


class _CapturedForward(NamedTuple):
    graph: object
    inputs: dict       # name -> static input buffer (absent inputs: None)
    output: object     # the body's output: tensor, tuple of them or None
    operands: list     # the cached kernel operands the graph reads
    launches: dict     # kernel -> its launches in one replay


def tensors_of(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _cloned(output):
    if output is None:
        return None
    if isinstance(output, (tuple, list)):
        return type(output)(_cloned(v) for v in output)
    return output.clone()


def module_tensors(module):
    """Every parameter and buffer tensor of ``module``, in a fixed order:
    what a forward program that reads the module is keyed on."""
    return list(module.parameters()) + list(module.buffers())


class ForwardProgram(_Programs):
    """A served or evaluated forward run as one program per input
    signature.

    ``kind`` names the program in ``captures`` ("features", "stream",
    "forward", "eval"). ``program(fn, inputs, device, held=(), key=(),
    reason=None)`` returns ``fn(**inputs)``, a tensor, a tuple of tensors
    or None (a body that writes into tensors it holds, as the eval step
    accumulates). ``inputs``: tensors, None for an absent one, on
    ``device`` or on the host (pinned host memory is copied without a
    sync). ``held``: the tensors ``fn`` reads besides its inputs (a
    model's parameters and buffers: ``module_tensors``), keyed by
    identity. ``key``: what else selects the graph (a sample rate).
    ``reason``: why this call is not captured (an eager rule), logged
    once.

    On the card the body is captured once per signature (the inputs'
    shapes and dtypes, which are absent, ``key``) and every call is one
    replay, its outputs cloned out of the graph; calls are serialized, so
    two threads never share a graph's buffers. On the CPU, with
    ``eager=True`` or a ``reason``, the body runs eagerly on the inputs
    moved to ``device``. ``buffers``: tensors the program keeps for its
    body across calls (the eval step's accumulators), dropped with the
    graphs by ``release``."""

    def __init__(self, kind, eager=False):
        super().__init__(kind, eager)
        self.buffers = None
        self._lock = threading.Lock()

    # inference mode throughout: the static buffers are inference tensors,
    # which only a call in inference mode may write
    @torch.inference_mode()
    def __call__(self, fn, inputs, device, held=(), key=(), reason=None):
        if not self.eager:
            self._log_eager(f"{self.kind} program", reason)
        if self.eager or reason is not None or not self._graphed(device):
            return self._eagerly(lambda: fn(**{
                k: None if v is None else v.to(device, non_blocking=True)
                for k, v in inputs.items()}))
        with self._lock:
            self._hold(list(held))
            sig = (self.signature(inputs), key)
            entry = self._captured.get(sig)
            if entry is None:
                entry = self._capture(fn, inputs, device)
                self._captured[sig] = entry
            else:
                for name, value in inputs.items():
                    if value is not None:
                        entry.inputs[name].copy_(value, non_blocking=True)
            self._replayed(entry)
            return _cloned(entry.output)

    def _graphed(self, device):
        return torch.device(device).type == "cuda"

    def release(self):
        super().release()
        self.buffers = None

    @staticmethod
    def signature(inputs):
        return tuple(sorted((k, None) if v is None
                            else (k, tuple(v.shape), v.dtype)
                            for k, v in inputs.items()))

    @staticmethod
    def static_inputs(device, inputs):
        """Static input buffers on ``device`` holding ``inputs``, outside
        the graph's memory pool."""
        static = {}
        for name, value in inputs.items():
            static[name] = None
            if value is not None:
                static[name] = torch.empty(value.shape, dtype=value.dtype,
                                           device=device)
                static[name].copy_(value, non_blocking=True)
        return static

    def _capture(self, fn, inputs, device):
        static = self.static_inputs(device, inputs)
        # the warm-up steps write into the program's buffers too: they are
        # put back as they were before them
        kept = tensors_of(self.buffers)
        saved = [t.clone() for t in kept]
        body = functools.partial(fn, **static)
        graph, operands, output, launches = self._graph(device, body, body)
        if kept:
            torch._foreach_copy_(kept, saved)
        return _CapturedForward(graph, static, output, operands, launches)
