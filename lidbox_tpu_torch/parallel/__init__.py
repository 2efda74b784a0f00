"""
Process groups and data parallelism over ``torch.distributed``
(counterpart of ``lidbox_tpu.parallel``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: batches
shard over the ``data`` axis, parameters and metric state are replicated,
and XLA inserts the all-reduces. Here data parallelism is one process per
device: every rank holds a replica of the state, feeds its own rows of the
global batch, and the collectives are explicit (gradients, the loss's
example count, metric counters, BatchNorm's batch statistics). The
property kept is the JAX package's: a mesh step over ``world`` ranks x a
local batch gives the numbers of a mesh-less step on the concatenated
global batch.

- ``initialize_distributed`` reads the JAX package's variables
  (``COORDINATOR_ADDRESS`` as ``host:port``, or a ``file://`` / ``tcp://``
  init URL, ``NUM_PROCESSES``, ``PROCESS_ID``) and starts NCCL for CUDA,
  gloo for the CPU, or the backend the caller names. Beside the device
  group a CPU gloo group carries the host-side agreements (the feed-parity
  guard's flags and digests, the cache budget's minimum).
- ``get_mesh`` returns a :class:`Mesh` over the first N ranks of the group,
  one device each. ``torch.distributed.device_mesh.DeviceMesh`` is not
  used: it cannot hold a sub-mesh of some ranks that the others skip, and
  it picks each rank's card from its local rank, where two ranks sharing
  one card over gloo is what the CPU-less tests of a card need. With no
  distributed variables set, ``get_mesh`` starts a 1-rank group.
- Inside ``data_parallel(mesh)`` the training-mode layers see the global
  batch: BatchNorm normalizes with statistics all-reduced over the mesh
  (gradients flow through the reductions), and every random draw of
  dropout, Gaussian noise and the augmentation chain is drawn for the
  global batch from the step's generator, each rank keeping its rows
  (``draw_rows``), as GSPMD draws one mask over the global batch.

Tensor parallelism over a 2-D (data, model) mesh (``get_mesh_2d``): rank
d * model_size + m holds model column m of data row d. The ranks of one
data row feed the same rows of the global batch; a parameter sharding rule
(``column_parallel_rule``) splits the output features of the wide kernels
over the row's ranks (``shard_params``), and inside ``tensor_parallel``
each rank computes its own output columns of a column-parallel layer from
the replicated input (``copy_to_model``) and all-gathers the layer's
output (``gather_columns``), as GSPMD partitions a column-sharded kernel.
Layers whose product cannot split by output column in one call (cuDNN
recurrent cells, grouped convolutions) all-gather their weights instead
(``gather_weight``). Batch reductions (the loss, the gradients, BatchNorm
statistics, metric counters) run over the data group of each model
column, so each data row counts once.
"""
import contextlib
import datetime
import os
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from lidbox_tpu_torch import get_device, get_logger

logger = get_logger("parallel")

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the process's device and host-side group, set when a group starts
_STATE = {"device": None, "cpu_group": None, "meshes": {}}
_local = threading.local()


class Mesh:
    """A mesh of the ranks ``ranks`` of the process group, one device
    each. ``group`` runs the device collectives (NCCL, or gloo for CPU
    tensors and for ranks sharing a card; None for one rank),
    ``cpu_group`` the host-side agreements. ``rank`` is this process's
    index in the mesh, None when it is not a member.

    A 1-D mesh (``get_mesh``) has the axis ``data``. A 2-D mesh
    (``get_mesh_2d``) has ``shape`` (data_size, model_size) over the
    ranks in row-major order; its member holds ``data_mesh``, the 1-D
    mesh of the ranks of its model column (where batch reductions run),
    and ``model_mesh``, the 1-D mesh of the ranks of its data row (where
    the tensor-parallel collectives run). A 1-D mesh is its own data mesh
    and has no model mesh."""

    def __init__(self, ranks, device, group, cpu_group, shape=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.device = torch.device(device)
        self.group = group
        self.cpu_group = cpu_group
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None
        self.axis_names = (DATA_AXIS,) if shape is None else (DATA_AXIS,
                                                               MODEL_AXIS)
        self.shape = (len(self.ranks), 1) if shape is None else tuple(shape)
        self.data_mesh = self if shape is None else None
        self.model_mesh = None

    @property
    def size(self):
        return len(self.ranks)

    @property
    def data_size(self):
        return self.shape[0]

    @property
    def model_size(self):
        return self.shape[1]

    @property
    def data_index(self):
        """This rank's data row (which rows of the global batch it feeds)."""
        return None if self.rank is None else self.rank // self.model_size

    @property
    def model_index(self):
        """This rank's model column (which shard of each split parameter
        it holds)."""
        return None if self.rank is None else self.rank % self.model_size

    @property
    def is_member(self):
        return self.rank is not None

    @property
    def backend(self):
        return dist.get_backend(self.group)

    def __repr__(self):
        return (f"Mesh(ranks={list(self.ranks)}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend})")


def _timeout(seconds):
    return None if seconds is None else datetime.timedelta(seconds=seconds)


def _default_device(process_id, local_device_ids):
    if local_device_ids is not None:
        ids = ([int(local_device_ids)] if np.ndim(local_device_ids) == 0
               else [int(i) for i in local_device_ids])
        if len(ids) != 1:
            raise ValueError(f"one device per process, got local_device_ids "
                             f"{ids}")
        return torch.device("cuda", ids[0])
    if torch.cuda.is_available():
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return torch.device("cpu")


def _start(backend, device, timeout, **init_kwargs):
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": _timeout(timeout)}
    dist.init_process_group(backend, **init_kwargs, **kwargs)
    _STATE["device"] = device
    _STATE["cpu_group"] = (dist.group.WORLD if backend == "gloo"
                           else dist.new_group(backend="gloo", **kwargs))
    _STATE["meshes"] = {}
    # NCCL starts its communicator at the first collective: run one now,
    # so a group that cannot start (two ranks on one card) raises here
    dist.all_reduce(torch.zeros(1, device=device))
    logger.info("process group %s: rank %d of %d on %s", backend,
                dist.get_rank(), dist.get_world_size(), device)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           backend=None, device=None, timeout=None):
    """Start the process group from the JAX package's launcher variables.

    Arguments default to ``COORDINATOR_ADDRESS`` (``host:port``, or an
    init URL such as ``file:///path/store``), ``NUM_PROCESSES`` and
    ``PROCESS_ID``; with no coordinator configured this is a no-op that
    returns False. ``local_device_ids`` (one id) names this process's card
    as ``cuda:<id>``; by default a process takes card ``PROCESS_ID``
    modulo the card count, or the CPU without CUDA (``device`` overrides).
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` names one: two ranks on one card must name gloo, since
    NCCL refuses a card twice. A group that fails to start raises; there
    is no fallback. ``timeout`` (seconds) bounds every collective. Returns
    True when a group was started (or already runs)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("COORDINATOR_ADDRESS needs NUM_PROCESSES and "
                         "PROCESS_ID")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if device is None:
        device = _default_device(int(process_id), local_device_ids)
    _start(backend, get_device(device), timeout, init_method=init_method,
           world_size=int(num_processes), rank=int(process_id))
    return True


def shutdown_distributed():
    """Destroy the process group and forget its meshes."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, cpu_group=None, meshes={})


def get_mesh(num_devices=None, device=None):
    """The data-parallel mesh over the first ``num_devices`` ranks of the
    process group (default all), one device each.

    Without a group, one is started from the launcher variables
    (``initialize_distributed``), or else a 1-rank group on ``device``
    (default "cuda"), so ``--data-parallel`` on one card is a 1-rank mesh.
    A sub-mesh is created by every rank of the group, members or not, in
    the same order (``torch.distributed.new_group``); meshes are cached by
    size."""
    if not dist.is_initialized():
        if not initialize_distributed(device=device):
            _start(None, get_device("cuda" if device is None else device),
                   None, store=dist.HashStore(), rank=0, world_size=1)
    mine = _STATE["device"]
    if device is not None and torch.device(device).type != mine.type:
        raise ValueError(f"the process group runs on {mine}, not {device}")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    if n not in _STATE["meshes"]:
        if n == world:
            group, cpu_group = dist.group.WORLD, _STATE["cpu_group"]
        else:
            ranks = list(range(n))
            group = dist.new_group(ranks)
            cpu_group = (group if dist.get_backend() == "gloo"
                         else dist.new_group(ranks, backend="gloo"))
        _STATE["meshes"][n] = Mesh(range(n), mine, group, cpu_group)
    return _STATE["meshes"][n]


def _sub_mesh(ranks, whole):
    """The 1-D mesh over ``ranks`` (a subset of the 2-D mesh ``whole``'s
    ranks): ``whole``'s groups when they are the same ranks, no group for
    one rank, else new groups. Every rank of the process group runs this
    for every subset, in one order (``new_group`` is collective)."""
    if tuple(ranks) == whole.ranks:
        return Mesh(ranks, whole.device, whole.group, whole.cpu_group)
    if len(ranks) == 1:
        return Mesh(ranks, whole.device, None, None)
    group = dist.new_group(ranks)
    cpu_group = (group if dist.get_backend() == "gloo"
                 else dist.new_group(ranks, backend="gloo"))
    return Mesh(ranks, whole.device, group, cpu_group)


def get_mesh_2d(data_size=None, model_size=1, device=None):
    """The 2-D (data, model) mesh over the first data_size x model_size
    ranks of the process group (``data_size`` defaults to the group's
    size over ``model_size``), rank d * model_size + m at (d, m), as the
    JAX package reshapes its devices. Batches split over ``data``;
    parameters a sharding rule splits (``column_parallel_rule``) split
    over ``model``. The group starts as for ``get_mesh``; meshes are cached
    by shape, and every rank of the group must ask for the same ones in
    the same order."""
    whole = get_mesh(device=device)  # starts the group when needed
    world = whole.size
    model_size = int(model_size)
    data_size = world // model_size if data_size is None else int(data_size)
    if data_size < 1 or model_size < 1 or data_size * model_size > world:
        raise ValueError(f"a ({data_size}, {model_size}) mesh in a group of "
                         f"{world}")
    key = (data_size, model_size)
    if key not in _STATE["meshes"]:
        flat = get_mesh(data_size * model_size)
        mesh = Mesh(flat.ranks, flat.device, flat.group, flat.cpu_group,
                    shape=key)
        ranks = np.arange(data_size * model_size).reshape(key)
        for column in ranks.T.tolist():
            sub = _sub_mesh(column, mesh)
            if sub.is_member:
                mesh.data_mesh = sub
        for row in ranks.tolist():
            sub = _sub_mesh(row, mesh)
            if sub.is_member:
                mesh.model_mesh = sub
        _STATE["meshes"][key] = mesh
    return _STATE["meshes"][key]


def mesh_spans_processes(mesh):
    """True when ``mesh`` holds more than one rank: its steps are
    collectives, its feeds are process-local and need the feed-parity
    guard. Every rank is its own process here."""
    return mesh is not None and mesh.size > 1


def check_device(mesh, device):
    """``device`` (the caller's) against the mesh's: the type must agree,
    and an indexed CUDA device must be the mesh's card."""
    device = torch.device(device)
    ok = device.type == mesh.device.type and (
        device.index is None or mesh.device.index is None
        or device.index == mesh.device.index)
    if not ok:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return device


# -- trees -------------------------------------------------------------------

def _tensors(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def _tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts, lists and tuples."""
    return _rebuild(tree, iter([fn(t) for t in _tensors(tree, [])]))


def _bucketed(tree, collective):
    """Run ``collective(flat)`` on one flat buffer per dtype of the tree's
    tensors (one call per dtype, not one per tensor) and rebuild it."""
    leaves = _tensors(tree, [])
    out = [None] * len(leaves)
    by_dtype = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        collective(flat)
        for i, piece in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return _rebuild(tree, iter(out))


# -- collectives ---------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward is the sum of the gradients over
    the group (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, mesh):
    """Differentiable sum of ``x`` over the mesh's ranks."""
    if mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_tree(tree, mesh):
    """Every tensor of ``tree`` summed over the mesh (no gradient), in one
    bucketed call per dtype."""
    if mesh.size == 1:
        return tree
    return _bucketed(tree, lambda flat: dist.all_reduce(flat,
                                                        group=mesh.group))


def put_replicated(tree, mesh):
    """Every tensor of ``tree`` on the mesh's device, replicated from the
    mesh's first rank (one bucketed broadcast per dtype): the ranks start
    from one state whatever each held."""
    tree = _tree_map(lambda t: t.to(mesh.device), tree)
    if mesh.size == 1:
        return tree
    return _bucketed(tree, lambda flat: dist.broadcast(
        flat, src=mesh.ranks[0], group=mesh.group))


# dtypes a collective does not carry, and the one each travels as
_CARRIED_AS = {torch.int16: torch.int32, torch.bool: torch.uint8,
               torch.bfloat16: torch.float32}


def all_gather_rows(x, mesh):
    """The ranks' ``x`` [n, ...] (equal shapes) concatenated in mesh order
    on every rank: NCCL's all-gather, or one broadcast per rank where gloo
    gathers no device tensors. int16, bool and bfloat16 travel widened
    (exactly) and come back in their dtype."""
    if mesh.size == 1:
        return x
    if x.dtype in _CARRIED_AS:
        return all_gather_rows(x.to(_CARRIED_AS[x.dtype]), mesh).to(x.dtype)
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    for i, src in enumerate(mesh.ranks):
        part = out[i * x.shape[0]:(i + 1) * x.shape[0]]
        if i == mesh.rank:
            part.copy_(x)
        dist.broadcast(part, src=src, group=mesh.group)
    return out


class _GatherColumns(torch.autograd.Function):
    """The model group's pieces of ``x`` concatenated along ``dim`` in
    rank order; the backward keeps this rank's piece of the gradient
    (every rank of the group computes the same gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.rank, ctx.width = dim, mesh.rank, x.shape[dim]
        whole = all_gather_rows(x.movedim(dim, 0).contiguous(), mesh)
        return whole.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.width,
                           ctx.width).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the model group
    (each rank's gradient covers only the columns it computed)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_columns(x, dim, mesh):
    """Differentiable all-gather of ``x``'s ``dim`` over the 1-D ``mesh``
    (a model group): forward, the whole; backward, this rank's slice."""
    if mesh.size == 1:
        return x
    return _GatherColumns.apply(x, dim % x.dim(), mesh)


def copy_to_model(x, mesh):
    """``x``, the replicated input of a column-parallel product: forward,
    the identity; backward, the gradient all-reduced over the 1-D ``mesh``
    (a model group)."""
    if mesh.size == 1:
        return x
    return _CopyToModel.apply(x, mesh.group)


@contextlib.contextmanager
def tensor_parallel(mesh, specs):
    """Inside the block the layers of a model whose parameters ``shard_
    params`` split (``specs``: name -> split axis) compute column-parallel
    over ``mesh``'s model group (module doc). A mesh without a model axis
    of more than one rank, or no split parameter, changes nothing."""
    prev = getattr(_local, "tp", None)
    model = None if mesh is None else mesh.model_mesh
    _local.tp = ((model, dict(specs))
                 if model is not None and model.size > 1 and specs else None)
    try:
        yield
    finally:
        _local.tp = prev


def model_group():
    """The model mesh of the innermost ``tensor_parallel`` block; outside
    one it raises (a layer was given a split weight there)."""
    tp = getattr(_local, "tp", None)
    if tp is None:
        raise RuntimeError("a split parameter outside parallel."
                           "tensor_parallel: gather the shards first "
                           "(Trainer.checkpoint_state)")
    return tp[0]


def gather_weight(w):
    """A split weight (output features on axis 0, torch's layout) whole,
    differentiably: for layers whose product cannot split by output
    column in one call. Storage and optimizer state stay split."""
    return gather_columns(w, 0, model_group())


def sum_of_squares(tree):
    """sum(t * t) over the tensors of a name -> tensor dict, as one 0-dim
    tensor. Inside ``tensor_parallel`` the split tensors' part is summed
    over the model group and the replicated tensors count once, so every
    rank gets the global arrays' sum (what GSPMD computes)."""
    tp = getattr(_local, "tp", None)
    if tp is None:
        return sum(torch.sum(t * t) for t in tree.values())
    model, specs = tp
    split = [t for k, t in tree.items() if k in specs]
    whole = [t for k, t in tree.items() if k not in specs]
    part = torch.stack([torch.sum(t * t) for t in split]).sum().reshape(1)
    dist.all_reduce(part, group=model.group)
    return part[0] + sum(torch.sum(t * t) for t in whole)


def share_with_world(x, mesh):
    """``x`` (a float32 tensor the members of ``mesh`` all hold) on every
    rank of the group: ranks outside a sub-mesh pass None and receive it
    from rank 0, the shape first over the CPU group. A mesh over the whole
    group returns ``x``."""
    if mesh.size == dist.get_world_size():
        return x
    head = torch.zeros(9, dtype=torch.int64)
    if x is not None:
        head[0] = x.dim()
        head[1:1 + x.dim()] = torch.as_tensor(x.shape)
    dist.broadcast(head, src=0, group=_STATE["cpu_group"])
    if x is None:
        x = torch.empty(tuple(head[1:1 + int(head[0])].tolist()),
                        dtype=torch.float32, device=mesh.device)
    dist.broadcast(x, src=0)
    return x


def as_mesh(mesh):
    """``mesh`` when it is None or a :class:`Mesh`; anything else raises
    TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"expected a lidbox_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def host_allgather(values, mesh):
    """A [size, n] numpy array of each rank's ``values`` (int64 or float64
    host numbers), gathered over the mesh's CPU group."""
    local = torch.as_tensor(np.atleast_1d(np.asarray(values)))
    if mesh.size == 1:
        return local.numpy()[None]
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.cpu_group)
    return torch.stack(parts).numpy()


def barrier(mesh):
    """Wait for every rank of the mesh (host side)."""
    if mesh.size > 1:
        dist.barrier(group=mesh.cpu_group)


# -- the global batch ------------------------------------------------------------

@contextlib.contextmanager
def data_parallel(mesh):
    """Inside the block training-mode layers and draws see ``mesh``'s
    global batch (module doc), over its data group (a 2-D mesh's ranks of
    one data row see the same rows); a mesh of one data row or None
    changes nothing."""
    prev = getattr(_local, "mesh", None)
    data = None if mesh is None else mesh.data_mesh
    _local.mesh = data if mesh_spans_processes(data) else None
    try:
        yield
    finally:
        _local.mesh = prev


def active_mesh():
    """The data mesh of the innermost ``data_parallel`` block (None
    outside)."""
    return getattr(_local, "mesh", None)


def draw_rows(draw, rows):
    """``draw(n)`` draws the random values of an n-row batch (a tensor or a
    tree of tensors with n leading rows). Inside ``data_parallel`` it draws
    for the global batch (rows x ranks) and returns this rank's rows, so
    the values are those a mesh-less run draws on the concatenated batch;
    outside it is ``draw(rows)``."""
    mesh = active_mesh()
    if mesh is None:
        return draw(rows)
    start = mesh.rank * rows
    return _tree_map(lambda t: t.narrow(0, start, rows),
                    draw(rows * mesh.size))


def global_max(x):
    """``x.max()`` over the global batch inside ``data_parallel`` (an
    all-reduce of the local maxima), the local one outside."""
    m = x.max()
    mesh = active_mesh()
    if mesh is not None:
        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    return m


def structure_digest(item):
    """A 32-bit digest of a staged item's structure and tensor shapes and
    dtypes: what the ranks must agree on before a collective step consumes
    it (the feed-parity guard)."""
    def describe(node):
        if isinstance(node, dict):
            return "{" + ",".join(f"{k}:{describe(v)}"
                                  for k, v in sorted(node.items())) + "}"
        if isinstance(node, (list, tuple)):
            return "(" + ",".join(describe(v) for v in node) + ")"
        if isinstance(node, (torch.Tensor, np.ndarray)):
            return f"{tuple(node.shape)}:{node.dtype}"
        return type(node).__name__
    return zlib.crc32(describe(item).encode())


def pad_batch_to(batch, batch_size):
    """Right-pad every array's leading axis of a dict, list or tuple of
    arrays to ``batch_size``; returns (padded batch, valid mask
    [batch_size])."""
    def pad(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n == batch_size:
            return x
        return np.pad(x, [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1))
    leaves = batch.values() if isinstance(batch, dict) else batch
    n_valid = np.shape(next(iter(leaves)))[0]
    mask = np.arange(batch_size) < n_valid
    if isinstance(batch, dict):
        return {k: pad(v) for k, v in batch.items()}, mask
    return type(batch)(pad(v) for v in batch), mask


def local_slice(batch, mesh):
    """This rank's rows of a host global batch: a dict batch (``input``,
    ``target``, ...) or a ``(signals, targets)`` / ``(signals, targets,
    example_mask)`` tuple. Rows split over the mesh's data rows (the ranks
    of one data row of a 2-D mesh take the same rows), right-padded to a
    multiple of the data size first, the padding marked in
    ``example_mask`` (the tuple's third element), so every rank feeds one
    shape. This is how a single feed of global batches (the command
    line's) becomes each rank's local feed."""
    is_dict = isinstance(batch, dict)
    leaves = list(batch.values()) if is_dict else list(batch)
    n = int(np.shape(leaves[0])[0])
    size = mesh.data_size
    padded_n = -(-n // size) * size
    if is_dict:
        mask = batch.get("example_mask")
    else:
        mask = batch[2] if len(batch) > 2 else None
    if padded_n != n:
        body = ({k: v for k, v in batch.items() if k != "example_mask"}
                if is_dict else tuple(batch[:2]))
        body, valid = pad_batch_to(body, padded_n)
        mask = valid if mask is None else np.logical_and(
            np.pad(np.asarray(mask, bool), (0, padded_n - n)), valid)
        batch = dict(body, example_mask=mask) if is_dict else (*body, mask)
    m = padded_n // size
    rows = slice(mesh.data_index * m, (mesh.data_index + 1) * m)
    if is_dict:
        return {k: np.asarray(v)[rows] for k, v in batch.items()}
    return type(batch)(np.asarray(v)[rows] for v in batch)


def local_batches(batches, mesh):
    """A feed of global batches (a callable or a re-iterable collection)
    as this rank's feed of ``local_slice`` batches, as a callable."""
    def make():
        it = batches() if callable(batches) else batches
        for b in it:
            yield local_slice(b, mesh)
    return make


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (a dict of host arrays whose
    leading dims divide the mesh size: ``pad_batch_to`` first), on the
    mesh's device."""
    n = int(np.shape(next(iter(batch.values())))[0])
    if n % mesh.data_size:
        raise ValueError(f"{n} rows do not divide over {mesh.data_size} "
                         "data rows; pad_batch_to first")
    return global_batch_from_local(local_slice(batch, mesh), mesh)


def global_batch_from_local(local_batch, mesh):
    """This process's LOCAL rows of the global batch, on the mesh's device:
    each rank feeds only its own rows, and the global batch is their
    concatenation in rank order."""
    def put(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(mesh.device)
    if isinstance(local_batch, dict):
        return {k: put(v) for k, v in local_batch.items()}
    return type(local_batch)(put(v) for v in local_batch)


def stack_on_mesh(trees, mesh, concat=False):
    """Stack identically shaped dicts of this rank's tensors along a new
    leading axis (``concat=True``: concatenate along the existing one).
    Each rank stacks its own shards, so ``mesh`` (the JAX package's
    placement) takes no part: the stacks' batch axis stays this rank's
    rows."""
    del mesh
    join = torch.cat if concat else torch.stack
    return {k: join([t[k] for t in trees]) for k in trees[0]}


def column_parallel_rule(mesh, min_last_dim=64):
    """(name, parameter) -> the axis to split over ``mesh``'s model axis,
    or None to replicate: the output features of weights of rank >= 2
    (Dense, Conv, the recurrent cells' per-gate kernels), column-parallel,
    when their count divides the model size and is at least
    ``min_last_dim``; biases, BatchNorm scales and small heads stay
    replicated. The JAX rule reads the last axis of a Flax kernel, which
    holds the output features; a torch weight holds them on axis 0."""
    model_size = mesh.model_size

    def rule(name, leaf):
        shape = tuple(leaf.shape)
        if (model_size > 1 and len(shape) >= 2
                and shape[0] % model_size == 0 and shape[0] >= min_last_dim):
            return 0
        return None
    return rule


def shard_params(params, mesh, rule=None):
    """(this rank's shards of ``params``, {name: split axis}): every
    parameter the rule (default ``column_parallel_rule(mesh)``) splits is
    cut into model_size equal pieces along its axis and the rank keeps
    piece ``mesh.model_index``; the others are kept whole. ``params`` is
    a name -> tensor dict, equal on every rank."""
    if rule is None:
        rule = column_parallel_rule(mesh)
    shards, specs = {}, {}
    for name, p in params.items():
        axis = rule(name, p)
        if axis is None:
            shards[name] = p
            continue
        if p.shape[axis] % mesh.model_size:
            raise ValueError(f"{name}: axis {axis} of {tuple(p.shape)} does "
                             f"not split over {mesh.model_size} ranks")
        shards[name] = shard(p, axis, mesh)
        specs[name] = axis
    return shards, specs


def shard(tensor, axis, mesh):
    """This rank's piece of ``tensor`` cut in ``mesh.model_size`` equal
    pieces along ``axis`` (a copy)."""
    width = tensor.shape[axis] // mesh.model_size
    return tensor.narrow(axis, mesh.model_index * width, width).clone()


def unshard(tensor, axis, mesh):
    """The whole of a parameter ``shard_params`` split along ``axis``,
    gathered over ``mesh``'s model group (no gradient)."""
    return gather_columns(tensor.detach(), axis, mesh.model_mesh)
