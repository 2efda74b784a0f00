"""
Explicit-collective data-parallel train step (counterpart of
``lidbox_tpu.parallel.spmd``).

The default Trainer under a mesh reproduces the global-batch step: losses,
gradients and BatchNorm statistics over the concatenated batch, and every
draw made for the global batch. This step is the manually scheduled
alternative the JAX package writes with ``shard_map``: each rank runs the
forward and backward of its own rows as a mesh-less step would (BatchNorm
on the local batch's statistics), draws from a generator keyed by the step
AND its rank (the JAX package's ``fold_in(step_rng, axis_index)``), and
then the gradients, the loss and the batch statistics are averaged over
the mesh (pmean). For deterministic models without BatchNorm both steps
give the same update.
"""
import torch

from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.models.model_api import functional_forward
from lidbox_tpu_torch.train.loop import TrainState, keyed_generator
from lidbox_tpu_torch.train.optimizers import apply_updates


def make_shard_map_train_step(model, optimizer, loss_fn, mesh):
    """step(state, batch, seed) -> (new_state, loss): ``batch`` is this
    rank's {"input": [b, ...], "target": [b]} on the mesh's device, the
    state a replicated ``TrainState``, ``seed`` an integer. The loss is the
    mean over the ranks of each rank's batch mean."""
    module = model.module

    def step(state, batch, seed):
        generator = keyed_generator(mesh.device, seed, state.step, mesh.rank)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        with torch.enable_grad():
            out, new_bs = functional_forward(
                module, params, state.batch_stats, batch["input"],
                train=True, generator=generator, output=model.output)
            local_loss = torch.mean(loss_fn(batch["target"], out))
            grads = torch.autograd.grad(local_loss, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(state.params.items(), grads)}
        scale = 1.0 / mesh.size
        stats = {k: v for k, v in new_bs.items() if v.is_floating_point()}
        grads, loss, stats = parallel.all_reduce_tree(
            (grads, local_loss.detach(), stats), mesh)
        grads = {k: g * scale for k, g in grads.items()}
        new_bs = {**new_bs, **{k: v * scale for k, v in stats.items()}}
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        return TrainState(step=state.step + 1,
                          params=apply_updates(state.params, updates),
                          batch_stats=new_bs,
                          opt_state=opt_state), loss * scale
    return step
