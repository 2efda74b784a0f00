"""
The port's hand-written optimizer updates and schedules against the optax
transformations the JAX package builds (lidbox_tpu.train.optimizers), on
the same numpy parameters and gradients on the CPU: parameters after each
of 5 steps within atol 1e-7 + rtol 1e-6, for every optimizer plain, with
``clipnorm`` and with ``clipvalue``, and every schedule's values within
rtol 1e-6 (the port evaluates schedules in float64 on the host, optax in
float32). A JAX Adam state carried over mid-run with
``opt_state_from_optax`` gives the same next update.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.train import optimizers as topt

torch.set_num_threads(2)

SHAPES = {"w1": (6, 5), "w2": (5,), "w3": (3, 4, 2)}
# per-step gradient scales: the global norm crosses clipnorm both ways and
# clipvalue cuts some elements
SCALES = (0.3, 2.0, 0.05, 1.0, 3.0)
ATOL, RTOL = 1e-7, 1e-6

OPTIMIZERS = {
    "Adam": {"learning_rate": 0.01},
    "AdamW": {"learning_rate": 0.01, "weight_decay": 0.05},
    "SGD": {"learning_rate": 0.05},
    "SGD-nesterov": {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True},
    "RMSprop": {"learning_rate": 0.01},
    "RMSprop-momentum": {"learning_rate": 0.01, "rho": 0.8, "momentum": 0.5},
    "Adagrad": {"learning_rate": 0.1},
    "Adam-scheduled": {"learning_rate": 0.0, "lr_scheduler": {
        "cls": "ExponentialDecay",
        "kwargs": {"initial_learning_rate": 0.02, "decay_steps": 2,
                   "decay_rate": 0.5}}},
}
SCHEDULES = [
    ("ExponentialDecay", {"initial_learning_rate": 0.1, "decay_steps": 3,
                          "decay_rate": 0.5}),
    ("ExponentialDecay", {"initial_learning_rate": 0.1, "decay_steps": 3,
                          "decay_rate": 0.5, "staircase": True}),
    ("PiecewiseConstantDecay", {"boundaries": [2, 4],
                                "values": [0.1, 0.05, 0.01]}),
    ("CosineDecay", {"initial_learning_rate": 0.1, "decay_steps": 5,
                     "alpha": 0.1}),
    ("PolynomialDecay", {"initial_learning_rate": 0.1, "decay_steps": 4,
                         "end_learning_rate": 0.01, "power": 2.0}),
    ("InverseTimeDecay", {"initial_learning_rate": 0.1, "decay_steps": 2,
                          "decay_rate": 0.5}),
    ("InverseTimeDecay", {"initial_learning_rate": 0.1, "decay_steps": 2,
                          "decay_rate": 0.5, "staircase": True}),
]


def _config(name, clip):
    kwargs = dict(OPTIMIZERS[name])
    if clip == "clipnorm":
        kwargs["clipnorm"] = 1.0
    elif clip == "clipvalue":
        kwargs["clipvalue"] = 0.5
    return {"cls": name.split("-")[0], "kwargs": kwargs}


def _params_and_grads(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(0, 1, s)).astype(np.float32)
              for k, s in shapes.items()} for scale in SCALES]
    return params, grads


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("clip", [None, "clipnorm", "clipvalue"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_over_five_steps(name, clip):
    params, grads = _params_and_grads()
    jo, jlr = jopt.optimizer_from_config(_config(name, clip))
    to, tlr = topt.optimizer_from_config(_config(name, clip))
    assert callable(jlr) == callable(tlr)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{k} after step {i + 1}")
    # the updates moved the params, and every step made new tensors
    assert not np.allclose(tp["w1"].numpy(), params["w1"])
    np.testing.assert_array_equal(_torch(params)["w1"].numpy(), params["w1"])


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedule_matches_optax(name, kwargs):
    conf = {"cls": name, "kwargs": kwargs}
    js, ts = jopt.schedule_from_config(conf), topt.schedule_from_config(conf)
    for step in range(10):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=RTOL, err_msg=f"step {step}")


def test_factories_reject_unknown_names():
    for factory, conf in ((topt.optimizer_from_config, {"cls": "Lion"}),
                          (topt.schedule_from_config, {"cls": "Warmup"})):
        with pytest.raises(KeyError):
            factory(conf)
    with pytest.raises(ValueError):
        topt.cosine_decay_schedule(0.1, 0)
    with pytest.raises(ValueError):
        topt.add_decayed_weights(0.1).update({"w": torch.ones(2)}, {})
    _, lr = topt.optimizer_from_config({"cls": "SGD"})
    assert lr == 1e-3  # the factory's default, as in the JAX package


FLAX_SHAPES = {"dense": {"kernel": (4, 3), "bias": (3,)},
               "conv": {"kernel": (3, 2, 4), "bias": (4,)}}


def _flax_tree(rng, scale=1.0):
    return {m: {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
                for k, s in leaves.items()}
            for m, leaves in FLAX_SHAPES.items()}


@pytest.mark.parametrize("config", [
    {"cls": "Adam", "kwargs": {"learning_rate": 0.01, "clipnorm": 1.0}},
    {"cls": "Adam", "kwargs": {"lr_scheduler": {
        "cls": "CosineDecay",
        "kwargs": {"initial_learning_rate": 0.01, "decay_steps": 6}}}},
])
def test_opt_state_from_optax_resumes_a_jax_run(config):
    """Three optax steps in the JAX package, then the state (moments,
    counts) and params carried into the port: the fourth update is the
    same in both."""
    rng = np.random.default_rng(4)
    jo, _ = jopt.optimizer_from_config(config)
    jp = jax.tree_util.tree_map(jnp.asarray, _flax_tree(rng))
    js = jo.init(jp)
    for scale in SCALES[:3]:
        g = jax.tree_util.tree_map(jnp.asarray, _flax_tree(rng, scale))
        u, js = jo.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
    to, _ = topt.optimizer_from_config(config)
    tp = params_from_flax(jax.device_get(jp))
    ts = topt.opt_state_from_optax(jax.device_get(js), tp)
    g = _flax_tree(rng, SCALES[3])
    ju, _ = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    tg = params_from_flax(g)
    tu, ts = to.update({k: tg[k] for k in tp}, ts, tp)  # in params' order
    ref = params_from_flax(jax.device_get(ju))
    assert set(tu) == set(ref) == set(tp)
    for k in ref:
        np.testing.assert_allclose(tu[k].numpy(), ref[k].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    def counts(state):
        if isinstance(state, tuple):
            return [c for s in state for c in counts(s)]
        return [state["count"]] if "count" in state else []
    assert counts(ts) and all(c == 4 for c in counts(ts))
    with pytest.raises(ValueError, match="moments"):
        topt.opt_state_from_optax(jax.device_get(js),
                                  {"dense.weight": tp["dense.weight"]})
