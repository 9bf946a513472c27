"""Carry parameters and Adam state between the JAX package and the port.

The JAX models keep their tables in a parameter pytree whose keys each
model names (`init_params`): LightGCN ``{"user_emb": [U, d],
"item_emb": [I, d]}``, EGCF ``{"item_emb": [I, d]}``. The port's models
keep them as `nn.Parameter`s of the same names (`RecModel.init_params`),
so every function here works on whatever tables the model has, in the
JAX flatten order (sorted names, `table_names`). Pass the JAX arrays as
numpy (``jax.device_get``), so this module needs no JAX.

Adam state crosses as numpy too: optax's ``ScaleByAdamState`` holds
``count`` (steps taken), ``mu`` and ``nu`` (pytrees shaped like the
parameters); `torch.optim.Adam` holds ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter. `adam_state_to_numpy` and
`load_adam_state` map one onto the other, so both packages can take the
same step from the same state.

A model's state (RecDCL's target histories; `RecModel.init_state`)
crosses as numpy too, by name: `state_to_numpy` and the model's
`load_model_state`. It is neither a parameter nor an Adam moment.

`load_jax_checkpoint` reads a checkpoint written by the JAX package's
``train_model(checkpoint_dir=...)`` into the port's model and Adam: the
way trained weights cross, train in one package and serve from the
other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from idgrec_torch.engine import checkpoint as ckpt


def table_names(model: torch.nn.Module) -> tuple[str, ...]:
    """The model's tables in the JAX flatten order (sorted names)."""
    return tuple(sorted(name for name, _ in model.named_parameters()))


def state_dict_from_jax(params: Mapping[str, np.ndarray],
                        names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """The port's module state for the JAX parameters ``names``: float32
    CPU tensors under the same names."""
    missing = [k for k in names if k not in params]
    if missing:
        raise KeyError(f"JAX parameters lack {missing}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in names}


def load_jax_params(model: torch.nn.Module, params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy JAX parameters into ``model``'s tables (shapes must match)
    and return it."""
    state = state_dict_from_jax(params, table_names(model))
    for k, v in state.items():
        have = tuple(getattr(model, k).shape)
        if tuple(v.shape) != have:
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} != model shape {have}")
    model.load_state_dict(state)
    return model


def jax_params_from_model(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The way back: the model's tables as the JAX parameter pytree of
    numpy arrays."""
    return {k: getattr(model, k).detach().cpu().numpy().copy() for k in table_names(model)}


def state_to_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The model's state as the JAX state pytree of numpy arrays (empty
    for a model without state)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.model_state().items()}


def adam_state_to_numpy(optimizer: torch.optim.Adam, model: torch.nn.Module) -> dict:
    """{"count": int, "mu": {name: array}, "nu": {name: array}} of the
    optimizer's state for the model's tables (zeros before any step):
    the fields of optax's ``ScaleByAdamState``."""
    out = {"count": 0, "mu": {}, "nu": {}}
    for k in table_names(model):
        p = getattr(model, k)
        st = optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        out["mu"][k] = st["exp_avg"].detach().cpu().numpy().copy() if st else zeros
        out["nu"][k] = st["exp_avg_sq"].detach().cpu().numpy().copy() if st else zeros.copy()
        if st:  # a table with no gradient (IMPGCN's grouping) takes no step
            out["count"] = max(out["count"], int(st["step"]))
    return out


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, count: int,
                    mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray]) -> None:
    """Set the optimizer's state for the model's tables from optax's
    ``count``, ``mu`` and ``nu`` (numpy)."""
    for k in table_names(model):
        p = getattr(model, k)
        for name, tree in (("mu", mu), ("nu", nu)):
            if tuple(np.shape(tree[k])) != tuple(p.shape):
                raise ValueError(f"{name}[{k}]: shape {np.shape(tree[k])} != {tuple(p.shape)}")

        def put(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(p.device)

        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": put(mu[k]),
            "exp_avg_sq": put(nu[k]),
        }


# A JAX checkpoint's tree is {"opt_state", "params", "rng", "state"},
# flattened in sorted key order. For a model with n tables and s state
# tensors, under optax.adam, the leaves are
#   0                 opt_state: ScaleByAdamState.count
#   1 .. n            opt_state: mu {tables, sorted}
#   n+1 .. 2n         opt_state: nu {tables, sorted}
#   2n+1 .. 3n        params {tables, sorted}
#   3n+1              rng: the JAX key
#   3n+2 .. 3n+s+1    state {state tensors, sorted}
# LightGCN (item_emb, user_emb) has 8 leaves, EGCF (item_emb) 5, RecDCL
# (11 tables; i_target_his, u_target_his) 37.


def jax_num_leaves(model: torch.nn.Module) -> int:
    """The leaf count of a JAX checkpoint of ``model`` in the layout above."""
    return 3 * len(table_names(model)) + 2 + len(model.state_names)


def split_adam_and_params(leaves, names: tuple[str, ...]) -> tuple[int, dict, dict, dict]:
    """(count, mu, nu, params) from the first 3n + 1 leaves of a
    checkpoint of the tables ``names`` (sorted) in the layout above,
    which the port's own checkpoints share (engine/checkpoint.py)."""
    n = len(names)
    if len(leaves) < 3 * n + 1 or np.ndim(leaves[0]) > 1 or np.size(leaves[0]) != 1:
        raise ValueError(f"not a checkpoint of {n} tables under Adam: "
                         f"{len(leaves)} leaves, first of shape {np.shape(leaves[0])}")
    mu, nu, params = (dict(zip(names, leaves[i: i + n])) for i in (1, n + 1, 2 * n + 1))
    return int(np.asarray(leaves[0]).reshape(())), mu, nu, params


def load_jax_checkpoint(model: torch.nn.Module, optimizer: torch.optim.Adam | None,
                        directory: str, epoch: int | None = None) -> dict:
    """Load a checkpoint written by the JAX package's ``train_model``
    into ``model`` (its tables and its state) and, when given,
    ``optimizer`` (Adam's step and moments). ``epoch`` defaults to the
    latest. Reads numpy only; the JAX key in the checkpoint has no
    counterpart and is left behind. Returns the sidecar (``epoch``,
    ``best``, ...)."""
    epoch = ckpt.resolve_epoch(directory, epoch)
    leaves, meta = ckpt.read_checkpoint(directory, epoch)
    names = table_names(model)
    want = jax_num_leaves(model)
    if len(leaves) != want:
        raise ValueError(
            f"{directory}/ckpt_{epoch}.npz has {len(leaves)} leaves; a JAX checkpoint of "
            f"{', '.join(names)} under Adam has {want}")
    count, mu, nu, params = split_adam_and_params(leaves, names)
    load_jax_params(model, params)
    model.load_model_state(dict(zip(model.state_names, leaves[3 * len(names) + 2:])))
    if optimizer is not None:
        load_adam_state(optimizer, model, count, mu, nu)
    return meta
