"""Carry parameters and Adam state between the JAX package and the port.

The JAX models keep their tables in a parameter pytree,
``{"user_emb": [U, d], "item_emb": [I, d]}``; the port's models keep
them as `nn.Parameter`s of the same names. Pass the JAX arrays as
numpy (``jax.device_get``), so this module needs no JAX.

Adam state crosses as numpy too: optax's ``ScaleByAdamState`` holds
``count`` (steps taken), ``mu`` and ``nu`` (pytrees shaped like the
parameters); `torch.optim.Adam` holds ``step``, ``exp_avg`` and
``exp_avg_sq`` per parameter. `adam_state_to_numpy` and
`load_adam_state` map one onto the other, so both packages can take the
same step from the same state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

EMBEDDING_KEYS = ("user_emb", "item_emb")


def state_dict_from_jax(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The port's module state for JAX embedding parameters: float32
    CPU tensors under the same names."""
    missing = [k for k in EMBEDDING_KEYS if k not in params]
    if missing:
        raise KeyError(f"JAX parameters lack {missing}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)) for k in EMBEDDING_KEYS}


def load_jax_params(model: torch.nn.Module, params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy JAX embedding parameters into ``model`` (shapes must match)
    and return it."""
    state = state_dict_from_jax(params)
    for k, v in state.items():
        have = tuple(getattr(model, k).shape)
        if tuple(v.shape) != have:
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} != model shape {have}")
    model.load_state_dict(state)
    return model


def jax_params_from_model(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The way back: the model's tables as the JAX parameter pytree of
    numpy arrays."""
    return {k: getattr(model, k).detach().cpu().numpy().copy() for k in EMBEDDING_KEYS}


def adam_state_to_numpy(optimizer: torch.optim.Adam, model: torch.nn.Module) -> dict:
    """{"count": int, "mu": {name: array}, "nu": {name: array}} of the
    optimizer's state for the model's tables (zeros before any step):
    the fields of optax's ``ScaleByAdamState``."""
    out = {"count": 0, "mu": {}, "nu": {}}
    for k in EMBEDDING_KEYS:
        p = getattr(model, k)
        st = optimizer.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        out["mu"][k] = st["exp_avg"].detach().cpu().numpy().copy() if st else zeros
        out["nu"][k] = st["exp_avg_sq"].detach().cpu().numpy().copy() if st else zeros.copy()
        if st:
            out["count"] = int(st["step"])
    return out


def load_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module, count: int,
                    mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray]) -> None:
    """Set the optimizer's state for the model's tables from optax's
    ``count``, ``mu`` and ``nu`` (numpy)."""
    for k in EMBEDDING_KEYS:
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
