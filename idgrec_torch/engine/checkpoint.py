"""Checkpoint / resume (counterpart of idgrec_tpu/engine/checkpoint.py,
with the same file layout).

A checkpoint of epoch N is ``ckpt_N.npz``, the numpy leaves of the
training-state tree under ``arr_0 .. arr_k``, plus a ``ckpt_N.json``
sidecar with ``epoch``, ``num_leaves``, the best-results bookkeeping and
the host numpy generator's state. The ``.npz`` is written under a
temporary name and renamed, so a reader never sees a partial file; the
newest ``keep`` checkpoints stay. Restore fills a template of the same
structure, so no pickled code is involved.

The tree is nested dicts of arrays, flattened in sorted key order (the
order `jax.tree.leaves` gives a dict). The run harness writes

    opt_state: count, mu{tables}, nu{tables}
    params:    tables
    rng:       device, host
    state:     the model's state tensors (none for most models)

where the tables are the model's own, sorted by name (LightGCN
item_emb, user_emb; EGCF item_emb), ``count``/``mu``/``nu`` are Adam's
``step``/``exp_avg``/``exp_avg_sq`` (`convert.adam_state_to_numpy`),
``rng`` holds the byte states of the run's explicit
`torch.Generator`s and ``state`` the model's state by name (RecDCL
i_target_his, u_target_his; `convert.state_to_numpy`). The first 3n + 1
leaves of n tables are those of a checkpoint written by the JAX
package's ``train_model`` for the same model, whose state leaves follow
its one key leaf (`convert.load_jax_checkpoint`).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves: list):
    """The template's structure filled with ``leaves`` (consumed in
    `tree_leaves` order)."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    return fill(template)


def save_checkpoint(directory: str, epoch: int, tree, np_rng_state: dict | None = None,
                    best: dict | None = None, keep: int = 2) -> str:
    """Write the tree's leaves (numpy arrays) and the sidecar; prune to
    the newest ``keep`` checkpoints. Returns the ``.npz`` path."""
    leaves = [np.asarray(leaf) for leaf in tree_leaves(tree)]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{epoch}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, *leaves)
    os.replace(tmp, path)
    meta = {"epoch": epoch, "num_leaves": len(leaves)}
    if np_rng_state is not None:
        meta["np_rng_state"] = np_rng_state
    if best is not None:
        meta["best"] = best
    with open(os.path.join(directory, f"ckpt_{epoch}.json"), "w") as f:
        json.dump(meta, f, default=_jsonable)

    for old in sorted(_list_epochs(directory))[:-keep]:
        for suffix in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt_{old}{suffix}"))
            except OSError:
                pass
    return path


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    raise TypeError(type(x))


def _list_epochs(directory: str) -> list[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [int(m.group(1)) for m in map(_CKPT_RE.match, names) if m]


def latest_checkpoint(directory: str) -> int | None:
    epochs = _list_epochs(directory)
    return max(epochs) if epochs else None


def resolve_epoch(directory: str, epoch: int | None = None) -> int:
    """``epoch``, or the latest checkpoint's when it is None."""
    if epoch is None:
        epoch = latest_checkpoint(directory)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    return epoch


def read_checkpoint(directory: str, epoch: int) -> tuple[list[np.ndarray], dict]:
    """(leaves in file order, sidecar) of one checkpoint, whichever
    package wrote it."""
    with np.load(os.path.join(directory, f"ckpt_{epoch}.npz")) as z:
        arrays = [z[f"arr_{i}"] for i in range(len(z.files))]
    with open(os.path.join(directory, f"ckpt_{epoch}.json")) as f:
        meta = json.load(f)
    return arrays, meta


def load_checkpoint(directory: str, epoch: int, template):
    """Returns (tree, meta) with the template's structure, leaf order,
    dtypes and shapes."""
    arrays, meta = read_checkpoint(directory, epoch)
    leaves = tree_leaves(template)
    if len(arrays) != len(leaves):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template has {len(leaves)}")

    def fit(a, t):
        t = np.asarray(t)
        a = np.asarray(a, dtype=t.dtype)
        if a.shape == t.shape:
            return a
        if a.size == t.size and a.ndim != t.ndim:
            return a.reshape(t.shape)  # pure rank difference, e.g. () vs (1,)
        raise ValueError(
            f"checkpoint leaf shape {a.shape} is incompatible with the "
            f"template's {t.shape} — was the run configuration "
            f"(embedding_size / layers / dataset) changed since the "
            f"checkpoint was written?")

    return tree_unflatten(template, [fit(a, t) for a, t in zip(arrays, leaves)]), meta
