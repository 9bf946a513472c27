"""Row-padded storage of the sharded training state (counterpart of
idgrec_tpu/parallel/padding.py; ROADMAP A.9).

Real row counts (yelp2018: 31,668 users, 38,048 items) do not divide a
model axis, so every large [N, d] leaf of the tables and of Adam's
moments is stored zero-padded to a 128-row multiple, which divides any
power-of-two model axis up to 128, and sliced back to its true rows
before any model code sees it:

    stored   [N_pad, d]   1/width of the rows a rank
    compute  [N, d]       true shape, models unchanged

Pad rows get zero gradients (the slice's backward pads the cotangent
with zeros) and so zero Adam updates: they stay zero. Trees are nested
dicts of tensors or arrays; a meta tree holds each padded leaf's true
row count and `NO_PAD` elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PAD = 128
NO_PAD = -1  # meta sentinel: the leaf is stored at its natural shape


def pad_to(n: int) -> int:
    return -(-n // PAD) * PAD


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def build_meta(tree, model_width: int, node_rows=None):
    """The meta of ``tree``: a leaf's true row count where it is stored
    padded, else `NO_PAD`. With ``node_rows`` (the row counts of the node
    tables: users, items, their sum) only leaves of those row counts pad;
    without it any 2-D leaf of at least 2·width rows does. A leaf whose
    rows are already a 128-multiple is stored as it is."""

    def leaf(x):
        if len(getattr(x, "shape", ())) != 2 or x.shape[0] % PAD == 0:
            return NO_PAD
        if node_rows is not None:
            return x.shape[0] if x.shape[0] in node_rows else NO_PAD
        return x.shape[0] if x.shape[0] >= 2 * model_width else NO_PAD

    return _map(leaf, tree)


def pad_rows(x, rows: int):
    """``x`` zero-padded below to ``rows`` rows (tensor or array)."""
    if torch.is_tensor(x):
        return F.pad(x, (0, 0, 0, rows - x.shape[0]))
    return np.pad(np.asarray(x), ((0, rows - x.shape[0]), (0, 0)))


def pad_tree(tree, meta):
    return _map(lambda x, n: x if n == NO_PAD else pad_rows(x, pad_to(n)), tree, meta)


def unpad_tree(tree, meta):
    return _map(lambda x, n: x if n == NO_PAD else x[:n], tree, meta)
