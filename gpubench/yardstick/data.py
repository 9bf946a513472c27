"""The inputs of a run, made from ``--seed``: the interaction pairs and
the embedding tables.

`synthetic_pairs` is the benchmark's own copy of the port's
``make_synthetic_dataset`` (idgrec_torch/data/dataset.py): a bipartite
set of unique (user, item) pairs at a public data set's scale, users
uniform, item popularity Zipf(``zipf``), train and test drawn apart.
The copy stays here so that a change to the program's generator cannot
change what the benchmark measures.

`draw_tables` draws each table (and a model's state) on the card as the
reference framework initialises it, Xavier-uniform tables and
`torch.nn.Linear`'s layers, one call a tensor from one
`torch.Generator` on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds derived from ``seed`` (any
    non-negative whole number)."""
    children = np.random.SeedSequence(int(seed)).spawn(n)
    return [int(c.generate_state(1, np.uint64)[0] & np.uint64(2**63 - 1)) for c in children]


def synthetic_pairs(num_users: int, num_items: int, num_train: int, num_test: int,
                    seed: int, zipf: float = 0.8):
    """(train_user, train_item, test_user, test_item), int64 arrays of
    unique pairs each; ``num_train`` and ``num_test`` of them exactly."""
    rng = np.random.default_rng(seed)
    item_p = (1.0 / np.arange(1, num_items + 1)) ** zipf
    item_p /= item_p.sum()

    def unique_pairs(n: int):
        total = num_users * num_items
        n = min(n, total)
        if total <= 4_000_000 and n > total // 8:
            flat = rng.choice(total, size=n, replace=False)
            return flat // num_items, flat % num_items
        users = np.empty(0, np.int64)
        items = np.empty(0, np.int64)
        while users.size < n:
            k = int((n - users.size) * 1.2) + 16
            u = rng.integers(0, num_users, k)
            i = rng.choice(num_items, size=k, p=item_p)
            users = np.concatenate([users, u])
            items = np.concatenate([items, i])
            _, idx = np.unique(users * num_items + items, return_index=True)
            idx.sort()
            users, items = users[idx], items[idx]
        return users[:n], items[:n]

    train_user, train_item = unique_pairs(num_train)
    test_user, test_item = unique_pairs(num_test)
    return train_user, train_item, test_user, test_item


def draw_tables(specs: dict[str, list], sizes: dict[str, int], seed: int,
                device: torch.device) -> dict[str, torch.Tensor]:
    """float32 tensors by name, drawn in name order from one generator
    on ``device``. A spec is [init, dim, ...], each dim a key of
    ``sizes``: ``xavier`` U(-a, a), a = sqrt(6 / (rows + cols));
    ``linear_w`` [fan_in, fan_out] and ``linear_b`` [fan_out] (its dims
    fan_in, fan_out) U(-k, k), k = 1 / sqrt(fan_in), as `torch.nn.Linear`
    draws them; ``normal`` N(0, 1); ``ones``; ``zeros``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in sorted(specs):
        init, *dims = specs[name]
        shape = tuple(int(sizes[k]) for k in dims)
        t = torch.empty(shape[-1:] if init == "linear_b" else shape, dtype=torch.float32,
                        device=device)
        if init == "xavier":
            limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            t.uniform_(-limit, limit, generator=gen)
        elif init in ("linear_w", "linear_b"):
            k = float(1.0 / np.sqrt(shape[0]))
            t.uniform_(-k, k, generator=gen)
        elif init == "normal":
            t.normal_(generator=gen)
        elif init in ("ones", "zeros"):
            t.fill_(1.0 if init == "ones" else 0.0)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t
    return out
