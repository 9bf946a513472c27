"""The plain reference the benchmark holds the program to: float32
PyTorch with TF32 off, no kernel, no cache, no batching trick; its
propagation products hold their operands in the precision the
configuration states (`graph.Adjacency`). It imports nothing of the
program; it works from the raw interaction pairs and the tables the
benchmark drew, and builds the normalised adjacency again itself.

One file a model under ``models/``, found by the configuration's
``model``: ``loss_terms(adj, tables, batch, cfg, gen, state)`` (a model
with state rewrites ``state`` in place) and ``eval_repr(adj, tables,
cfg)``.
"""

from __future__ import annotations

import importlib.util
import os

import torch

_MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")


def exact_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def model(name: str):
    """The reference module of model ``name`` (``models/<name>.py``)."""
    path = os.path.join(_MODELS, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no reference for model {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"gpubench_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
