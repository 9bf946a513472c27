"""Run logging in the reference's golden-trace format (the port's own
copy of idgrec_tpu/engine/logging_utils.py).

Logs go to ``log/<MODEL>/<dataset>.log`` with
``%(asctime)s - %(message)s`` lines, and structured events to
``log/<MODEL>/<dataset>.jsonl`` beside them, in the JAX package's line
formats, so the logs of both packages can be compared.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import numpy as np


class RunLogger:
    def __init__(self, model_name: str, dataset_name: str, log_dir: str | None = "log",
                 echo: bool = True):
        self.echo = echo
        self._logger = logging.getLogger(f"idgrec_torch.{model_name}.{dataset_name}.{id(self)}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        self._jsonl_path = None
        if log_dir is not None:
            model_dir = os.path.join(log_dir, model_name)
            os.makedirs(model_dir, exist_ok=True)
            handler = logging.FileHandler(
                os.path.join(model_dir, f"{dataset_name}.log"), "a", encoding="utf-8")
            handler.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
            self._logger.addHandler(handler)
            self._jsonl_path = os.path.join(model_dir, f"{dataset_name}.jsonl")

    def info(self, message: str) -> None:
        self._logger.info(message)
        if self.echo:
            print(message)

    def event(self, **payload: Any) -> None:
        if self._jsonl_path:
            payload.setdefault("time", time.time())
            with open(self._jsonl_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(payload, default=_jsonable) + "\n")

    def close(self) -> None:
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)


def _jsonable(x: Any):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return str(x)


def loss_string(term_sums, num_batch: int) -> str:
    """``total = t1 + t2 + ...`` with the reference's rounding and
    normalization (divide by len // B + 1)."""
    terms = [float(t) / num_batch for t in term_sums]
    return str(round(sum(terms), 6)) + " = " + " + ".join(str(round(t, 6)) for t in terms)
