"""idgrec_torch: the PyTorch/CUDA port of idgrec_tpu for one NVIDIA H100.

The JAX package `idgrec_tpu` stays beside this one as the reference;
this package imports nothing of it (tests/test_torch_isolation.py).
Module names mirror the JAX package's, so each counterpart is found
under the same path.

What runs today is LightGCN, served and trained, in the quantized modes
(int8, int4) and the exact modes (bfloat16, float32) on the fused, dense
and gather backends: `models.get_model("LightGCN")` builds the adjacency
on the device; `serving.Recommender` computes the propagated embeddings
once (on the fused backend through the hand-written Hopper kernels in
`csrc/`) and answers top-K requests; `engine.sampler.NegativeSampler`,
`engine.trainer.EpochRunner` and `engine.evaluator.Evaluator` sample,
train (the backward runs the same kernels) and evaluate;
`engine.loop.train_model` is the run harness under `main` and `serve`.
Every entry point takes an explicit ``device`` and runs on the card
unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

from idgrec_torch.config import Config, load_model_config, read_configuration
from idgrec_torch.device import resolve_device

__all__ = [
    "Config",
    "load_model_config",
    "read_configuration",
    "resolve_device",
    "__version__",
]
