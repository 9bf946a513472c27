"""idgrec_torch: the PyTorch/CUDA port of idgrec_tpu for one NVIDIA H100.

The JAX package `idgrec_tpu` stays beside this one as the reference;
this package imports nothing of it (tests/test_torch_isolation.py).
Module names mirror the JAX package's, so each counterpart is found
under the same path.

What runs today is LightGCN in the quantized int8 mode, served and
trained: `models.get_model("LightGCN")` builds the int8 count matrix on
the device; `serving.Recommender` computes the propagated embeddings
once through the hand-written Hopper kernels in `csrc/` and answers
top-K requests; `engine.sampler.NegativeSampler`,
`engine.trainer.EpochRunner` and `engine.evaluator.Evaluator` sample,
train (the backward runs the same kernels) and evaluate. Every entry
point takes an explicit ``device`` and runs on the card unless the
caller asks for ``device="cpu"``.
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
