"""Model zoo of the port. Importing this package registers every ported
model (LightGCN and EGCF so far; ROADMAP A.7 lists the rest)."""

from idgrec_torch.models import registry
from idgrec_torch.models.registry import available_models, get_model

from idgrec_torch.models import egcf, lightgcn  # noqa: F401

__all__ = ["registry", "available_models", "get_model"]
