"""Model zoo of the port. Importing this package registers every ported
model: LightGCN, EGCF, MFBPR and the encoder-switch family (DirectAU,
MAWU, SCCF, LightCCF, LightCSCF); ROADMAP A.7 lists the rest."""

from idgrec_torch.models import registry
from idgrec_torch.models.registry import available_models, get_model

from idgrec_torch.models import (  # noqa: F401
    directau,
    egcf,
    lightccf,
    lightcscf,
    lightgcn,
    mawu,
    mfbpr,
    sccf,
)

__all__ = ["registry", "available_models", "get_model"]
