"""Model zoo of the port. Importing this package registers every ported
model: LightGCN, EGCF, MFBPR, the encoder-switch family (DirectAU, MAWU,
SCCF, LightCCF, LightCSCF), LightGCN_pp, the models that draw noise
in their steps (SimGCL, XSimGCL, BIGCF, MixRec), the full-pool
contrasts CGCL and NCL (NCL with on-device k-means), HCCF and IMPGCN,
the weighted graph convolutions NGCF, GCMC and GCCF, LightGODE's graph
ODE and RecDCL, the first model with state, the two models on the
rectangular adjacency, LightGCL (with its low-rank SVD branch) and CVGA
(user-row batches), and SGL with its per-epoch edge-dropout views: the
JAX package's twenty-five."""

from idgrec_torch.models import registry
from idgrec_torch.models.registry import available_models, get_model

from idgrec_torch.models import (  # noqa: F401
    bigcf,
    cgcl,
    cvga,
    directau,
    egcf,
    hccf,
    impgcn,
    lightccf,
    lightcscf,
    lightgcl,
    lightgcn,
    lightgcn_pp,
    lightgode,
    mawu,
    mfbpr,
    mixrec,
    ncl,
    ngcf,
    recdcl,
    sccf,
    sgl,
    simgcl,
    xsimgcl,
)

__all__ = ["registry", "available_models", "get_model"]
