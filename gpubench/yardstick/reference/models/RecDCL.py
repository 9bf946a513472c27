"""RecDCL (Zhang et al., WWW 2024): LightGCN propagation (the mean of
layers 0..K); on the batch's normalised user and positive rows a
Barlow-Twins term through a projector (Linear, batch norm, ReLU twice,
then Linear, no biases), the cross-correlation of the two sides'
affine-free batch norms, (Σ(diag − 1)² + bt_coeff · Σ off-diagonal²) / d;
a polynomial uniformity term log(mean((a · XᵀX + c) ** degree)) over
each side's projected batch norm, the two sides averaged; and a momentum
term, each side's predictor output (Linear with bias) against the other
side's target, momentum · history + (1 − momentum) · the detached row,
by cosine. The histories are the model's state: read at the batch's
rows, then overwritten there with the batch's detached rows. Batch norms
take the batch's mean and population variance, eps 1e-5."""

from __future__ import annotations

import torch

from yardstick.reference.graph import propagate_mean

BN_EPS = 1e-5


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _batch_norm(x, gamma=None, beta=None):
    mean = torch.mean(x, dim=0, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=0, keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return y if gamma is None else y * gamma + beta


def _projector(t, x):
    h = torch.relu(_batch_norm(x @ t["proj_w1"], t["proj_bn1_gamma"], t["proj_bn1_beta"]))
    h = torch.relu(_batch_norm(h @ t["proj_w2"], t["proj_bn2_gamma"], t["proj_bn2_beta"]))
    return h @ t["proj_w3"]


def _barlow_twins(t, x, y, bt_coeff):
    d = x.shape[1]
    c = _batch_norm(_projector(t, x)).T @ _batch_norm(_projector(t, y)) / x.shape[0]
    diag = torch.diagonal(c)
    return (torch.sum((diag - 1.0) ** 2) + bt_coeff * (torch.sum(c ** 2) - torch.sum(diag ** 2))) / d


def _poly(t, x, cfg):
    bn = _batch_norm(_projector(t, x))
    return torch.log(torch.mean(torch.pow(cfg.float("a") * (bn.T @ bn) + cfg.float("polyc"),
                                          cfg.float("degree"))))


def loss_terms(adj, tables, batch, cfg, gen=None, state=None) -> list[torch.Tensor]:
    users, pos, _ = batch
    e0 = torch.cat([tables["user_emb"], tables["item_emb"]])
    final = propagate_mean(adj, e0, cfg.int("GCN_layer"), include_layer0=True)
    user_g, pos_g = final[: adj.num_users][users], final[adj.num_users:][pos]
    m = cfg.float("momentum")
    u_target = state["u_target_his"][users] * m + user_g.detach() * (1.0 - m)
    i_target = state["i_target_his"][pos] * m + pos_g.detach() * (1.0 - m)
    user_n, pos_n = _normalize(user_g), _normalize(pos_g)
    bt = _barlow_twins(tables, user_n, pos_n, cfg.float("bt_coeff"))
    poly = _poly(tables, user_n, cfg) / 2 + _poly(tables, pos_n, cfg) / 2
    user_p = user_g @ tables["pred_w"] + tables["pred_b"]
    pos_p = pos_g @ tables["pred_w"] + tables["pred_b"]
    cos_u = torch.sum(_normalize(user_p) * _normalize(i_target), dim=-1)
    cos_i = torch.sum(_normalize(pos_p) * _normalize(u_target), dim=-1)
    mom = -torch.mean(cos_u) / 2 - torch.mean(cos_i) / 2
    with torch.no_grad():
        state["u_target_his"][users] = user_g.detach()
        state["i_target_his"][pos] = pos_g.detach()
    return [cfg.float("all_bt_coeff") * bt, cfg.float("poly_coeff") * poly,
            cfg.float("mom_coeff") * mom]


@torch.no_grad()
def eval_repr(adj, tables, cfg):
    e0 = torch.cat([tables["user_emb"], tables["item_emb"]])
    final = propagate_mean(adj, e0, cfg.int("GCN_layer"), include_layer0=True)
    return final[: adj.num_users], final[adj.num_users:]
