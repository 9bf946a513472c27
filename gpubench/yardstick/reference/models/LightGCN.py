"""LightGCN (He et al., SIGIR 2020): the mean of layers 0..K of
h_{k+1} = Â h_k; BPR on the propagated rows, -log(sigmoid(x) + 1e-7) as
the reference framework writes it, plus reg_lambda times the L2 of the
batch's ego rows, ½‖E‖² over the batch size for each of the user, the
positive and the negative rows."""

from __future__ import annotations

import torch

from yardstick.reference.graph import propagate_mean

BPR_EPS = 1e-7


def bpr(user_e, pos_e, neg_e) -> torch.Tensor:
    x = torch.sum(user_e * pos_e, dim=1) - torch.sum(user_e * neg_e, dim=1)
    return torch.mean(-torch.log(torch.sigmoid(x) + BPR_EPS))


def ego_l2(tables, users, pos, neg) -> torch.Tensor:
    b = users.shape[0]
    rows = (tables["user_emb"][users], tables["item_emb"][pos], tables["item_emb"][neg])
    return sum(0.5 * torch.sum(r * r) for r in rows) / b


def loss_terms(adj, tables, batch, cfg, gen=None, state=None) -> list[torch.Tensor]:
    users, pos, neg = batch
    e0 = torch.cat([tables["user_emb"], tables["item_emb"]])
    final = propagate_mean(adj, e0, cfg.int("GCN_layer"), include_layer0=True)
    uf, itf = final[: adj.num_users], final[adj.num_users:]
    return [bpr(uf[users], itf[pos], itf[neg]),
            cfg.float("reg_lambda") * ego_l2(tables, users, pos, neg)]


@torch.no_grad()
def eval_repr(adj, tables, cfg):
    e0 = torch.cat([tables["user_emb"], tables["item_emb"]])
    final = propagate_mean(adj, e0, cfg.int("GCN_layer"), include_layer0=True)
    return final[: adj.num_users], final[adj.num_users:]
