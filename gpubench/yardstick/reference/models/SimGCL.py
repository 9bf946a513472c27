"""SimGCL (Yu et al., SIGIR 2022): LightGCN propagation without layer 0
in the mean; two views, each adding sign(h)·ε·normalize(U(0, 1)) to
every layer's output before the next layer; BPR and ego L2 on the clean
chain (as LightGCN); InfoNCE between the two views over the batch's
distinct users and over its distinct positive items, -log(pos / total +
1e-5) as the reference framework writes it, times ssl_lambda.

The noise is drawn from the generator the step is given, layer by layer
and view 1 before view 2, each draw U[0, 1) float32 of the chain's
[U + I, d] shape: the draw order of the reference framework, which the
program follows, so a generator in the program's state before the step
replays the program's noise."""

from __future__ import annotations

import torch

from yardstick.reference.graph import divide
from yardstick.reference.models.LightGCN import bpr, ego_l2

INFONCE_EPS = 1e-5


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _perturb(h: torch.Tensor, eps: float, gen: torch.Generator) -> torch.Tensor:
    noise = torch.rand(h.shape, generator=gen, device=gen.device, dtype=torch.float32)
    return h + torch.sign(h) * _normalize(noise) * eps


def _infonce(v1: torch.Tensor, v2: torch.Tensor, temperature: float) -> torch.Tensor:
    v1, v2 = _normalize(v1), _normalize(v2)
    pos = torch.exp(torch.sum(v1 * v2, dim=1) / temperature)
    total = torch.sum(torch.exp(v1 @ v2.T / temperature), dim=1)
    return torch.mean(-torch.log(pos / total + INFONCE_EPS))


def loss_terms(adj, tables, batch, cfg, gen, state=None) -> list[torch.Tensor]:
    users, pos, neg = batch
    nu = adj.num_users
    layers, eps = cfg.int("GCN_layer"), cfg.float("epsilon")
    e0 = torch.cat([tables["user_emb"], tables["item_emb"]])
    hc = h1 = h2 = e0
    acc = [0.0, 0.0, 0.0]
    for _ in range(layers):
        hc, h1, h2 = adj.matmul(hc), adj.matmul(h1), adj.matmul(h2)
        h1 = _perturb(h1, eps, gen)
        h2 = _perturb(h2, eps, gen)
        acc = [acc[0] + hc, acc[1] + h1, acc[2] + h2]
    clean, view1, view2 = (divide(a, layers) for a in acc)
    terms = [bpr(clean[:nu][users], clean[nu:][pos], clean[nu:][neg]),
             cfg.float("reg_lambda") * ego_l2(tables, users, pos, neg)]
    tau = cfg.float("temperature")
    du, di = torch.unique(users), torch.unique(pos)
    ssl = (_infonce(view1[:nu][du], view2[:nu][du], tau)
           + _infonce(view1[nu:][di], view2[nu:][di], tau))
    return terms + [cfg.float("ssl_lambda") * ssl]


@torch.no_grad()
def eval_repr(adj, tables, cfg):
    h, acc = torch.cat([tables["user_emb"], tables["item_emb"]]), 0.0
    layers = cfg.int("GCN_layer")
    for _ in range(layers):
        h = adj.matmul(h)
        acc = acc + h
    final = divide(acc, layers)
    return final[: adj.num_users], final[adj.num_users:]
