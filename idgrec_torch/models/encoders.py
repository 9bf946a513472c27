"""Shared encoder switch: the MF tables or LightGCN propagation
(counterpart of idgrec_tpu/models/encoders.py).

DirectAU, MAWU, SCCF, LightCCF and LightCSCF choose their encoder from
the config (``encoder = MF | LightGCN``). Under LightGCN the tables go
through `lightgcn_propagate` over the square ``sym`` adjacency: with the
configs as published (bfloat16, backend ``auto``) that is ``dense`` on
the card, one launch of kernel K6 a layer each way.
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import concat_user_item, lightgcn_propagate, split_user_item
from idgrec_torch.ops.propagate import build_adjacency


class EncoderSwitchMixin:
    """Adds ``self.encoder`` ('MF' or 'LightGCN') and `encode`; mixed in
    before `RecModel`."""

    def _init_encoder(self, config, data) -> None:
        self.encoder = config.str("encoder", "MF")
        if self.encoder == "LightGCN":
            self.num_layers = config.int("GCN_layer")
            self.graph = build_adjacency(
                data, "sym", self.backend, compute_dtype=self.compute_dtype,
                emb_size=self.embedding_size, device=self.device,
            )
        elif self.encoder != "MF":
            raise ValueError(f"unknown encoder {self.encoder!r}")

    def encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(all user embeddings, all item embeddings) under the configured
        encoder: the tables themselves under MF."""
        if self.encoder == "MF":
            return self.user_emb, self.item_emb
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        final = lightgcn_propagate(self.graph, emb0, self.num_layers)
        return split_user_item(final, self.num_users)

    @torch.no_grad()
    def eval_embeddings(self) -> tuple[torch.Tensor, torch.Tensor]:
        """`encode` without the graph of the backward; under MF copies of
        the tables, so that what a server holds does not move with later
        training steps."""
        user_all, item_all = self.encode()
        if self.encoder == "MF":
            return user_all.detach().clone(), item_all.detach().clone()
        return user_all, item_all
