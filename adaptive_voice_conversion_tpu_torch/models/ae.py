"""The AdaIN-VC autoencoder: one-shot conversion and speaker embedding.

Public methods take and return (B, T, C) mels, as the JAX package's
``ae_inference`` and ``get_speaker_embedding`` do; the modules inside run
on (B, C, T).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import AEConfig
from .modules import ContentEncoder, Decoder, SpeakerEncoder


class AE(nn.Module):
    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.cfg = cfg
        self.speaker_encoder = SpeakerEncoder(cfg.speaker_encoder)
        self.content_encoder = ContentEncoder(cfg.content_encoder)
        self.decoder = Decoder(cfg.decoder)

    def inference(self, x: torch.Tensor, x_cond: torch.Tensor) -> torch.Tensor:
        """Speaker embedding from the target x_cond (B, T_c, C), content mu
        (no sampling) from the source x (B, T, C) -> converted (B, T', C)."""
        emb = self.speaker_encoder(x_cond.transpose(1, 2))
        mu, _ = self.content_encoder(x.transpose(1, 2))
        return self.decoder(mu, emb).transpose(1, 2)

    def get_speaker_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, c_out)."""
        return self.speaker_encoder(x.transpose(1, 2))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
