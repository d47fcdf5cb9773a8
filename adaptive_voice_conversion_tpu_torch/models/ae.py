"""The AdaIN-VC autoencoder: one-shot conversion and speaker embedding.

Public methods take and return (B, T, C) mels, as the JAX package's
``ae_inference`` and ``get_speaker_embedding`` do; the modules inside run
on (B, C, T).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import AEConfig
from .modules import ContentEncoder, Decoder, SpeakerEncoder, global_draw


class AE(nn.Module):
    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.cfg = cfg
        self.speaker_encoder = SpeakerEncoder(cfg.speaker_encoder)
        self.content_encoder = ContentEncoder(cfg.content_encoder)
        self.decoder = Decoder(cfg.decoder)

    def forward(
        self,
        x: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        rows: Optional[Tuple[int, int, int]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training forward: the same utterance x (B, T, C) feeds both
        encoders; ``z = mu + exp(log_sigma / 2) * eps``. Returns
        ``(mu, log_sigma, emb, dec)`` on (B, T, C).

        ``eps`` (B, T/prod(subsample), c_out) f32 is the normal draw; when
        it is None it is drawn from ``generator`` (which must be on x's
        device). ``generator`` also feeds the dropout masks in training
        mode. ``rows = (lo, hi, B_global)`` says that x is rows ``lo:hi`` of
        a global batch of ``B_global`` (one rank of a data-parallel run):
        ``eps`` and the masks are then drawn at the global shape and sliced
        (modules.py ``global_draw``), so the ranks draw together what one
        process draws; without it the draws are at x's shape."""
        xc = x.transpose(1, 2)
        emb = self.speaker_encoder(xc, generator, compute_dtype, rows)
        mu, log_sigma = self.content_encoder(xc, generator, compute_dtype, rows)
        if eps is None:
            eps = global_draw(torch.randn, log_sigma.shape, rows, x.device, generator)
        else:
            eps = eps.transpose(1, 2)
        z = mu + torch.exp(log_sigma / 2) * eps
        dec = self.decoder(z, emb, generator, compute_dtype, rows)
        return mu.transpose(1, 2), log_sigma.transpose(1, 2), emb, dec.transpose(1, 2)

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
