"""One-shot voice conversion of a single utterance.

Source wav -> content mu; target wav (one utterance of an unseen speaker)
-> speaker embedding; the AdaIN decoder recombines them; Griffin-Lim
vocodes. Featurization is host numpy; the model and the vocoder run on the
Inferencer's device (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import DeviceLike, resolve_device, set_precision
from ..dsp.audio import save_wav
from ..dsp.features import get_spectrograms
from ..dsp.vocoder import melspectrogram2wav
from ..models.ae import AE


def utt_make_frames(x: np.ndarray, frame_size: int) -> np.ndarray:
    """(T, n_mels) -> (1, T/frame_size, frame_size*n_mels); when T is not a
    multiple of frame_size, time frames are zero-padded."""
    t = x.shape[0]
    if t % frame_size:
        x = np.pad(x, ((0, frame_size - t % frame_size), (0, 0)))
    return x.reshape(1, x.shape[0] // frame_size, frame_size * x.shape[1])


class Inferencer:
    def __init__(
        self,
        config: TrainConfig,
        model: AE,
        attr_path: str,
        gl_method: str = "exact",
        precision: Optional[str] = None,
        device: DeviceLike = None,
        gpu_vocoder: bool = True,
    ):
        """``model`` is moved to ``device`` (default ``cuda``).

        ``gl_method``: "exact" or "fused" (dsp/vocoder.py ``griffin_lim``).
        ``precision``: None/"default" keeps PyTorch's defaults, "highest"
        turns TF32 off for matmuls and cuDNN convolutions, "high" allows it
        (core/device.py ``set_precision``; a process-wide switch).
        ``gpu_vocoder=False`` runs the vocoder on the CPU whatever
        ``device`` is."""
        if gl_method not in ("exact", "fused"):
            raise ValueError(f"gl_method={gl_method!r}: expected 'exact' or 'fused'")
        set_precision(precision)
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.gl_method = gl_method
        self.vocoder_device = self.device if gpu_vocoder else torch.device("cpu")
        with open(attr_path, "rb") as f:
            self.attr = pickle.load(f)

    @classmethod
    def from_torch_checkpoint(
        cls, config: TrainConfig, ckpt_path: str, attr_path: str,
        device: DeviceLike = None, **kw,
    ) -> "Inferencer":
        """Load a reference-format ``.ckpt`` (a torch state_dict)."""
        from ..models.weights import load_checkpoint

        model = load_checkpoint(ckpt_path, config.model, device)
        return cls(config, model, attr_path, device=device, **kw)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.attr["mean"]) / self.attr["std"]

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return x * self.attr["std"] + self.attr["mean"]

    def convert_mel(self, src_mel: np.ndarray, tar_mel: np.ndarray) -> np.ndarray:
        """Normalized mels (T, n_mels) -> converted normalized mel (T', n_mels)."""
        f = self.config.data_loader.frame_size
        to_dev = lambda m: torch.from_numpy(
            utt_make_frames(np.asarray(m, np.float32), f)
        ).to(self.device)
        with torch.no_grad():
            dec = self.model.inference(to_dev(src_mel), to_dev(tar_mel))
        return dec[0].cpu().numpy()

    def inference_one_utterance(
        self, src_mel: np.ndarray, tar_mel: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (wav, converted denormalized mel)."""
        dec = self.denormalize(self.convert_mel(src_mel, tar_mel))
        mel = torch.from_numpy(np.asarray(dec, np.float32)).to(self.vocoder_device)
        with torch.no_grad():
            wav = melspectrogram2wav(mel, self.config.signal, gl_method=self.gl_method)
        return wav, dec

    def inference_from_path(
        self, source_path: str, target_path: str, output_path: str
    ) -> np.ndarray:
        """Featurize both wavs, normalize, convert, vocode, write the wav."""
        src_mel, _ = get_spectrograms(source_path, self.config.signal)
        tar_mel, _ = get_spectrograms(target_path, self.config.signal)
        wav, _ = self.inference_one_utterance(
            self.normalize(src_mel), self.normalize(tar_mel)
        )
        save_wav(output_path, wav, self.config.signal.sr)
        return wav
