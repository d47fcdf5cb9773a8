"""One-shot voice conversion: a single utterance, or a batch of pairs.

Source wav -> content mu; target wav (one utterance of an unseen speaker)
-> speaker embedding; the AdaIN decoder recombines them; Griffin-Lim
vocodes, or, where the config's ``vocoder`` section names "hifigan", the
HiFi-GAN generator (models/hifigan.py) does, from the decoder's normalised
output as it is. Featurization is host numpy; the model and the vocoder run
on the Inferencer's device (``cuda`` unless the caller asks for the CPU).

``convert_grid`` and ``convert_pairs`` serve many pairs in one padded
batch through the length-masked model (models/masked.py) and one ragged
Griffin-Lim call (dsp/vocoder.py) or one length-masked generator call, so
mixed-length inputs convert as one-at-a-time conversion would convert them.

With a mesh (core/mesh.py) the pair batch is split over the ranks: every
rank is handed the same request, converts and vocodes its contiguous rows
(one fused-kernel launch per rank), and the ranks gather the results, so
every rank returns every pair.
"""

from __future__ import annotations

import math
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import DeviceLike, resolve_device, set_precision
from ..core.mesh import Mesh, all_gather_rows, put_global_from_full
from ..dsp.audio import deemphasis_torch, save_wav
from ..dsp.features import get_spectrograms
from ..dsp.vocoder import (
    GL_METHODS,
    griffin_lim,
    griffin_lim_masked,
    mel_to_mag,
    melspectrogram2wav,
    melspectrogram2wav_np,
    to_host_trimmed,
)
from ..models.ae import AE
from ..models.hifigan import Generator
from ..models.masked import ae_inference_masked
from ..utils.profiling import span


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
        mesh: Optional[Mesh] = None,
        vocoder: Optional[Generator] = None,
    ):
        """``model`` is moved to ``device`` (default ``cuda``; the rank's GPU
        under a process group).

        ``gl_method``: "exact" or "fused", or "pallas", the JAX package's
        name for "fused" (dsp/vocoder.py ``griffin_lim``).
        ``precision``: None/"default" keeps PyTorch's defaults, "highest"
        turns TF32 off for matmuls and cuDNN convolutions, "high" allows it
        (core/device.py ``set_precision``; a process-wide switch).
        ``gpu_vocoder=False`` vocodes on the CPU whatever ``device`` is: one
        utterance with the numpy oracle ``melspectrogram2wav_np``, whatever
        ``gl_method`` is (as the JAX package's ``use_tpu_vocoder=False``),
        a batch with the torch vocoder on the CPU. ``mesh``: serve
        ``convert_grid`` / ``convert_pairs`` over its ranks (the module
        docstring); every rank must make the same calls.

        Where ``config.vocoder.kind`` is "hifigan", ``vocoder`` (required
        then, refused with Griffin-Lim; models/weights.py ``load_generator``
        reads a checkpoint) vocodes on ``device``: ``gl_method`` and
        ``gl_iters`` are then ignored, and ``gpu_vocoder=False`` raises."""
        if gl_method not in GL_METHODS:
            raise ValueError(f"gl_method={gl_method!r}: expected one of {GL_METHODS}")
        set_precision(precision)
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.gl_method = gl_method
        self.gpu_vocoder = gpu_vocoder
        self.vocoder_device = self.device if gpu_vocoder else torch.device("cpu")
        with open(attr_path, "rb") as f:
            self.attr = pickle.load(f)
        self.vocoder = self._check_vocoder(vocoder)

    def _check_vocoder(self, vocoder: Optional[Generator]) -> Optional[Generator]:
        """The HiFi-GAN generator on the device, or None for Griffin-Lim."""
        if self.config.vocoder.kind == "griffin_lim":
            if vocoder is not None:
                raise ValueError("the config's vocoder is Griffin-Lim: a generator was given "
                                 "but the config has no hifigan vocoder section")
            return None
        if vocoder is None:
            raise ValueError("the config's vocoder is hifigan: give the generator "
                             "(vocoder=; --vocoder_ckpt on the CLIs)")
        if not self.gpu_vocoder:
            raise ValueError("gpu_vocoder=False selects the numpy Griffin-Lim oracle; the "
                             "config's vocoder is hifigan")
        return vocoder.to(self.device).eval()

    @classmethod
    def from_torch_checkpoint(
        cls, config: TrainConfig, ckpt_path: str, attr_path: str,
        device: DeviceLike = None, **kw,
    ) -> "Inferencer":
        """Load a reference-format ``.ckpt`` (a torch state_dict)."""
        from ..models.weights import load_checkpoint

        model = load_checkpoint(ckpt_path, config.model, device)
        return cls(config, model, attr_path, device=device, **kw)

    @classmethod
    def from_train_checkpoint(
        cls, config: TrainConfig, store_model_path: str, attr_path: str,
        device: DeviceLike = None, **kw,
    ) -> "Inferencer":
        """Load the newest training checkpoint under
        ``<store_model_path>.ckpts/`` (train/checkpoint.py). Only the
        model's state_dict is read; the optimiser state is not needed."""
        from ..train.checkpoint import CheckpointManager

        dev = resolve_device(device)
        mngr = CheckpointManager(f"{store_model_path}.ckpts")
        step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {store_model_path}.ckpts")
        model_state, _, _ = mngr.restore(step)
        model = AE(config.model)
        model.load_state_dict(model_state, strict=True)
        return cls(config, model, attr_path, device=dev, **kw)

    @classmethod
    def from_model_path(
        cls, config: TrainConfig, model_path: str, attr_path: str, **kw
    ) -> "Inferencer":
        """What the CLIs' ``-m`` means: training checkpoints when
        ``<model_path>.ckpts/`` exists, else a reference-format ``.ckpt``."""
        import os

        if os.path.isdir(f"{model_path}.ckpts"):
            return cls.from_train_checkpoint(config, model_path, attr_path, **kw)
        return cls.from_torch_checkpoint(config, model_path, attr_path, **kw)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.attr["mean"]) / self.attr["std"]

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return x * self.attr["std"] + self.attr["mean"]

    def _denormalized(self, dec: torch.Tensor) -> torch.Tensor:
        """``denormalize`` of the decoder's f32 output on its device, bit for
        bit and dtype included: the arithmetic runs in numpy's promotion of
        float32 and the attr's dtype (float32 for the ETL's attr.pkl)."""
        std, mean = self.attr["std"], self.attr["mean"]
        dtype = np.result_type(np.float32, std, mean)
        std, mean = (torch.as_tensor(np.asarray(a, dtype), device=dec.device) for a in (std, mean))
        return dec.to(std.dtype) * std + mean

    def _convert(self, src_mel: np.ndarray, tar_mel: np.ndarray) -> torch.Tensor:
        """Normalized mels (T, n_mels) -> the decoder's converted normalized
        mel (1, T', n_mels) on the device."""
        f = self.config.data_loader.frame_size
        to_dev = lambda m: torch.from_numpy(
            utt_make_frames(np.asarray(m, np.float32), f)
        ).to(self.device)
        with span("infer.assemble"):
            src, tar = to_dev(src_mel), to_dev(tar_mel)
        with torch.no_grad(), span("infer.model"):
            return self.model.inference(src, tar)

    def convert_mel(self, src_mel: np.ndarray, tar_mel: np.ndarray) -> np.ndarray:
        """Normalized mels (T, n_mels) -> converted normalized mel (T', n_mels)."""
        dec = self._convert(src_mel, tar_mel)
        with span("infer.to_host"):
            return dec[0].cpu().numpy()

    def inference_one_utterance(
        self, src_mel: np.ndarray, tar_mel: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (wav, converted denormalized mel). The model's output stays
        on the device for the vocoder (the generator, where the config names
        it, takes the normalized mel); the denormalized mel crosses to the
        host once, after the wav (the numpy oracle vocodes that copy)."""
        dec = self._convert(src_mel, tar_mel)
        mel, wav = self._denormalized(dec)[0], None
        if self.vocoder is not None:
            wav = self._generate_one(dec)
        elif self.gpu_vocoder:
            with torch.no_grad():
                wav = melspectrogram2wav(mel, self.config.signal, gl_method=self.gl_method)
        with span("infer.to_host"):
            mel = mel.cpu().numpy()
        if wav is None:  # gpu_vocoder=False: the numpy oracle on the host's copy
            wav = melspectrogram2wav_np(mel, self.config.signal)
        return wav, mel

    def _generate_one(self, dec: torch.Tensor) -> np.ndarray:
        """The generator on one normalized mel (1, T, n_mels) on the device
        -> trimmed wav."""
        with torch.no_grad(), span("infer.generate"):
            wav = self.vocoder.generate(dec)
        return to_host_trimmed(wav, None)[0]

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

    # -- batched serving --------------------------------------------------

    def _padded_shapes(self, src_lens, tar_lens, len_bucket: int) -> Tuple[int, int]:
        """Padded source and target frame counts. Sources pad to a multiple
        of the content encoder's downsample product, so the strided chain
        keeps whole physical shapes (the masked ops handle each sample's
        valid length). ``len_bucket`` > 1 rounds both up to bucket multiples
        as well, so that a deployment sees few distinct shapes; the masked
        path is exact under any padding, so results do not depend on it."""
        sub = int(np.prod(self.config.model.content_encoder.subsample))
        bk = max(len_bucket, 1)
        bs = sub * bk // math.gcd(sub, bk)
        ts = -(-int(max(src_lens)) // bs) * bs
        tt = -(-int(max(tar_lens)) // bk) * bk
        return ts, tt

    def _stack(self, mels: Sequence[np.ndarray], t: int) -> torch.Tensor:
        """Mels (L_i, n_mels) zero-padded to t frames, stacked, on the device."""
        out = np.zeros((len(mels), t, mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            out[i, : m.shape[0]] = m
        return torch.from_numpy(out).to(self.device)

    def _pair_batch(self, src_mels, tar_mels, len_bucket: int):
        """Padded (src, src_lens, tar, tar_lens) tensors on the device for a
        list of sources and a list of targets: ``convert_pairs`` takes them
        index by index, ``_grid_batch`` crosses them."""
        src_lens = [int(m.shape[0]) for m in src_mels]
        tar_lens = [int(m.shape[0]) for m in tar_mels]
        ts, tt = self._padded_shapes(src_lens, tar_lens, len_bucket)
        lens = lambda l: torch.tensor(l, dtype=torch.int64, device=self.device)
        return self._stack(src_mels, ts), lens(src_lens), self._stack(tar_mels, tt), lens(tar_lens)

    def _grid_batch(self, src_mels, tar_mels, len_bucket: int = 1):
        """The ns x nt cross product, row-major (i * nt + j), as
        ``_pair_batch`` tensors. It is made on the device, so only the
        ns + nt unique mels cross the bus."""
        ns, nt = len(src_mels), len(tar_mels)
        src, sl, tar, tl = self._pair_batch(src_mels, tar_mels, len_bucket)
        return (
            src.repeat_interleave(nt, dim=0), sl.repeat_interleave(nt),
            tar.repeat(ns, 1, 1), tl.repeat(ns),
        )

    def _require_frame_size_1(self, name: str) -> None:
        if self.config.data_loader.frame_size != 1:
            raise NotImplementedError(
                f"{name} assumes frame_size=1 (the shipped config); reshape "
                "inputs with utt_make_frames for other frame sizes"
            )

    def convert_grid(
        self,
        src_mels: Sequence[np.ndarray],
        tar_mels: Sequence[np.ndarray],
        gl_iters: Optional[int] = None,
        gl_method: Optional[str] = None,
        trim: bool = True,
        return_mels: bool = False,
        len_bucket: int = 1,
    ):
        """All pairs (src_i, tar_j) in one padded batch through the model
        and one batched Griffin-Lim call (or one generator call, where the
        config names HiFi-GAN: then ``gl_iters`` and ``gl_method`` are
        ignored). Returns the wavs row-major
        (i * n_t + j), or ``(wavs, mels)`` with the denormalized converted
        mels when ``return_mels`` (``inference_one_utterance``'s second
        return).

        Exact for mixed-length inputs: the model runs the length-masked
        forward passes and the vocoder the ragged Griffin-Lim, so every pair
        computes what ``inference_one_utterance`` computes at its true
        lengths. ``gl_method="fused"`` swaps the vocoder's bulk iterations
        for the fused kernel, between masked exact warm-start and polish
        iterations: still length-aware. A uniform grid (every source at the
        padded length, every target equal) has no padding, so it runs the
        unmasked model and the plain Griffin-Lim.
        """
        self._require_frame_size_1("convert_grid")
        with span("infer.assemble"):
            src_b, sl_b, tar_b, tl_b = self._grid_batch(src_mels, tar_mels, len_bucket)
            uniform = bool((sl_b == src_b.shape[1]).all() and (tl_b == tar_b.shape[1]).all())
        return self._serve_batch(
            src_b, sl_b, tar_b, tl_b, gl_method, gl_iters, uniform, trim, return_mels
        )

    def convert_pairs(
        self,
        pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
        gl_iters: Optional[int] = None,
        gl_method: Optional[str] = None,
        trim: bool = True,
        return_mels: bool = False,
        len_bucket: int = 1,
    ):
        """Convert an explicit list of (source_mel, target_mel) pairs in one
        padded batch: the serving shape when requests are not a cross
        product. The same guarantees and options as ``convert_grid``."""
        self._require_frame_size_1("convert_pairs")
        with span("infer.assemble"):
            src_mels = [np.asarray(s, np.float32) for s, _ in pairs]
            tar_mels = [np.asarray(t, np.float32) for _, t in pairs]
            batch = self._pair_batch(src_mels, tar_mels, len_bucket)
        return self._serve_batch(*batch, gl_method, gl_iters, False, trim, return_mels)

    def _vocode(
        self, dec: torch.Tensor, dec_lens: torch.Tensor, gl_method: str,
        gl_iters: Optional[int], uniform: bool,
    ) -> torch.Tensor:
        """The whole chain after the model, on the vocoder's device:
        denormalize, mel -> linear magnitude, Griffin-Lim, de-preemphasis.
        dec (B, T, n_mels) normalized -> wavs (B, hop*(T-1)). Where the config
        names HiFi-GAN, the generator on dec as it is, length-masked unless
        ``uniform``: wavs (B, hop*T)."""
        if self.vocoder is not None:
            with span("infer.generate"):
                return self.vocoder.generate(dec, None if uniform else dec_lens)
        cfg = self.config.signal
        dev = self.vocoder_device
        with span("infer.vocode"):
            mag = mel_to_mag(self._denormalized(dec.to(dev)), cfg)
            if uniform:
                wav = griffin_lim(mag, cfg, n_iter=gl_iters, method=gl_method)
            else:
                wav = griffin_lim_masked(
                    mag, dec_lens.to(dev), cfg, n_iter=gl_iters, method=gl_method
                )
            return deemphasis_torch(wav, cfg.preemphasis)

    def _serve_on_mesh(self, src_b, sl_b, tar_b, tl_b, gl_method, gl_iters, return_mels):
        """The mesh's share of ``_serve_batch``: the pair batch padded to a
        multiple of ``n_data`` with copies of pair 0 (dropped after the
        gather; the masked programs are per sample, so they change no real
        pair), this rank's contiguous rows through the masked model and the
        ragged vocoder, then the gather of every rank's rows. Returns
        (wavs, dec, dec_lens) of all pairs; dec and dec_lens only when
        ``return_mels``."""
        mesh = self.mesh
        n = src_b.shape[0]
        pad = (-n) % mesh.n_data
        if pad:
            rep = lambda a: torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
            src_b, sl_b, tar_b, tl_b = map(rep, (src_b, sl_b, tar_b, tl_b))
        src, sl, tar, tl = (put_global_from_full(a, mesh) for a in (src_b, sl_b, tar_b, tl_b))
        dec, dec_lens = ae_inference_masked(self.model, src, sl, tar, tl)
        wavs = self._vocode(dec, dec_lens, gl_method, gl_iters, False)
        # every rank's rows share the grid's padded length: the row blocks
        # gather as they are
        wavs = all_gather_rows(mesh, wavs)[:n]
        if not return_mels:
            return wavs, None, None
        return wavs, all_gather_rows(mesh, dec)[:n], all_gather_rows(mesh, dec_lens)[:n]

    def _serve_batch(
        self, src_b, sl_b, tar_b, tl_b, gl_method, gl_iters, uniform, trim,
        return_mels,
    ):
        """Shared by convert_grid and convert_pairs: the (masked) model, the
        vocode chain, one copy of the finished wavs to the host (with their
        silence bounds, computed where the wavs are, when ``trim``:
        ``to_host_trimmed``), and the crop / mels epilogue there. A pair's
        wav is cropped to its true source frame count, ``sl_b[k]``: hop x
        (sl_b[k] - 1) samples. With a mesh the masked model runs whatever
        the padding (``_serve_on_mesh``)."""
        gl_method = self.gl_method if gl_method is None else gl_method
        hop = self.config.signal.hop_length
        with span("infer.assemble"):
            crop_lens = sl_b.tolist()
        n = len(crop_lens)
        with torch.no_grad():
            if self.mesh is not None:
                wavs, dec, dec_lens = self._serve_on_mesh(
                    src_b, sl_b, tar_b, tl_b, gl_method, gl_iters, return_mels
                )
            else:
                with span("infer.model"):
                    if uniform:
                        dec = self.model.inference(src_b, tar_b)
                        dec_lens = torch.full((n,), dec.shape[1], dtype=torch.int64, device=dec.device)
                    else:
                        dec, dec_lens = ae_inference_masked(self.model, src_b, sl_b, tar_b, tl_b)
                wavs = self._vocode(dec, dec_lens, gl_method, gl_iters, uniform)
        if trim:
            out = to_host_trimmed(wavs, hop * (sl_b.to(wavs.device) - 1))
        else:
            with span("infer.to_host"):
                wavs = wavs.cpu().numpy()
            out = [wavs[k][: hop * (crop_lens[k] - 1)].astype(np.float32, copy=False) for k in range(n)]
        if not return_mels:
            return out
        mels = self._denormalized(dec)
        with span("infer.to_host"):
            mels, dl = mels.cpu().numpy(), dec_lens.cpu().numpy()
        return out, [mels[k, : dl[k]] for k in range(n)]
