"""The port's main path as a whole: one-shot conversion through the CLI on
the CPU, the Inferencer against the JAX package's Inferencer on the same
checkpoint, the device rules, and an import scan showing that neither the
port nor chip_smoke.py imports JAX or the JAX package."""

import ast
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from adaptive_voice_conversion_tpu.infer.inferencer import Inferencer as JInferencer
from adaptive_voice_conversion_tpu.infer.inferencer import utt_make_frames as j_frames
from adaptive_voice_conversion_tpu_torch.cli.inference import main
from adaptive_voice_conversion_tpu_torch.core import device as tdevice
from adaptive_voice_conversion_tpu_torch.core.config import config_from_dict
from adaptive_voice_conversion_tpu_torch.dsp.audio import save_wav
from adaptive_voice_conversion_tpu_torch.dsp.features import get_spectrograms
from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer, utt_make_frames
from adaptive_voice_conversion_tpu_torch.models.ae import AE
from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
from adaptive_voice_conversion_tpu_torch.models.weights import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
SR = 24000


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A narrow model at the 512-mel width, 12 Griffin-Lim iterations, two
    seeded 0.5 s wavs, their attr.pkl and a reference-format checkpoint."""
    d = tmp_path_factory.mktemp("conv")
    raw = yaml.safe_load((REPO / "examples" / "config.yaml").read_text())
    for k in ("SpeakerEncoder", "ContentEncoder"):
        raw[k].update(c_h=8, c_out=8, c_bank=4)
    raw["Decoder"].update(c_in=8, c_cond=8, c_h=8)
    raw["signal"] = {"n_iter": 12}
    (d / "config.yaml").write_text(yaml.safe_dump(raw))
    cfg = config_from_dict(raw)
    rng = np.random.default_rng(0)
    t = np.arange(SR // 2) / SR
    for name, f0 in (("source", 140.0), ("target", 210.0)):
        y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
        save_wav(str(d / f"{name}.wav"), (y + 0.01 * rng.standard_normal(len(t))).astype(np.float32), SR)
    mels = np.concatenate([get_spectrograms(str(d / f"{n}.wav"))[0] for n in ("source", "target")])
    with open(d / "attr.pkl", "wb") as f:
        pickle.dump({"mean": mels.mean(0), "std": mels.std(0)}, f)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(model, str(d / "model.ckpt"))
    return d, cfg


def argv(d, out, *extra):
    return ["-a", str(d / "attr.pkl"), "-c", str(d / "config.yaml"), "-m", str(d / "model.ckpt"),
            "-s", str(d / "source.wav"), "-t", str(d / "target.wav"), "-o", str(out), *extra]


@pytest.mark.parametrize("gl_method", ["exact", "fused"])
def test_cli_one_shot_conversion_on_cpu(assets, gl_method):
    d, cfg = assets
    out = d / f"out_{gl_method}.wav"
    main(argv(d, out, "--device", "cpu", "--gl_method", gl_method))
    sr, wav = wavfile.read(out)
    n_src = get_spectrograms(str(d / "source.wav"))[0].shape[0]
    n_dec = -(-n_src // 8) * 8  # the content code is ceil(T/8), upsampled x8
    assert sr == SR and wav.dtype == np.float32 and np.isfinite(wav).all()
    assert 0 < len(wav) <= cfg.signal.hop_length * (n_dec - 1)


def test_inferencer_matches_jax_inferencer(assets):
    """The same checkpoint through both packages' Inferencer: the converted
    mel to 1e-4, the wavs (exact vocoder) of equal length and close."""
    d, cfg = assets
    j = JInferencer.from_torch_checkpoint(cfg, str(d / "model.ckpt"), str(d / "attr.pkl"))
    t = Inferencer.from_torch_checkpoint(cfg, str(d / "model.ckpt"), str(d / "attr.pkl"), device="cpu")
    src = t.normalize(get_spectrograms(str(d / "source.wav"))[0])
    tar = t.normalize(get_spectrograms(str(d / "target.wav"))[0])
    wav_t, dec_t = t.inference_one_utterance(src, tar)
    wav_j, dec_j = j.inference_one_utterance(src, tar)
    np.testing.assert_allclose(dec_t, np.asarray(dec_j), atol=1e-4)
    assert wav_t.shape == wav_j.shape
    assert np.abs(wav_t - wav_j).max() <= 2e-2 * np.abs(wav_j).max()


def test_utt_make_frames_matches_jax():
    x = np.arange(20, dtype=np.float32).reshape(5, 4)
    for f in (1, 2, 3):
        np.testing.assert_array_equal(utt_make_frames(x, f), j_frames(x, f))


def test_device_rules():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdevice.resolve_device(None).type == "cuda"
    else:
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError):
                tdevice.resolve_device(dev)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        tdevice.set_precision("highest")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        tdevice.set_precision(None)  # leaves the switches as they are
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            tdevice.set_precision("bf16")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "adaptive_voice_conversion_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "adaptive_voice_conversion_tpu"}
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path.relative_to(REPO)} imports {mod}"
