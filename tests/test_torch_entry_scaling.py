"""The port's entry points (entry.py) and its weak-scaling sweep
(parallel/scaling.py) on the CPU, ranks over gloo.

- ``entry(device="cpu")``: the full model's forward on (8, 128, 512), held
  against the JAX package's encoders and decoder (``ae_forward``'s parts)
  on the same weights and the port's own ``eps``: rtol 1e-4 atol 1e-4;
- ``dryrun_multichip(4, device="cpu", backend="gloo")`` runs whole, on a
  (dp=2, tp=2) mesh, and its line reports finite losses; with the default
  device it refuses a host without 4 GPUs unless gloo is asked for;
- ``scaling_sweep`` at widths 1 and 2: one row each, ``validation_only``,
  the global batch scaled with the width; the CLI writes the artefact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_voice_conversion_tpu.core.config import TrainConfig as JTrainConfig
from adaptive_voice_conversion_tpu.models.modules import (
    content_encoder_apply,
    decoder_apply,
    speaker_encoder_apply,
)
from adaptive_voice_conversion_tpu_torch.core import config as tcfg
from adaptive_voice_conversion_tpu_torch.entry import dryrun_multichip, entry
from adaptive_voice_conversion_tpu_torch.models.weights import jax_params_from_state_dict
from adaptive_voice_conversion_tpu_torch.parallel import scaling_sweep
from adaptive_voice_conversion_tpu_torch.parallel.scaling import main as scaling_main

from test_torch_train import tiny


def test_entry_forward_matches_jax():
    fn, (model, x, gen) = entry(device="cpu")
    dec = fn(model, x, gen).detach()
    assert dec.shape == (8, 128, 512) and dec.dtype == torch.float32
    # the VAE's draw is the generator's first, at the content code's (B, C, T)
    eps = torch.randn((8, 128, 16), generator=torch.Generator().manual_seed(1)).transpose(1, 2)
    with torch.no_grad():
        torch.testing.assert_close(model(x, eps=eps)[3], dec, rtol=0, atol=0)
    jc = JTrainConfig().model
    params = jax_params_from_state_dict(model.state_dict(), tcfg.TrainConfig().model)
    xj = jnp.asarray(x.numpy())
    emb = speaker_encoder_apply(params["speaker_encoder"], jc.speaker_encoder, xj)
    mu, log_sigma = content_encoder_apply(params["content_encoder"], jc.content_encoder, xj)
    z = mu + jnp.exp(log_sigma / 2) * jnp.asarray(eps.numpy())
    want = np.asarray(decoder_apply(params["decoder"], jc.decoder, z, emb))
    np.testing.assert_allclose(dec.numpy(), want, rtol=1e-4, atol=1e-4)


def test_dryrun_multichip_on_four_gloo_ranks(capsys):
    out = dryrun_multichip(4, device="cpu", backend="gloo")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh=(dp=2,tp=2) tiny loss=")
    assert "full-config executed" in line and "(dp4)" in line
    assert out["mesh"] == (2, 2)
    for m in (out["tiny"], out["full"]):
        assert all(np.isfinite(v) for v in m.values()), m
    assert out["multi"].shape == (2, 4) and np.isfinite(out["multi"]).all()


def test_dryrun_multichip_needs_gpus_or_gloo():
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs 4 GPUs; this host has {have}"):
        dryrun_multichip(4)


def test_scaling_sweep_validates_on_cpu():
    cfg = tiny(tcfg)
    rows = scaling_sweep(cfg, [1, 2], n_frames=2000, chunks=1, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["global_batch"] for r in rows] == [4, 8]
    for r in rows:
        assert r["validation_only"] is True and "efficiency_vs_linear" not in r
        assert r["audio_s_per_s"] > 0


def test_scaling_cli_writes_the_artefact(tmp_path, capsys):
    path = tmp_path / "scaling.json"
    scaling_main(["--tiny", "--sizes", "1", "--device", "cpu", "--out", str(path)])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    art = json.loads(path.read_text())
    assert set(art) == {"backend", "n_devices", "virtual_devices", "tiny_config", "note", "rows"}
    assert art["backend"] == "gloo" and art["virtual_devices"] and art["tiny_config"]
    assert art["rows"] == printed and [r["global_batch"] for r in printed] == [16]
