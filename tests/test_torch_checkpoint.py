"""The port's checkpoint bundle (echo_tts_torch/tools/checkpoint.py), its
branch in serve/models.load_models, the few-step recipe end to end
(train/recipe.py, the JAX package's tests/test_few_step_e2e.py in short)
and tools/hub.load_models_from_hf with the download mocked.

The bundle round-trips bit for bit (bf16, and W8A8 with its int8 weights
and fp32 scales); the recipe's student is served through the port's
handler, in its own dtype and under ECHO_DIT_QUANT=int8.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.ops import quant as tq
from echo_tts_torch.pipeline.pipeline import EchoModels, random_models
from echo_tts_torch.serve import models as serve_models
from echo_tts_torch.tools import bridge, checkpoint, hub
from echo_tts_torch.train.data import DataConfig
from echo_tts_torch.train.recipe import distill_few_step, serve_checkpoint_smoke

torch.set_num_threads(1)


def _tiny(dtype, seed=0):
    return random_models("cpu", dtype, seed, dit_cfg=tiny_dit_config(),
                         dac_cfg=tiny_dac_config())


def _assert_same(a: EchoModels, b: EchoModels):
    assert a.dit_cfg == b.dit_cfg and a.dac_cfg == b.dac_cfg
    assert a.dtype == b.dtype
    for m, n in ((a.dit, b.dit), (a.dac, b.dac)):
        sa, sb = m.state_dict(), n.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    for k in ("components", "mean"):
        assert torch.equal(a.pca[k], b.pca[k])
    assert a.pca["latent_scale"] == b.pca["latent_scale"]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_bundle_round_trip(tmp_path, quant):
    """save_checkpoint then load_checkpoint gives the same bundle bit for
    bit: bf16 DiT, fp32 codec, PCA, configs; the W8A8 DiT keeps its int8
    weights and fp32 scales.  config.json carries the JAX package's keys
    and dit_quant; the bundle loads through serve.models.load_models with
    its own configs."""
    models = _tiny(torch.bfloat16)
    models = dataclasses.replace(models, dac=models.dac.float())
    if quant == "int8":
        models = dataclasses.replace(models, dit=tq.quantize_dit(models.dit))
    path = str(tmp_path / "bundle")
    checkpoint.save_checkpoint(path, models)
    assert checkpoint.is_bundle(path)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"dit_cfg", "dac_cfg", "dtype", "dit_quant"}
    assert meta["dtype"] == "bfloat16" and meta["dit_quant"] == quant
    back = checkpoint.load_checkpoint(path, device="cpu")
    _assert_same(models, back)
    assert tq.dit_is_quantized(back.dit) == (quant == "int8")

    serve_models.clear_models()
    try:
        served = serve_models.load_models(path, device="cpu",
                                          dtype=torch.bfloat16)
        _assert_same(models, served)
        assert serve_models.served_quant_mode() == quant
    finally:
        serve_models.clear_models()


def test_load_checkpoint_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    checkpoint.save_checkpoint(str(tmp_path), _tiny(torch.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.load_checkpoint(str(tmp_path))


@pytest.fixture(scope="module")
def recipe(tiny_models, tmp_path_factory):
    """The recipe at tiny scale on the JAX package's tiny weights, in
    fp32: 16 synthetic utterances, 24 quant-aware steps, evaluation every
    8, the student served through the handler."""
    models = EchoModels(
        dit=bridge.load_dit_state(bridge.dit_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dit_params),
            tiny_dit_config()), tiny_dit_config(), device="cpu",
            dtype=torch.float32),
        dac=bridge.load_dac_state(bridge.dac_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dac_params),
            tiny_dac_config()), tiny_dac_config(), device="cpu",
            dtype=torch.float32),
        pca=bridge.pca_state(jax.tree.map(np.asarray, tiny_models.pca),
                             device="cpu"),
        dtype=torch.float32)
    rng = np.random.default_rng(0)
    spl = models.dac_cfg.frame_length
    texts = ["The quick brown fox jumps.", "Over the lazy dog again.",
             "A synthetic training utterance.", "Speech latents from noise.",
             "Every stage must compose.", "Distilled students serve fast.",
             "Guidance folds into weights.", "Few steps, same trajectory."]
    data = [((rng.standard_normal((1, int(rng.integers(24, 40)) * spl))
              * 0.1).astype(np.float32), texts[i % len(texts)])
            for i in range(16)]
    before = {k: v.clone() for k, v in models.dit.state_dict().items()}
    out = tmp_path_factory.mktemp("few_step")
    report = distill_few_step(
        models, data, str(out), num_steps=24, num_student_steps=4,
        substeps=2, batch_size=4,
        data_cfg=DataConfig(sequence_length=16, text_length=16,
                            speaker_length=8, min_latents=8),
        eval_texts=("Held out evaluation prompt.", "Second held out prompt."),
        eval_every=8, teacher_sampler_params={"num_steps": 8},
        quant_aware=True, lr=1e-3, ema_decay=None, serve_smoke=True, seed=0)
    return models, before, report, str(out)


def test_recipe_closes_the_gap_and_serves(recipe):
    models, before, report, out = recipe
    assert np.isfinite(report["loss_last"])
    assert report["loss_last"] < report["loss_first"]
    assert report["eval_mse_final"] < report["eval_mse_initial"], report[
        "eval_mse_curve"]
    assert report["improved"]
    assert [s for s, _ in report["eval_mse_curve"]] == [0, 8, 16, 24]
    with open(os.path.join(out, "distill_report.json")) as f:
        assert json.load(f)["eval_mse_final"] == report["eval_mse_final"]
    smoke = report["serve_smoke"]
    assert smoke["ok"] and smoke["quant_reported"] == "none"
    assert smoke["audio_peak"] > 0 and smoke["duration_seconds"] > 0
    # the teacher was not trained; the student bundle is not the teacher
    for k, v in models.dit.state_dict().items():
        assert torch.equal(before[k], v), k
    student = checkpoint.load_checkpoint(report["checkpoint"], device="cpu")
    assert not torch.equal(student.dit.blocks[0].mlp.w1.weight,
                           models.dit.blocks[0].mlp.w1.weight)


def test_recipe_student_serves_int8(recipe):
    """The quant-aware student through the handler under
    ECHO_DIT_QUANT=int8 (the W8A8 DiT), its serving cache set aside and
    restored."""
    _, _, report, _ = recipe
    serve_models.clear_models()
    smoke = serve_checkpoint_smoke(report["checkpoint"], num_student_steps=4,
                                   sequence_length=16, device="cpu",
                                   dtype=torch.float32, int8=True)
    assert smoke["ok"] and smoke["int8"]
    assert smoke["quant_reported"] == "int8" and smoke["audio_peak"] > 0
    assert not serve_models.models_loaded()
    assert os.environ.get("ECHO_DIT_QUANT") in (None, "none")


def test_hub_loader_with_mocked_downloads(tmp_path, monkeypatch):
    """load_models_from_hf drilled offline: the download returns tiny
    published-format safetensors written here; the bundle holds them bit
    for bit, and blockwise=False leaves out exactly the latent encoder."""
    from safetensors.torch import save_file

    src = _tiny(torch.float32, seed=3)
    files = {}
    for (repo, name), state in (
            ((hub.DIT_REPO, hub.DIT_FILE), src.dit.state_dict()),
            ((hub.DAC_REPO, hub.DAC_FILE), src.dac.state_dict()),
            ((hub.DIT_REPO, hub.PCA_FILE), {
                "pca_components": src.pca["components"],
                "pca_mean": src.pca["mean"],
                "latent_scale": torch.tensor(src.pca["latent_scale"])})):
        path = str(tmp_path / f"{repo.replace('/', '_')}_{name}")
        save_file({k: v.contiguous() for k, v in state.items()}, path)
        files[(repo, name)] = path
    asked = []

    def download(repo, filename, token):
        asked.append((repo, filename, token))
        return files[(repo, filename)]

    monkeypatch.setattr(hub, "_download", download)
    monkeypatch.setattr(hub, "base_dit_config",
                        lambda blockwise=True: tiny_dit_config(blockwise))
    from echo_tts_torch.pipeline import pipeline
    monkeypatch.setattr(pipeline, "base_dac_config", tiny_dac_config)
    got = hub.load_models_from_hf(token="t", device="cpu",
                                  dtype=torch.float32)
    assert {a[2] for a in asked} == {"t"} and len(asked) == 3
    assert got.dit_cfg == tiny_dit_config()
    for k, v in src.dit.state_dict().items():
        assert torch.equal(got.dit.state_dict()[k], v), k
    for k, v in src.dac.state_dict().items():
        assert torch.equal(got.dac.state_dict()[k], v), k
    assert got.pca["latent_scale"] == pytest.approx(src.pca["latent_scale"])

    slim = hub.load_models_from_hf(device="cpu", dtype=torch.float32,
                                   blockwise=False)
    keys = set(slim.dit.state_dict())
    assert keys == {k for k in src.dit.state_dict()
                    if "latent" not in k}
    if not torch.cuda.is_available():
        asked.clear()
        with pytest.raises(RuntimeError, match="cuda"):
            hub.load_models_from_hf()
        assert not asked                      # refused before any download
