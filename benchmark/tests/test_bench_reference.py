"""The plain reference against the port at the tiny size in fp32 on the
CPU, and its parameter lists against the port's modules at the published
size (on the meta device)."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import weights
from benchmark.loops import serving
from benchmark.reference import codec, dit, sampler
from benchmark.tests.conftest import REPO, tiny_config


@pytest.mark.parametrize("name", ["echo-base-bf16", "echo-base-w8a8"])
def test_specs_name_the_ports_tensors(name):
    from echo_tts_torch.models.dac.dac import S1DAC
    from echo_tts_torch.models.dit import EchoDiT
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    with torch.device("meta"):
        d = EchoDiT(serving.dit_config(cfg))
        c = S1DAC(serving.dac_config(cfg))
    own = {k: tuple(v.shape) for k, v in d.state_dict().items()}
    assert {n: s for n, s, _ in dit.specs(cfg["dit"])} == own
    own = {k: tuple(v.shape) for k, v in c.state_dict().items()}
    for n, s, _ in codec.specs(cfg["codec"]):
        assert own[n] == s, n
    assert sum(v.numel() for v in d.parameters()) == \
        cfg["parameters"]["dit"]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    models = serving.build_models(cfg, 11, torch.device("cpu"))
    W = weights.tensors(dit.specs(cfg["dit"]), weights.sub_seed(11, 1), "cpu",
                        torch.float32)
    return cfg, models, W


def test_sampler_matches_the_port(tiny):
    from echo_tts_torch.sampler.euler import \
        sample_euler_cfg_independent_guidances as port
    cfg, models, W = tiny
    g = torch.Generator().manual_seed(0)
    b, s = 3, 16
    ids = torch.randint(1, 255, (b, 768), generator=g)
    tmask = torch.arange(768)[None] < torch.tensor([[30], [50], [9]])
    spk = torch.randn(b, 16, 80, generator=g)
    smask = torch.arange(16)[None] < torch.tensor([[16], [8], [12]])
    noise = torch.randn(b, s, 80, generator=g)
    got = port(models.dit, spk, smask, ids, tmask, initial_noise=noise,
               dtype=torch.float32, sequence_length=s, **cfg["sampler"])
    ref = sampler.sample(W, cfg["dit"], cfg["sampler"], spk, smask, ids,
                         tmask, noise)
    assert ((got - ref).norm() / ref.norm()).item() < 1e-5


def test_decode_matches_the_port(tiny):
    from echo_tts_torch.pipeline.pipeline import ae_decode
    cfg, models, _ = tiny
    Wc = weights.tensors(codec.specs(cfg["codec"]), weights.sub_seed(11, 2),
                         "cpu", torch.float32)
    lat = torch.randn(2, 12, 80, generator=torch.Generator().manual_seed(1))
    got = ae_decode(models, lat)
    ref = codec.decode(Wc, cfg["codec"], models.pca, lat)
    assert got.shape == ref.shape
    assert ((got - ref).norm() / ref.norm()).item() < 1e-5


def test_weights_repeat_from_the_seed():
    specs = dit.specs(tiny_config()["dit"])
    a = weights.tensors(specs, 2 ** 40 + 3, "cpu", torch.bfloat16)
    b = weights.tensors(specs, 2 ** 40 + 3, "cpu", torch.bfloat16)
    c = weights.tensors(specs, 2 ** 40 + 4, "cpu", torch.bfloat16)
    name = "blocks.0.mlp.w1.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert a[name].dtype == torch.float32


@pytest.mark.parametrize("mode,top", [("int8", 127), ("int4", 7),
                                      ("fp8", None)])
def test_lowered_rounds_each_row_on_its_own_scale(mode, top):
    from benchmark import reference
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(3)) * \
        torch.tensor([[1.0], [10.0], [0.1], [3.0], [100.0]])
    assert reference.q(x, -1) is x
    with reference.lowered(mode):
        y = reference.q(x, -1)
    rel = ((y - x).norm(dim=1) / x.norm(dim=1))
    assert torch.all(rel > 0) and torch.all(rel < (0.3 if top == 7 else 0.05))
    if top is not None:
        steps = y / (x.abs().amax(1, keepdim=True) / top)
        assert torch.allclose(steps, steps.round(), atol=1e-4)
    assert torch.allclose(rel, rel.mean(), rtol=0.5)


def test_lowered_hot_names_only_the_dit_blocks_hot_linears():
    from benchmark import reference
    hot = ["blocks.0.attention.wq", "blocks.23.mlp.w2",
           "blocks.5.attention.gate"]
    cold = ["text_encoder.blocks.0.attention.wq", "blocks.0.attention.wk_text",
            "blocks.1.attention_adaln.scale_up", "in_proj",
            "speaker_encoder.blocks.3.mlp.w1"]
    assert all(reference.HOT.match(n) for n in hot)
    assert not any(reference.HOT.match(n) for n in cold)
    x = torch.linspace(-1, 1, 33)[None]
    with reference.lowered("fp8", hot="int4"):
        assert torch.equal(reference.q(x, -1, hot[0]),
                           (x / (1 / 7)).round().clamp(-7, 7) * (1 / 7))
        assert not torch.equal(reference.q(x, -1, cold[0]),
                               reference.q(x, -1, hot[0]))
