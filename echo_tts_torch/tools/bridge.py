"""Weight bridge: the JAX package's parameter trees -> the port's state.

`dit_state_from_jax` and `dac_state_from_jax` take the JAX parameter trees
(nested dicts of numpy arrays, or of anything numpy can read) and return
the published checkpoints' flat state dicts {key: np.ndarray}, with the
keys of echo_tts_tpu/tools/convert.py:37-138 and convert_dac.py:27-130.
They are the inverses of `convert_dit_state` and `convert_dac_state`, and
the port's modules load them as they are (`load_dit_state`,
`load_dac_state`), as they will load the published safetensors.

DAC weight norm: the bridge emits `original0 = ||W||` (norm over every
axis but the first) and `original1 = W`, so the folded weight
g * v / ||v|| is W again.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import DACConfig, EchoDiTConfig
from ..device import resolve_device
from ..models.dac.dac import S1DAC
from ..models.dit import EchoDiT

State = Dict[str, np.ndarray]


def _np(a) -> np.ndarray:
    return np.asarray(a)


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(_np(a).T)


# ---------------------------------------------------------------------------
# EchoDiT (inverse of tools/convert.py:convert_dit_state)
# ---------------------------------------------------------------------------

def _enc_blocks(out: State, prefix: str, blocks: Mapping, n: int) -> None:
    for i in range(n):
        b = f"{prefix}.blocks.{i}"
        for name in ("wq", "wk", "wv", "wo", "gate"):
            out[f"{b}.attention.{name}.weight"] = _t(blocks["attn"][name][i])
        for name in ("q_norm", "k_norm"):
            out[f"{b}.attention.{name}.weight"] = _np(blocks["attn"][name][i])
        for name in ("w1", "w2", "w3"):
            out[f"{b}.mlp.{name}.weight"] = _t(blocks["mlp"][name][i])
        out[f"{b}.attention_norm.weight"] = _np(blocks["attn_norm"][i])
        out[f"{b}.mlp_norm.weight"] = _np(blocks["mlp_norm"][i])


def dit_state_from_jax(params: Mapping, cfg: EchoDiTConfig) -> State:
    out: State = {}
    n = cfg.num_layers
    blk = params["blocks"]
    attn_names = ["wq", "wk", "wv", "wo", "gate", "wk_text", "wv_text",
                  "wk_speaker", "wv_speaker"]
    if cfg.blockwise:
        attn_names += ["wk_latent", "wv_latent"]
    for i in range(n):
        b = f"blocks.{i}"
        for name in attn_names:
            out[f"{b}.attention.{name}.weight"] = _t(blk["attn"][name][i])
        for name in ("q_norm", "k_norm"):
            out[f"{b}.attention.{name}.weight"] = _np(blk["attn"][name][i])
        for name in ("w1", "w2", "w3"):
            out[f"{b}.mlp.{name}.weight"] = _t(blk["mlp"][name][i])
        for which, key in (("attention_adaln", "attn_adaln"),
                           ("mlp_adaln", "mlp_adaln")):
            p = blk[key]
            for name in ("shift", "scale", "gate"):
                out[f"{b}.{which}.{name}_down.weight"] = _t(p[f"{name}_down"][i])
                out[f"{b}.{which}.{name}_up.weight"] = _t(p[f"{name}_up"]["kernel"][i])
                out[f"{b}.{which}.{name}_up.bias"] = _np(p[f"{name}_up"]["bias"][i])

    te = params["text_encoder"]
    out["text_encoder.text_embedding.weight"] = _np(te["embedding"])
    _enc_blocks(out, "text_encoder", te["blocks"], cfg.text_num_layers)
    encoders = ["speaker_encoder"] + (["latent_encoder"] if cfg.blockwise else [])
    for enc in encoders:
        p = params[enc]
        out[f"{enc}.in_proj.weight"] = _t(p["in_proj"]["kernel"])
        out[f"{enc}.in_proj.bias"] = _np(p["in_proj"]["bias"])
        _enc_blocks(out, enc, p["blocks"], cfg.speaker_num_layers)
    for name in ("text_norm", "speaker_norm", "out_norm") + (
            ("latent_norm",) if cfg.blockwise else ()):
        out[f"{name}.weight"] = _np(params[name])
    for idx, key in ((0, "w0"), (2, "w1"), (4, "w2")):
        out[f"cond_module.{idx}.weight"] = _t(params["cond"][key])
    for name in ("in_proj", "out_proj"):
        out[f"{name}.weight"] = _t(params[name]["kernel"])
        out[f"{name}.bias"] = _np(params[name]["bias"])
    return out


# ---------------------------------------------------------------------------
# S1-DAC (inverse of tools/convert_dac.py:convert_dac_state)
# ---------------------------------------------------------------------------

def _wn_pair(out: State, name: str, w_torch: np.ndarray) -> None:
    w = np.asarray(w_torch, dtype=np.float32)
    axes = tuple(range(1, w.ndim))
    out[f"{name}.parametrizations.weight.original0"] = np.sqrt(
        np.sum(w * w, axis=axes, keepdims=True))
    out[f"{name}.parametrizations.weight.original1"] = np.ascontiguousarray(w)


def _conv(out: State, name: str, p: Mapping, weight_norm: bool = True) -> None:
    """JAX kernel (K, ., .) -> torch layout by the (2, 1, 0) transpose."""
    w = np.ascontiguousarray(np.transpose(_np(p["kernel"]), (2, 1, 0)))
    if weight_norm:
        _wn_pair(out, name, w)
    else:
        out[f"{name}.weight"] = w
    if p.get("bias") is not None:
        out[f"{name}.bias"] = _np(p["bias"])


def _alpha(a) -> np.ndarray:
    return _np(a).reshape(1, -1, 1)


def _residual_unit(out: State, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.block.0.alpha"] = _alpha(p["snake1"])
    _conv(out, f"{prefix}.block.1.conv", p["conv1"])
    out[f"{prefix}.block.2.alpha"] = _alpha(p["snake2"])
    _conv(out, f"{prefix}.block.3.conv", p["conv2"])


def _transformer(out: State, prefix: str, p: Mapping) -> None:
    b = p["blocks"]
    for i in range(_np(b["wqkv"]).shape[0]):
        lp = f"{prefix}.layers.{i}"
        out[f"{lp}.attention.wqkv.weight"] = _t(b["wqkv"][i])
        out[f"{lp}.attention.wo.weight"] = _t(b["wo"][i])
        for name in ("w1", "w3", "w2"):
            out[f"{lp}.feed_forward.{name}.weight"] = _t(b[name][i])
        out[f"{lp}.attention_norm.weight"] = _np(b["attn_norm"][i])
        out[f"{lp}.ffn_norm.weight"] = _np(b["ffn_norm"][i])
        out[f"{lp}.attention_layer_scale.gamma"] = _np(b["attn_ls"][i])
        out[f"{lp}.ffn_layer_scale.gamma"] = _np(b["ffn_ls"][i])
    out[f"{prefix}.norm.weight"] = _np(p["norm"])


def _convnext(out: State, prefix: str, p: Mapping) -> None:
    _conv(out, f"{prefix}.dwconv.conv", p["dwconv"], weight_norm=False)
    out[f"{prefix}.norm.weight"] = _np(p["norm"]["weight"])
    out[f"{prefix}.norm.bias"] = _np(p["norm"]["bias"])
    for name in ("pwconv1", "pwconv2"):
        out[f"{prefix}.{name}.weight"] = _t(p[name]["kernel"])
        out[f"{prefix}.{name}.bias"] = _np(p[name]["bias"])
    out[f"{prefix}.gamma"] = _np(p["gamma"])


def _vq_stack(out: State, prefix: str, p: Mapping) -> None:
    for i in range(_np(p["codebook"]).shape[0]):
        q = f"{prefix}.quantizers.{i}"
        # (D, Dc) kernel -> (Dc, D, 1) conv weight, and back for out_proj
        _wn_pair(out, f"{q}.in_proj", _t(p["in_proj"]["kernel"][i])[:, :, None])
        out[f"{q}.in_proj.bias"] = _np(p["in_proj"]["bias"][i])
        _wn_pair(out, f"{q}.out_proj", _t(p["out_proj"]["kernel"][i])[:, :, None])
        out[f"{q}.out_proj.bias"] = _np(p["out_proj"]["bias"][i])
        out[f"{q}.codebook.weight"] = _np(p["codebook"][i])


def dac_state_from_jax(params: Mapping, cfg: DACConfig) -> State:
    out: State = {}
    enc = params["encoder"]
    _conv(out, "encoder.block.0.conv", enc["conv_in"])
    for bi, blk in enumerate(enc["blocks"]):
        base = f"encoder.block.{bi + 1}.block"
        for ri in range(3):
            _residual_unit(out, f"{base}.{ri}", blk["res_units"][ri])
        out[f"{base}.3.alpha"] = _alpha(blk["snake"])
        _conv(out, f"{base}.4.conv", blk["down"])
        if "transformer" in blk:
            _transformer(out, f"{base}.5", blk["transformer"])
    n_enc = len(cfg.encoder_rates)
    out[f"encoder.block.{n_enc + 1}.alpha"] = _alpha(enc["snake_out"])
    _conv(out, f"encoder.block.{n_enc + 2}.conv", enc["conv_out"])

    dec = params["decoder"]
    _conv(out, "decoder.model.0.conv", dec["conv_in"])
    for bi, blk in enumerate(dec["blocks"]):
        base = f"decoder.model.{bi + 1}.block"
        out[f"{base}.0.alpha"] = _alpha(blk["snake"])
        _conv(out, f"{base}.1.conv", blk["up"])
        for ri in range(3):
            _residual_unit(out, f"{base}.{ri + 2}", blk["res_units"][ri])
    n_dec = len(cfg.decoder_rates)
    out[f"decoder.model.{n_dec + 1}.alpha"] = _alpha(dec["snake_out"])
    _conv(out, f"decoder.model.{n_dec + 2}.conv", dec["conv_out"])

    q = params["quantizer"]
    for i, p in enumerate(q["downsample"]):
        _conv(out, f"quantizer.downsample.{i}.0.conv", p["conv"], weight_norm=False)
        _convnext(out, f"quantizer.downsample.{i}.1", p["convnext"])
    for i, p in enumerate(q["upsample"]):
        _conv(out, f"quantizer.upsample.{i}.0.conv", p["convt"], weight_norm=False)
        _convnext(out, f"quantizer.upsample.{i}.1", p["convnext"])
    _transformer(out, "quantizer.pre_module", q["pre"])
    _transformer(out, "quantizer.post_module", q["post"])
    _vq_stack(out, "quantizer.semantic_quantizer", q["semantic"])
    _vq_stack(out, "quantizer.quantizer", q["residual"])
    return out


def pca_state(pca: Mapping, *, device="cuda") -> dict:
    """The PCA state {components, mean, latent_scale} on `device` from the
    JAX package's pca dict (or any mapping of arrays with those keys)."""
    device = resolve_device(device)
    return {"components": torch.tensor(_np(pca["components"]),
                                          dtype=torch.float32, device=device),
            "mean": torch.tensor(_np(pca["mean"]), dtype=torch.float32,
                                    device=device),
            "latent_scale": float(np.asarray(pca["latent_scale"]).reshape(-1)[0])}


# ---------------------------------------------------------------------------
# Loading a state into the port's modules
# ---------------------------------------------------------------------------

def _load(module: torch.nn.Module, state: Mapping, device,
          dtype) -> torch.nn.Module:
    """Load numpy arrays or tensors (a safetensors file's bf16 comes as a
    tensor) into `module`, cast to its dtype on `device`."""
    module = module.to(dtype).to_empty(device=device)
    module.load_state_dict(
        {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
         for k, v in state.items()}, strict=True)
    return module.eval().requires_grad_(False)


def load_dit_state(state: Mapping, cfg: EchoDiTConfig, *,
                   device="cuda", dtype=torch.bfloat16) -> EchoDiT:
    """An EchoDiT holding `state` (checkpoint keys), on `device`."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = EchoDiT(cfg)
    return _load(model, state, device, dtype)


def load_dac_state(state: Mapping, cfg: DACConfig, *,
                   device="cuda", dtype=torch.float32) -> S1DAC:
    """An S1DAC holding `state` (checkpoint keys), on `device`."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = S1DAC(cfg)
    return _load(model, state, device, dtype)
