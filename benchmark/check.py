"""Whether what the timed path served is correct.

A sample of the window's finished requests, drawn from the seed, is held
against the plain float32 reference (benchmark/reference/), which gets the
same seeded weights, texts, voice latents and noise and works everything
else out itself:

  latent_rel_rms  the sampler's latents (prefill, every Euler step with its
                  guidance, through kernel A and, under W8A8, kernel C)
                  against the reference's sampler from the same noise:
                  ||served - reference|| / ||reference||, the worst request
  audio_rel_rms   the served audio (PCA unwhiten, the codec's decode through
                  kernel B, the end-of-speech crop) against the reference
                  codec's decode of the served latents, over the served
                  length: the worst request

Every number in the cell's limits file (benchmark/limits/<cell>.json) is
compared with its limit; the others are printed as readings.

The control (`run.py --control`) is the reference put in the program's
place with its products one precision down, as the limits file's
"control" names it (reference.lowered: "rest" for every product, "hot"
for the DiT's hot linears): its latents against the float32 reference's,
and its lowered decode of them against the float32 decode.  A control run
also prints the program's own numbers, and those of the reference codec
in int8 in the program's codec's place, as readings.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np


def rel_rms(a: np.ndarray, ref: np.ndarray) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def _worst(latents, ref_latents, audio, ref_audio) -> Dict[str, float]:
    lat = [rel_rms(a, r) for a, r in zip(latents, ref_latents)]
    aud = [rel_rms(a, r[:len(a)]) for a, r in zip(audio, ref_audio) if len(a)]
    return {"latent_rel_rms": max(lat), "audio_rel_rms": max(aud),
            "latent_rel_rms_median": float(np.median(lat)),
            "audio_rel_rms_median": float(np.median(aud))}


def readings(cell, voices, sample: List[dict], seed: int, device,
             control: bool = False) -> Dict[str, Dict[str, float]]:
    """{"served": numbers of the program's outputs, and with `control`
    "control": the control's}."""
    import torch
    from . import weights
    from .reference import codec, dit, fp32, lowered, sampler, text
    config = cell.config
    dtype = getattr(torch, config["dtype"])
    seq = cell.traffic_params["sequence_length"]
    reqs = [s["request"] for s in sample]
    low = cell.limits.get("control", {})
    out = {}
    with fp32():
        ids, tmask = text.text_ids([r.text for r in reqs], 768)
        spk = torch.from_numpy(np.concatenate(
            [voices[r.voice][0] for r in reqs])).to(device)
        smask = torch.from_numpy(np.concatenate(
            [voices[r.voice][1] for r in reqs])).to(device)
        noise = torch.cat([torch.randn(
            (1, seq, config["dit"]["latent_size"]), dtype=torch.float32,
            device=device,
            generator=torch.Generator(device=device).manual_seed(r.seed))
            for r in reqs])
        W = weights.tensors(dit.specs(config["dit"]),
                            weights.sub_seed(seed, 1), device, dtype)
        args = (W, config["dit"], config["sampler"], spk, smask,
                torch.from_numpy(ids).to(device),
                torch.from_numpy(tmask).to(device), noise)
        ref = sampler.sample(*args, t_dtype=dtype).cpu().numpy()
        if control:
            with lowered(low["rest"], low.get("hot")):
                ctl = sampler.sample(*args, t_dtype=dtype).cpu().numpy()
        del W, args
        Wc = weights.tensors(codec.specs(config["codec"]),
                             weights.sub_seed(seed, 2), device, dtype)
        pca = weights.pca(config["dit"]["latent_size"],
                          config["codec"]["latent_dim"],
                          weights.sub_seed(seed, 3), device)

        def decode(latents):
            return codec.decode(Wc, config["codec"], pca, torch.from_numpy(
                np.stack(latents)).to(device)).cpu().numpy()

        served = [s["latents"] for s in sample]
        served_ref = decode(served)
        out["served"] = _worst(served, ref, [s["audio"] for s in sample],
                               served_ref)
        if control:
            ctl = list(ctl)
            with lowered(low["rest"], low.get("hot")):
                ctl_audio = decode(ctl)
            out["control"] = _worst(ctl, ref, ctl_audio, decode(ctl))
            with lowered("int8"):
                int8 = decode(served)
            out["int8_codec"] = _worst(served, ref, [
                a[:len(s["audio"])] for s, a in zip(sample, int8)], served_ref)
        del Wc
    return out


def compare(cell, voices, sample: List[dict], seed: int, device,
            control: bool = False) -> Dict[str, dict]:
    """{number: {"value", "limit"}} of the served requests, or with
    `control` of the control; every other number printed as a reading."""
    if not sample:
        return {"checked_requests": {"value": 0.0, "limit": -1.0}}
    got = readings(cell, voices, sample, seed, device, control)
    judged = got["control" if control else "served"]
    limits = cell.limits["limits"]
    print(f"reading checked_requests {len(sample)}", file=sys.stderr)
    for side, numbers in got.items():
        for name, value in numbers.items():
            if side != ("control" if control else "served") \
                    or name not in limits:
                print(f"reading {side} {name} {value:.6g}", file=sys.stderr,
                      flush=True)
    return {name: {"value": judged[name], "limit": float(limit)}
            for name, limit in limits.items()}
