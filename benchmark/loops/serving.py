"""What the serving loops share: the seeded models and voices, the
micro-batching server and its warm-up, the benchmark's spans around each
server pass, and the correctness check of a sample of the served requests.

A serving loop (serve_open.py, serve_closed.py) subclasses ServingLoop
with its `drive` and `end_to_end`.  The system under test is
echo_tts_torch's MicroBatchServer over run_batch, the captured sampler
and codec programs and kernels A, B and C; the benchmark makes the
weights, the voices' latents, the texts and the request seeds.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import time
from typing import Dict, List, Optional

import numpy as np

from .. import check, weights


# ---------------------------------------------------------------------------
# Models and voices
# ---------------------------------------------------------------------------

def dit_config(config: dict):
    from echo_tts_torch.config import EchoDiTConfig
    return EchoDiTConfig(**config["dit"])


def dac_config(config: dict):
    from echo_tts_torch.config import DACConfig
    c = dict(config["codec"])
    for k in ("encoder_rates", "decoder_rates", "encoder_transformer_layers",
              "downsample_factor"):
        c[k] = tuple(c[k])
    return DACConfig(**c)


def build_models(config: dict, seed: int, device):
    """The program's EchoModels with the seed's weights; a configuration
    whose dit_quant is "int8" gets the DiT's hot linears quantized as
    serve/models.load_models does."""
    import torch
    from echo_tts_torch.models.dac.dac import S1DAC
    from echo_tts_torch.models.dit import EchoDiT
    from echo_tts_torch.ops import quant as q
    from echo_tts_torch.pipeline.pipeline import EchoModels
    from ..reference import codec as rcodec
    from ..reference import dit as rdit

    dtype = getattr(torch, config["dtype"])
    with torch.device("meta"):
        dit = EchoDiT(dit_config(config))
        dac = S1DAC(dac_config(config))
    dit = dit.to(dtype).to_empty(device=device)
    dac = dac.to(dtype).to_empty(device=device)
    weights.fill_(dit, rdit.specs(config["dit"]), weights.sub_seed(seed, 1),
                  dtype)
    weights.fill_(dac, rcodec.specs(config["codec"]),
                  weights.sub_seed(seed, 2), dtype)
    dit = dit.eval().requires_grad_(False)
    dac = dac.eval().requires_grad_(False)
    if config["dit_quant"] == "int8":
        dit = q.quantize_dit(dit)
    elif config["dit_quant"] != "none":
        raise ValueError(f"dit_quant {config['dit_quant']!r}")
    pca = weights.pca(config["dit"]["latent_size"],
                      config["codec"]["latent_dim"],
                      weights.sub_seed(seed, 3), device)
    return EchoModels(dit=dit, dac=dac, pca=pca, dtype=dtype)


def voice_latents(config: dict, traffic, seed: int, device):
    """Each voice's cached latent (1, bucket, 80) fp32 and mask (1, bucket),
    as the server's voice cache holds them: N(0, 1) over its length."""
    import torch
    bucket = traffic.params["speaker_bucket"]
    gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, 4))
    lat = torch.randn((len(traffic.voice_lengths), bucket,
                       config["dit"]["latent_size"]), generator=gen,
                      device=device, dtype=torch.float32)
    lengths = torch.tensor(traffic.voice_lengths, device=device)
    mask = torch.arange(bucket, device=device)[None] < lengths[:, None]
    lat = (lat * mask[..., None]).cpu().numpy()
    mask = mask.cpu().numpy()
    return [(lat[i:i + 1], mask[i:i + 1]) for i in range(len(lengths))]


# ---------------------------------------------------------------------------
# Spans around the server's pass, its sampler call and its decodes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pass:
    start: float
    end: float
    request_ids: List[str]      # the pass's rows, padding included
    seq: int
    text_mask: object = None    # (rows, text columns launched), as passed
    speaker_mask: object = None  # (rows, speaker latents launched)
    decode_batches: List[int] = dataclasses.field(default_factory=list)
    latents: object = None      # the sampler's output (rows, seq, 80)

    @property
    def rows(self) -> int:
        return len(self.request_ids)

    @property
    def text_width(self) -> int:
        return int(self.text_mask.shape[1])

    @property
    def speaker_width(self) -> int:
        return int(self.speaker_mask.shape[1])

    @property
    def text_lengths(self) -> List[int]:
        return [int(n) for n in self.text_mask.sum(1).tolist()]

    @property
    def speaker_lengths(self) -> List[int]:
        return [int(n) for n in self.speaker_mask.sum(1).tolist()]

    def real_rows(self) -> List[int]:
        """The row of each request in the pass, padding left out."""
        seen: Dict[str, int] = {}
        for i, rid in enumerate(self.request_ids):
            seen.setdefault(rid, i)
        return sorted(seen.values())


class Recorder:
    """Wraps serve.server.run_batch, serve.batcher's sampler entry and its
    decode in spans of the benchmark's own: each pass's times, rows, the
    text and speaker lengths as launched and as real, the decode batches
    and the latents."""

    def __init__(self):
        self.passes: List[Pass] = []
        self.recording = False
        self._open: Optional[Pass] = None

    def install(self):
        import torch
        from echo_tts_torch.serve import batcher, server
        run_batch = server.run_batch
        sample = batcher.sample_euler_cfg_independent_guidances
        decode = batcher.ae_decode
        rec = self

        def sample_spanned(dit, spk, spk_mask, text_ids, text_mask, *a, **k):
            out = sample(dit, spk, spk_mask, text_ids, text_mask, *a, **k)
            p = rec._open
            if p is not None:   # read after the window: no sync in it
                p.text_mask, p.speaker_mask, p.latents = (text_mask,
                                                          spk_mask, out)
            return out

        def decode_spanned(models, latents):
            if rec._open is not None:
                rec._open.decode_batches.append(int(latents.shape[0]))
            return decode(models, latents)

        def run_batch_spanned(models, requests, params=None, **kwargs):
            p = Pass(0.0, 0.0, [r.request_id for r in requests],
                     dict(params or {}).get("sequence_length", 0))
            rec._open = p
            t0 = time.monotonic()
            try:
                with torch.profiler.record_function("bench.pass"):
                    out = run_batch(models, requests, params, **kwargs)
            finally:
                rec._open = None
            p.start, p.end = t0, time.monotonic()
            if rec.recording:
                rec.passes.append(p)
            return out

        server.run_batch = run_batch_spanned
        batcher.sample_euler_cfg_independent_guidances = sample_spanned
        batcher.ae_decode = decode_spanned

        def restore():
            server.run_batch = run_batch
            batcher.sample_euler_cfg_independent_guidances = sample
            batcher.ae_decode = decode
        self._restore = restore
        return self

    def uninstall(self):
        self._restore()


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Served:
    index: int
    due: float                     # host clock; closed loop: when sent
    done: Optional[float] = None
    result: object = None
    error: Optional[str] = None


def batch_request(req, voices):
    from echo_tts_torch.serve.batcher import BatchRequest
    lat, mask = voices[req.voice]
    return BatchRequest(text=req.text, seed=req.seed, speaker_latent=lat,
                        speaker_mask=mask, request_id=str(req.index))


def sampler_params(traffic) -> dict:
    """The request's sampler parameters: the configuration's sampler and the
    mix's sequence length."""
    return dict(traffic.sampler,
                sequence_length=traffic.params["sequence_length"])


def check_sequence_bucket(traffic):
    """Under auto_sequence_length the handler would pick this mix's
    sequence_length for every text (serve/presets.pick_sequence_bucket)."""
    from echo_tts_torch.serve.presets import pick_sequence_bucket
    seq = traffic.params["sequence_length"]
    if not traffic.params.get("auto_sequence_length"):
        return
    for r in traffic.requests:
        if pick_sequence_bucket(r.text, 640) != seq:
            raise ValueError(f"text of {len(r.text)} characters is not in "
                             f"the {seq}-latent bucket")


def warm(server, traffic, voices) -> None:
    """One pass at each batch bucket the mix uses, through the server."""
    for b in traffic.params["warm_batches"]:
        futs = [server.submit(batch_request(r, voices), sampler_params(traffic))
                for r in traffic.requests[:b]]
        for f in futs:
            f.result()


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

class ServingLoop:
    """Set-up, counters, sample and check of a cell served through
    MicroBatchServer; a subclass gives `drive` and `end_to_end`."""

    def __init__(self, cell, traffic, seed: int, device):
        self.cell, self.traffic, self.seed, self.device = (cell, traffic,
                                                           seed, device)
        self.served: List[Served] = []
        self.server = self.models = self.recorder = None

    @property
    def passes(self) -> List[Pass]:
        return self.recorder.passes if self.recorder is not None else []

    def setup(self) -> None:
        from echo_tts_torch.serve.server import MicroBatchServer
        self.traffic.sampler = dict(self.cell.config["sampler"])
        check_sequence_bucket(self.traffic)
        self.models = build_models(self.cell.config, self.seed, self.device)
        self.voices = voice_latents(self.cell.config, self.traffic, self.seed,
                                    self.device)
        self.recorder = Recorder().install()
        self.server = MicroBatchServer(
            self.models, max_batch=self.traffic.params["max_batch"])
        warm(self.server, self.traffic, self.voices)

    def start(self) -> None:
        self.recorder.recording = True

    def stop(self) -> None:
        self.recorder.recording = False

    def counters(self) -> Dict[str, dict]:
        """The server's and the programs' counters, for the readers (the
        harness hands them the window's change)."""
        from echo_tts_torch.utils import programs
        s = self.server.stats()
        return {"server": {k: s[k] for k in ("batches", "completed",
                                             "failed")},
                "programs": {k: {f: v[f] for f in ("misses", "hits")}
                             for k, v in programs.stats().items()}}

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
        if self.recorder is not None:
            self.recorder.uninstall()

    def free(self) -> None:
        """The program's state, freed before the reference runs."""
        import torch
        from echo_tts_torch.utils import programs
        self.server = self.models = None
        self.served = []
        self.recorder.passes = []
        programs.clear_all()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------

    def collect(self) -> List[dict]:
        """A sample, drawn from the seed, of the finished requests' inputs
        and served outputs, on the host."""
        rows = {}
        for p in self.passes:
            for i, rid in enumerate(p.request_ids):
                rows.setdefault(rid, (p, i))
        done = [s for s in self.served
                if s.error is None and str(s.index) in rows]
        n = min(self.traffic.params["check_requests"], len(done))
        picked = random.Random(int(self.seed) ^ 0x5EED).sample(done, n)
        out = []
        for s in picked:
            p, i = rows[str(s.index)]
            out.append({"request": self.traffic.request(s.index),
                        "latents": p.latents[i].float().cpu().numpy(),
                        "audio": np.asarray(s.result.audio[0], np.float32)})
        return out

    def compare(self, sample: List[dict], control: bool) -> Dict[str, dict]:
        return check.compare(self.cell, self.voices, sample, self.seed,
                             self.device, control)

    # -- what a run reports --------------------------------------------------

    def attempted(self) -> int:
        return len(self.served)

    def failures(self) -> List[str]:
        return [f"request {s.index}: {s.error}" for s in self.served
                if s.error is not None]

    def drive(self, t0: float, seconds: float) -> None:
        raise NotImplementedError

    def end_to_end(self, t0: float, seconds: float) -> Dict[str, float]:
        raise NotImplementedError
