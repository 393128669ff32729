"""Closed loop over Dia-1.6B: `clients` callers, each sending its next
request when its last one has returned, through echo_tts_torch's
MicroBatchServer and run_batch with a Dia bundle (models/dia.DiaModels:
the encoder, the prompt prefill, the frame loop of sampler/ar.py, the
centred DAC 44 kHz decode through kernel B's centred instance).

The mix's own keys (benchmark/traffic/<mix>.json, beside the generator's):
each request's text (traffic.generate's words, `text_chars` long) becomes
two dialogue turns, "[S1] <first half> [S2] <second half>"; it generates
round(frames_per_char x its characters) frames, plus the flush; its voice
(one of `voices`) is a prompt of `voice_latents` frames (the generator's
voice length, read as frames) of seeded random codes, with a transcript
of `transcript_chars_per_s` characters a second of prompt put before the
text.  The end-to-end metric is the requested frames' audio of the whole
passes inside the window over their span (prompt and flush left out).

The check: `check_requests` requests drawn from the seed among the first
two passes' ask for their logits (BatchRequest.keep_logits); the frame
loop records them inside its captured step.  `logits_rel_rms`: the worst
of ||served - ref|| / ||ref|| over them, ref the plain reference's
teacher-forced forward over the same prompt and the codes the program
emitted (benchmark/reference/dia.py); `audio_rel_rms`: the served audio
against the reference's decode of the served codes; `codes_off_draw`:
of every code the kept requests sampled, the number that differ from the
reference's sampler (Dia's guidance and filters, `sample_next_token`)
drawn from the kept logits at the program's own uniforms, accepting a
code tied with the draw and leaving out draws that rounding could tip
(`DRAW_EDGE`).  The control holds the
reference with every product on fp8 operands in the program's place (the
draw check reads no reference product, so the control reports the
served count).
"""
import dataclasses
import gc
import random
import threading
import time
from typing import Dict, List

import numpy as np

from .. import harness, weights
from .serving import Served

SAMPLE_RATE = 44100
# A draw lies on an edge where a change of this size, in probability (or
# in the scaled logits), could change it: the served fp32 sampler against
# the reference's float64 one differ by about 1e-6 there
DRAW_EDGE = 1e-4


@dataclasses.dataclass
class DiaPass:
    """One server pass, from the benchmark's wrapper around run_batch and
    the program's spans inside it.  (This module has no `from __future__
    import annotations`: the harness loads it without registering it in
    sys.modules, where a dataclass would look up string annotations.)"""
    start: float                     # host clock (time.monotonic)
    end: float
    start_ns: int                    # the spans' clock (time.time_ns)
    end_ns: int
    request_ids: List[str]           # the pass's rows, padding included
    frames: List[int]
    prompt_frames: List[int]
    text_lengths: List[int]
    text_width: int = 0
    steps: int = 0
    capacity: int = 0
    attn_bucket: int = 0
    decode_batches: List[int] = dataclasses.field(default_factory=list)
    stages: Dict[str, List[tuple]] = dataclasses.field(default_factory=dict)

    @property
    def rows(self) -> int:
        return len(self.request_ids)

    def real_rows(self) -> List[int]:
        seen: Dict[str, int] = {}
        for i, rid in enumerate(self.request_ids):
            seen.setdefault(rid, i)
        return sorted(seen.values())


def dialogue(text: str) -> str:
    """The generator's text as two turns, split at the word nearest its
    middle."""
    words = text.split(" ")
    half = max(1, len(words) // 2)
    return "[S1] " + " ".join(words[:half]) + " [S2] " + " ".join(words[half:])


def frames_for(traffic, text: str) -> int:
    return int(round(traffic.params["frames_per_char"] * len(text)))


class Loop:

    def __init__(self, cell, traffic, seed: int, device):
        self.cell, self.traffic, self.seed, self.device = (cell, traffic,
                                                           seed, device)
        self.served: List[Served] = []
        self.passes: List[DiaPass] = []
        self.recording = False
        self.server = self.models = None
        self._restore = None
        self._steps0 = None
        self._t0_ns = 0

    # -- set-up ---------------------------------------------------------------

    def _models(self):
        import torch
        from echo_tts_torch.config import DACConfig, DiaConfig
        from echo_tts_torch.models.dac.dac import DAC44
        from echo_tts_torch.models.dia import DiaModel, DiaModels
        from ..reference import dia as rdia
        cfg = self.cell.config
        dtype = getattr(torch, cfg["dtype"])
        dia_cfg = DiaConfig(**{**cfg["dia"], "delay_pattern": tuple(
            cfg["dia"]["delay_pattern"])})
        c = dict(cfg["codec"])
        for k in ("encoder_rates", "decoder_rates",
                  "encoder_transformer_layers", "downsample_factor"):
            c[k] = tuple(c[k])
        with torch.device("meta"):
            model, dac = DiaModel(dia_cfg), DAC44(DACConfig(**c))
        model = model.to(dtype).to_empty(device=self.device)
        dac = dac.to(dtype).to_empty(device=self.device)
        weights.fill_(model, rdia.specs(cfg["dia"]),
                      weights.sub_seed(self.seed, 1), dtype)
        weights.fill_(dac, rdia.codec_specs(cfg["codec"]),
                      weights.sub_seed(self.seed, 2), dtype)
        return DiaModels(dia=model.eval().requires_grad_(False),
                         dac=dac.eval().requires_grad_(False), dtype=dtype,
                         keep_logits=self.traffic.params["check_requests"])

    def _voices(self):
        """Each voice's prompt codes (frames, channels) and transcript."""
        import torch
        from .. import traffic as traffic_mod
        cfg, p = self.cell.config["dia"], self.traffic.params
        gen = torch.Generator(device=self.device).manual_seed(
            weights.sub_seed(self.seed, 4))
        rnd = random.Random(weights.sub_seed(self.seed, 5))
        frame_s = (int(np.prod(self.cell.config["codec"]["decoder_rates"]))
                   / SAMPLE_RATE)
        out = []
        for n in self.traffic.voice_lengths:
            codes = torch.randint(0, self.cell.config["codec"][
                "codebook_size"], (n, cfg["channels"]), generator=gen,
                device=self.device).cpu().numpy()
            chars = max(1, int(round(n * frame_s
                                     * p["transcript_chars_per_s"])))
            out.append((codes, "[S1] " + traffic_mod._text(rnd, chars) + " "))
        return out

    def _request(self, r, keep: bool):
        from echo_tts_torch.serve.batcher import BatchRequest
        codes, transcript = self.voices[r.voice]
        return BatchRequest(text=dialogue(r.text), seed=r.seed,
                            prompt_codes=codes, prompt_text=transcript,
                            frames=frames_for(self.traffic, r.text),
                            keep_logits=keep, request_id=str(r.index))

    def _install(self):
        """Wrap the server's run_batch: each pass's times and rows."""
        from echo_tts_torch.serve import server
        from echo_tts_torch.utils import profiling
        run_batch = server.run_batch
        loop = self

        def run_batch_spanned(models, requests, params=None, **kwargs):
            t0, n0 = time.monotonic(), profiling.now_ns()
            out = run_batch(models, requests, params, **kwargs)
            if loop.recording:
                loop.passes.append(DiaPass(
                    t0, time.monotonic(), n0, profiling.now_ns(),
                    [r.request_id for r in requests],
                    [int(r.frames) for r in requests],
                    [len(r.prompt_codes) for r in requests],
                    [int(np.count_nonzero(loop._ids(r))) for r in requests]))
            return out

        server.run_batch = run_batch_spanned

        def restore():
            server.run_batch = run_batch
        self._restore = restore

    def _ids(self, r):
        from ..reference import dia as rdia
        return rdia.text_ids(r.prompt_text + r.text, self.cell.config["dia"])

    def setup(self) -> None:
        # the program's Dia first: a tree without it fails here, at once
        from echo_tts_torch.models import dia  # noqa: F401
        from echo_tts_torch.sampler import ar  # noqa: F401
        from echo_tts_torch.serve.server import MicroBatchServer
        p = self.traffic.params
        self.traffic.sampler = dict(self.cell.config["sampler"])
        self.models = self._models()
        self.voices = self._voices()
        first = 2 * p["max_batch"]
        self.keep = set(random.Random(int(self.seed) ^ 0x5EED).sample(
            range(first), p["check_requests"]))
        self._install()
        self.server = MicroBatchServer(self.models, max_batch=p["max_batch"])
        for b in p["warm_batches"]:
            futs = [self.server.submit(self._request(r, False),
                                       self.traffic.sampler)
                    for r in self.traffic.requests[:b]]
            for f in futs:
                f.result()

    # -- the window -----------------------------------------------------------

    def start(self) -> None:
        self.recording = True
        self._steps0 = self.counters().get("dia", {}).get("steps")
        self._t0_ns = time.time_ns()

    def stop(self) -> None:
        self.recording = False
        steps = self.counters().get("dia", {}).get("steps")
        if steps is not None and self._steps0 is not None:
            loops = sum(p.steps for p in self.passes)
            harness.log(f"dia counters: steps {steps - self._steps0}, the "
                        f"passes' frame loops {loops}")

    def drive(self, t0: float, seconds: float) -> None:
        traffic = self.traffic
        self.served = served = []
        lock = threading.Lock()
        stop = t0 + seconds

        def client():
            while time.monotonic() < stop:
                with lock:
                    r = traffic.request(len(served))
                    s = Served(r.index, time.monotonic())
                    served.append(s)
                try:
                    s.result = self.server.submit(
                        self._request(r, r.index in self.keep),
                        traffic.sampler).result()
                except Exception as exc:
                    s.error = repr(exc)
                s.done = time.monotonic()

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(traffic.params["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 180.0)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not return 180 s after the "
                               "window")
        self._read_spans()

    def _read_spans(self) -> None:
        """Each pass's stages from the program's spans (none on a program
        without them)."""
        try:
            from echo_tts_torch.utils.profiling import spans
        except ImportError:
            return
        every = spans()
        kept = [s for s in every if s.name.startswith("dia.")
                or s.name == "batch.decode"]
        builds = sum(s.name == "program.build" and s.start_ns >= self._t0_ns
                     for s in every)
        harness.log(f"dia program builds in the window: {builds}")
        for p in self.passes:
            for s in kept:
                if p.start_ns <= s.start_ns and s.end_ns <= p.end_ns:
                    p.stages.setdefault(s.name, []).append(
                        (s.start_ns, s.end_ns))
                    a = s.attrs
                    if s.name == "batch.decode":
                        p.decode_batches.append(int(a["rows"]))
                    elif s.name == "dia.encode":
                        p.text_width = int(a["text_width"])
                    elif s.name == "dia.decode":
                        p.steps = int(a["steps"])
                        p.capacity = int(a["cache_capacity"])
                        p.attn_bucket = int(a.get("attn_bucket", 0))
        for k, p in enumerate(self.passes):
            st = {n: sum(e - s for s, e in v) / 1e9
                  for n, v in p.stages.items()}
            harness.log(
                f"dia pass {k}: {p.end - p.start:.3f} s, {p.rows} requests, "
                f"{p.steps} steps; " + ", ".join(
                    f"{n} {v:.3f}" for n, v in sorted(st.items())))

    def end_to_end(self, t0: float, seconds: float) -> Dict[str, float]:
        whole = [p for p in self.passes
                 if p.start >= t0 and p.end <= t0 + seconds]
        if not whole:
            raise RuntimeError("no whole pass inside the window")
        hop = int(np.prod(self.cell.config["codec"]["decoder_rates"]))
        audio = sum(p.frames[i] * hop / SAMPLE_RATE
                    for p in whole for i in p.real_rows())
        span = whole[-1].end - whole[0].start
        harness.log(f"{len(whole)} whole passes, {audio:.1f} s of audio in "
                    f"{span:.3f} s")
        return {"audio_s_per_s": audio / span}

    def counters(self) -> Dict[str, dict]:
        from echo_tts_torch.utils import programs
        s = self.server.stats()
        out = {"server": {k: s[k] for k in ("batches", "completed",
                                            "failed")},
               "programs": {k: {f: v[f] for f in ("misses", "hits")}
                            for k, v in programs.stats().items()}}
        try:
            from echo_tts_torch.sampler.ar import generate
            out["dia"] = {"steps": generate.steps, "frames": generate.frames}
        except (ImportError, AttributeError):
            pass
        return out

    def attempted(self) -> int:
        return len(self.served)

    def failures(self) -> List[str]:
        return [f"request {s.index}: {s.error}" for s in self.served
                if s.error is not None]

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
        if self._restore is not None:
            self._restore()

    def free(self) -> None:
        import torch
        from echo_tts_torch.utils import programs
        self.server = self.models = None
        self.served = []
        programs.clear_all()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------------

    def collect(self) -> List[dict]:
        out = []
        for s in self.served:
            if s.error is None and s.result is not None \
                    and s.result.logits is not None:
                r = self.traffic.request(s.index)
                out.append({"request": r,
                            "codes": np.asarray(s.result.codes),
                            "logits": s.result.logits.float().cpu().numpy(),
                            "audio": np.asarray(s.result.audio[0],
                                                np.float32)})
        return out

    def compare(self, sample: List[dict], control: bool) -> Dict[str, dict]:
        import sys
        limits = self.cell.limits["limits"]
        if not sample:
            return {"checked_requests": {"value": 0.0, "limit": -1.0}}
        got = readings(self, sample, control)
        judged = got["control" if control else "served"]
        print(f"reading checked_requests {len(sample)}", file=sys.stderr)
        for side, numbers in got.items():
            for name, value in numbers.items():
                print(f"reading {side} {name} {value:.6g}", file=sys.stderr,
                      flush=True)
        return {name: {"value": judged[name], "limit": float(limit)}
                for name, limit in limits.items()}


def _rel(a: np.ndarray, ref: np.ndarray) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.sum((a - ref) ** 2) / np.sum(ref ** 2)))


def draws_off(loop: Loop, sample: List[dict]) -> Dict[str, int]:
    """Each kept request's codes against the reference's draw from its
    kept logits: frame j of channel c was drawn at step j + d_c, at
    position P + j + d_c + 1, with the uniform of (seed, that position,
    c).  The codes that differ off an edge, the draws on an edge, and the
    draws checked."""
    import torch
    from ..reference import dia as rdia
    cfg, sampler = loop.cell.config["dia"], loop.cell.config["sampler"]
    delay = np.asarray(cfg["delay_pattern"])
    out = {"off": 0, "edges": 0, "checked": 0}
    for s in sample:
        req = loop._request(s["request"], True)
        codes = s["codes"]
        lg = torch.from_numpy(s["logits"]).to(loop.device, torch.float64)
        pos = len(req.prompt_codes) + 1 + np.arange(lg.shape[1])
        u = torch.from_numpy(rdia.uniforms(req.seed, pos, cfg["channels"]))
        step = np.arange(codes.shape[0])[:, None] + delay[None]
        ch = np.broadcast_to(np.arange(cfg["channels"]), step.shape)
        # each step's draws, the emitted frame's code where one was drawn
        drawn = np.zeros(lg.shape[1:3], np.int64)
        drawn[step, ch] = codes
        off, edge = rdia.off_draw(lg[0], lg[1], u.to(loop.device),
                                  torch.from_numpy(drawn).to(loop.device),
                                  cfg, sampler, DRAW_EDGE)
        out["off"] += int(off.cpu().numpy()[step, ch].sum())
        out["edges"] += int(edge.cpu().numpy()[step, ch].sum())
        out["checked"] += int(codes.size)
    return out


def readings(loop: Loop, sample: List[dict],
             control: bool) -> Dict[str, Dict[str, float]]:
    """The served numbers (and with `control` the control's): the worst
    and the median over the sampled requests."""
    import torch
    from ..reference import dia as rdia
    from ..reference import fp32, lowered
    cfg = loop.cell.config
    dev, dtype = loop.device, getattr(torch, cfg["dtype"])
    low = loop.cell.limits.get("control", {})
    sides = {"served": ([], [])}
    if control:
        sides["control"] = ([], [])
    with fp32():
        W = weights.tensors(rdia.specs(cfg["dia"]),
                            weights.sub_seed(loop.seed, 1), dev, dtype)
        refs = []
        for s in sample:
            req = loop._request(s["request"], True)
            seq = rdia.delayed_sequence(cfg["dia"], req.prompt_codes,
                                        s["codes"])
            ids = torch.from_numpy(rdia.text_ids(req.prompt_text + req.text,
                                                 cfg["dia"]))[None].to(dev)
            tok = torch.from_numpy(seq)[None].to(dev)
            p = len(req.prompt_codes)

            def fwd():
                lc, lu = rdia.forward(W, cfg["dia"], ids, tok)
                return torch.stack([lc[0, p:], lu[0, p:]]).cpu().numpy()
            ref = fwd()
            refs.append(ref)
            sides["served"][0].append(_rel(s["logits"], ref))
            if control:
                with lowered(low["rest"]):
                    sides["control"][0].append(_rel(fwd(), ref))
        del W
        Wc = weights.tensors(rdia.codec_specs(cfg["codec"]),
                             weights.sub_seed(loop.seed, 2), dev, dtype)
        for s in sample:
            codes = torch.from_numpy(s["codes"].T.copy())[None].to(dev)
            ref = rdia.codec_decode(Wc, cfg["codec"], codes)[0].cpu().numpy()
            sides["served"][1].append(_rel(s["audio"], ref))
            if control:
                with lowered(low["rest"]):
                    ctl = rdia.codec_decode(Wc, cfg["codec"],
                                            codes)[0].cpu().numpy()
                sides["control"][1].append(_rel(ctl, ref))
        del Wc
    draws = draws_off(loop, sample)
    return {side: {"logits_rel_rms": max(lg), "audio_rel_rms": max(au),
                   "codes_off_draw": float(draws["off"]),
                   "logits_rel_rms_median": float(np.median(lg)),
                   "audio_rel_rms_median": float(np.median(au)),
                   "draws_on_edge": float(draws["edges"]),
                   "draws_checked": float(draws["checked"])}
            for side, (lg, au) in sides.items()}
