"""The one traffic generator: a mix's data file in, a run's requests out.

A mix is `benchmark/traffic/<name>.json`.  Its keys:

  loop            the load loop that serves it (benchmark/loops/<loop>.py)
  rate_per_s      optional: arrivals on a schedule at this offered rate;
                  the run's window holds round(rate * seconds) of them
  clients         optional, without rate_per_s: how many callers; the run
                  gets ample requests for them to take in turn
  sequence_length latents a request generates
  text_chars      [lo, hi]: the length of each request's text
  voices          how many voices the requests share, each a cached voice
                  latent of voice_latents [lo, hi] latents, padded to
                  speaker_bucket
  max_batch       the server's
  warm_batches    the batch buckets set-up warms
  check_requests  how many served requests the correctness check samples
  trace_seconds   optional: a --trace 1 run serves only the arrivals of
                  this first part of the window (its trace stays small)
  base_seed       draws the mix's arrival schedule and its set of sizes

Every run of a mix has the same arrival schedule (one Poisson draw from
base_seed, as a recorded trace would be replayed) and the same set of
text and voice lengths; the run's --seed orders the lengths and draws the
words, the voices' latents, the requests' noise seeds and the weights.
So seeds change what is computed and not how much or when: an open
loop's tail follows its bursts, and a schedule drawn anew for every seed
spread the p90 of 102 requests by 20 % from seed to seed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional

import numpy as np

WORDS = (
    "the a of and to in is was it for on with as his at by from they we "
    "say her she or an will my one all would there their what so up out "
    "if about who get which go me when make can like time no just him "
    "know take people into year your good some could them see other than "
    "then now look only come its over think also back after use two how "
    "our work first well way even new want because any these give day "
    "most us river morning garden letter window winter quiet station "
    "market evening travel music story silver yellow mountain harbor "
    "kitchen lantern forest promise weather ticket doctor careful gentle "
    "sudden bright distant narrow golden simple summer").split()


@dataclasses.dataclass
class Request:
    index: int
    text: str
    voice: int
    seed: int                 # the request's noise seed
    due_s: Optional[float]    # serve_open: offset from the window's start


@dataclasses.dataclass
class Traffic:
    name: str
    params: dict
    requests: List[Request]   # serve_closed: the callers' requests in turn
    voice_lengths: List[int]

    def trim(self, seconds: float) -> None:
        """Keep the arrivals due in the first `seconds`."""
        self.requests = [r for r in self.requests
                         if r.due_s is None or r.due_s < seconds]

    def request(self, k: int) -> Request:
        """The k-th request; a closed loop that outruns the list cycles it."""
        r = self.requests[k % len(self.requests)]
        return r if r.index == k else dataclasses.replace(r, index=k)


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "benchmark", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _text(rng: random.Random, n_chars: int) -> str:
    words: List[str] = []
    while len(" ".join(words)) < n_chars:
        words.append(rng.choice(WORDS))
    text = " ".join(words)[:n_chars].rstrip()
    return text[0].upper() + text[1:] + "."


def generate(name: str, params: dict, seed: int, seconds: float) -> Traffic:
    base = np.random.default_rng(params["base_seed"])
    run = random.Random(int(seed))
    if "rate_per_s" in params:
        n = max(1, round(params["rate_per_s"] * seconds))
        gaps = base.exponential(1.0, n)
        gaps = gaps / gaps.sum() * seconds    # n arrivals over the window
    else:
        n = params.get("clients", 1) * max(1, round(seconds)) * 2   # ample
        gaps = None
    lo, hi = params["text_chars"]
    lengths = base.integers(lo, hi + 1, n).tolist()
    vlo, vhi = params["voice_latents"]
    patch = 4
    voice_lengths = (base.integers(vlo // patch, vhi // patch + 1,
                                   params["voices"]) * patch).tolist()
    run.shuffle(lengths)
    run.shuffle(voice_lengths)
    if gaps is not None:
        due = np.cumsum(gaps) - gaps[0]
    requests = [
        Request(index=i, text=_text(run, lengths[i]),
                voice=run.randrange(params["voices"]),
                seed=run.randrange(2 ** 62),
                due_s=None if gaps is None else float(due[i]))
        for i in range(n)]
    return Traffic(name=name, params=params, requests=requests,
                   voice_lengths=[int(v) for v in voice_lengths])
