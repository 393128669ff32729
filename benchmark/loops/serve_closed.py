"""Closed loop: `clients` callers, each sending its next request when its
last one has returned, until the window closes; the end-to-end metric is
the audio of the whole passes inside the window over their span."""
from __future__ import annotations

import threading
import time
from typing import Dict

from .. import harness
from .serving import ServingLoop, Served, batch_request, sampler_params

SAMPLES_PER_LATENT = 2048


class Loop(ServingLoop):

    def drive(self, t0: float, seconds: float) -> None:
        traffic, voices = self.traffic, self.voices
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
                        batch_request(r, voices),
                        sampler_params(traffic)).result()
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

    def end_to_end(self, t0: float, seconds: float) -> Dict[str, float]:
        whole = [p for p in self.passes
                 if p.start >= t0 and p.end <= t0 + seconds]
        if not whole:
            raise RuntimeError("no whole pass inside the window")
        rate = self.cell.config["codec"]["sample_rate"]
        audio = sum(len(p.real_rows()) * p.seq * SAMPLES_PER_LATENT / rate
                    for p in whole)
        span = whole[-1].end - whole[0].start
        harness.log(f"{len(whole)} whole passes, {audio:.1f} s of audio in "
                    f"{span:.3f} s")
        return {"audio_s_per_s": audio / span}
