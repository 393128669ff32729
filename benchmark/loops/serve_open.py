"""Open loop: request i is sent at its due time on the mix's schedule,
whatever came before; the end-to-end metric is the tail of the latency
from due time to cropped audio on the host."""
from __future__ import annotations

import math
import time
from typing import Dict

from .. import harness
from .serving import ServingLoop, Served, batch_request, sampler_params


class Loop(ServingLoop):

    def drive(self, t0: float, seconds: float) -> None:
        traffic, voices = self.traffic, self.voices
        self.served = served = [Served(r.index, t0 + r.due_s)
                                for r in traffic.requests]

        def finish(s, fut):
            s.done = time.monotonic()
            if fut.exception() is not None:
                s.error = repr(fut.exception())
            else:
                s.result = fut.result()

        lateness = []
        for r, s in zip(traffic.requests, served):
            delay = s.due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            lateness.append(time.monotonic() - s.due)
            try:
                fut = self.server.submit(batch_request(r, voices),
                                         sampler_params(traffic))
            except Exception as exc:   # refused (queue full): a failure
                s.done, s.error = time.monotonic(), repr(exc)
                continue
            fut.add_done_callback(lambda f, s=s: finish(s, f))
        deadline = time.monotonic() + 120.0
        while (any(s.done is None for s in served)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for s in served:
            if s.done is None:
                s.error = "no answer 120 s after the window closed"
        harness.log(f"open loop: {len(served)} requests, generator late by "
                    f"at most {max(lateness, default=0.0) * 1e3:.1f} ms")

    def end_to_end(self, t0: float, seconds: float) -> Dict[str, float]:
        lat = [(s.done - s.due) * 1e3 if s.error is None else math.inf
               for s in self.served]
        p90 = harness.percentile(lat, 0.9)
        harness.log(f"request latency over {len(lat)} requests: p50 "
                    f"{harness.percentile(lat, 0.5):.1f} ms, p90 {p90:.1f} ms")
        return {"request_p90_ms": p90}
