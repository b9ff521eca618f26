"""One client: each request encodes the next pool image with
ako_tpu_torch.encode, then decodes that blob with ako_tpu_torch.decode,
each timed on the host clock, and waits for each."""

import itertools
import time

from portbench.harness import rooflines
from portbench.harness.traffic import Loop as Base
from portbench.harness.traffic import Result

ENTRIES = {"encode": "ako_tpu_torch:encode", "decode": "ako_tpu_torch:decode",
           "AkoError": "ako_tpu_torch:AkoError"}


class Loop(Base):
    def warm(self) -> None:
        blob = self.api.encode(self.pool[0], self.settings, device=self.device, **self.options)
        self.api.decode(blob, device=self.device, **self.options)

    def window(self, seconds: float, traced: bool, annotate) -> Result:
        res = Result()
        end = time.perf_counter() + seconds
        for i in itertools.count():
            if time.perf_counter() >= end:
                break
            k = i % len(self.pool)
            res.attempted += 1
            try:
                blob, enc = self._timed("encode", lambda ev: self.api.encode(
                    self.pool[k], self.settings, events=ev, device=self.device, **self.options),
                    traced, annotate)
                pixels, dec = self._timed("decode", lambda ev: self.api.decode(
                    blob, events=ev, device=self.device, **self.options)[0], traced, annotate)
            except self.api.AkoError:
                res.failed += 1
                continue
            enc.payload_bytes = dec.payload_bytes = rooflines.payload_bytes(self.config, blob)
            res.requests += [enc, dec]
            if self.sampler.keep(i):
                res.kept.append((k, {"blob": blob, "pixels": pixels}))
        res.seconds = seconds
        return res


def reference(enc, mix: dict) -> dict:
    q = enc.base.quantization
    return {"blob": enc.blob_at(q), "pixels": enc.pixels_at(q).cpu().numpy()}
