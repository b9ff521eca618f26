"""runtime.executor.roundtrip_iter over the endlessly cycled pool with
the mix's `workers` and `depth`, started and filled with `warm_images`
in set-up, so that the window sees it running. Images still in flight
when the window ends are not counted. Each image completed in the window
is a request of kind `image`: the host-clock ms since the one before,
and its blob's payload bytes."""

import itertools
import time

from portbench.harness import rooflines
from portbench.harness.traffic import Loop as Base
from portbench.harness.traffic import Request, Result

ENTRIES = {"roundtrip_iter": "ako_tpu_torch.runtime.executor:roundtrip_iter"}


class Loop(Base):
    def warm(self) -> None:
        images = (self.pool[k % len(self.pool)] for k in itertools.count())
        self.it = self.api.roundtrip_iter(images, self.settings, workers=self.mix["workers"],
                                          depth=self.mix["depth"], device=self.device,
                                          **self.options)
        self.done = 0
        for _ in range(self.mix["warm_images"]):
            next(self.it)
            self.done += 1

    def window(self, seconds: float, traced: bool, annotate) -> Result:
        res = Result()
        last = time.perf_counter()
        end = last + seconds
        with annotate("portbench.stream"):
            for i in itertools.count():
                blob, pixels = next(self.it)
                now = time.perf_counter()
                if now >= end:
                    break
                res.requests.append(Request("image", (now - last) * 1e3, payload_bytes=(
                    rooflines.payload_bytes(self.config, blob))))
                last = now
                k = (self.done + i) % len(self.pool)
                res.attempted += 1
                res.images_done += 1
                if self.sampler.keep(i):
                    res.kept.append((k, {"blob": blob, "pixels": pixels}))
        res.seconds = seconds
        return res

    def close(self) -> None:
        self.it.close()


def reference(enc, mix: dict) -> dict:
    q = enc.base.quantization
    return {"blob": enc.blob_at(q), "pixels": enc.pixels_at(q).cpu().numpy()}
