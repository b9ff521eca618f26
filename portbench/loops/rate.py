"""One client: a closed loop of tools.rate.encode_with_ratio at the mix's
`ratio`, each search timed on the host clock."""

import itertools
import time

from portbench.harness.traffic import Loop as Base
from portbench.harness.traffic import Result
from portbench.reference import codec as ref

ENTRIES = {"encode_with_ratio": "ako_tpu_torch.tools.rate:encode_with_ratio",
           "AkoError": "ako_tpu_torch:AkoError"}


class Loop(Base):
    def warm(self) -> None:
        self.api.encode_with_ratio(self.pool[0], self.settings, self.mix["ratio"],
                                   device=self.device, **self.options)

    def window(self, seconds: float, traced: bool, annotate) -> Result:
        res = Result()
        end = time.perf_counter() + seconds
        for i in itertools.count():
            if time.perf_counter() >= end:
                break
            k = i % len(self.pool)
            res.attempted += 1
            try:
                (blob, q), req = self._timed("search", lambda ev: self.api.encode_with_ratio(
                    self.pool[k], self.settings, self.mix["ratio"], device=self.device,
                    **self.options), traced, annotate)
            except self.api.AkoError:
                res.failed += 1
                continue
            res.requests.append(req)
            if self.sampler.keep(i):
                res.kept.append((k, {"blob": blob, "q": q}))
        res.seconds = seconds
        return res


def reference(enc, mix: dict) -> dict:
    q, blob = ref.encode_with_ratio(enc, mix["ratio"])
    return {"blob": blob, "q": q}
