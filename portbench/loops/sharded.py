"""One client over a mesh of the mix's `shards` devices
(ako_tpu_torch.parallel.make_mesh, axis "tiles"): each request encodes
the next pool image with parallel.tiles.encode_image_sharded, then
decodes that blob with decode_image_sharded, each timed on the host clock,
and waits for each. The mesh is built once in set-up: cards 0 to
shards - 1, or the CPU repeated when the harness runs on the CPU. Set-up
encodes and decodes every pool image once, so that each image's payload
sizes have met every card's buffers before the window. The
configuration's `entry_options` are the decode's keyword arguments
(device_entropy)."""

import itertools
import time

import torch

from portbench.harness import rooflines
from portbench.harness.traffic import Loop as Base
from portbench.harness.traffic import Result

ENTRIES = {"make_mesh": "ako_tpu_torch.parallel:make_mesh",
           "encode": "ako_tpu_torch.parallel.tiles:encode_image_sharded",
           "decode": "ako_tpu_torch.parallel.tiles:decode_image_sharded",
           "AkoError": "ako_tpu_torch:AkoError"}


class Loop(Base):
    def warm(self) -> None:
        n = self.mix["shards"]
        devices = ([torch.device("cuda", i) for i in range(n)] if self.device is None
                   else [torch.device(self.device)] * n)
        self.mesh = self.api.make_mesh((n,), ("tiles",), devices=devices)
        for image in self.pool:
            blob = self.api.encode(image, self.settings, self.mesh)
            self.api.decode(blob, self.mesh, **self.options)

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
                    self.pool[k], self.settings, self.mesh), traced, annotate)
                pixels, dec = self._timed("decode", lambda ev: self.api.decode(
                    blob, self.mesh, **self.options)[0], traced, annotate)
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
