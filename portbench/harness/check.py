"""What decides `correct`: the kept answers of the window against the
plain reference (portbench/reference), run once the window has closed,
on the same images, at the same sizes.

Each number compared is exact, so each limit is 0:
- `blob_bytes_off`: bytes in which kept blobs differ from the
  reference's (the length difference counted as bytes): the container
  head, every block head and every Kagari payload;
- `pixels_off`: values in which kept decoded images differ from the
  pixels the reference's streams decode to;
- `q_off` (rate searches): the sum of |q - the reference's q|;
- `failed`: requests that raised.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import codec as ref

LIMITS = {"blob_bytes_off": 0, "pixels_off": 0, "q_off": 0, "failed": 0}


def bytes_off(a: bytes, b: bytes) -> int:
    x, y = np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8)
    n = min(len(x), len(y))
    return int(np.count_nonzero(x[:n] != y[:n])) + abs(len(x) - len(y))


def values_off(a, b) -> int:
    if a.shape != b.shape:
        return b.size
    return int(np.count_nonzero(a != b))


#: each part of an answer: the number it adds to, and how it is compared
PARTS = {"blob": ("blob_bytes_off", bytes_off), "pixels": ("pixels_off", values_off),
         "q": ("q_off", lambda a, b: abs(a - b))}


class Expected:
    """The reference's answer for each pool image, as the loop's
    `reference(enc, mix)` gives it (a dict of the parts of the loop's kept
    answers), worked out once per image on `device`, with `store` the
    precision of its arithmetic."""

    def __init__(self, config: dict, mix: dict, pool: list, device, answer, store=ref.store16):
        self.settings = ref.Settings.from_config(config["settings"])
        self.mix = mix
        self.pool = pool
        self.device = device
        self.answer = answer
        self.store = store
        self._cache: dict = {}

    def __call__(self, k: int) -> dict:
        if k not in self._cache:
            image = torch.from_numpy(np.ascontiguousarray(self.pool[k])).to(self.device)
            self._cache[k] = self.answer(ref.Encoder(image, self.settings, self.store), self.mix)
        return self._cache[k]


def compare(kept: list, failed: int, expected: Expected) -> dict:
    """{number: value} over the kept answers [(pool image, {part: answer})]."""
    out = {"failed": failed}
    for k, answer in kept:
        want = expected(k)
        for part, got in answer.items():
            name, off = PARTS[part]
            out[name] = out.get(name, 0) + off(got, want[part])
    return out


def is_correct(numbers: dict) -> bool:
    """Every number within its limit, and some answer compared."""
    return len(numbers) > 1 and all(v <= LIMITS[k] for k, v in numbers.items())
