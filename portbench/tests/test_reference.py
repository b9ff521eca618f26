"""The plain reference against the port's plain path (device="cpu") at
reduced image sizes, with each configuration's settings: the blob byte
for byte, the decoded pixels bit for bit, the q/g tables and the rate
search's q and blob."""

import numpy as np
import pytest
import torch

import ako_tpu_torch
from ako_tpu_torch.encode import tile_qg
from ako_tpu_torch.tools.rate import encode_with_ratio
from portbench.harness.main import port_settings
from portbench.harness.pool import make_pool
from portbench.reference import codec as ref
from portbench.tests.conftest import SMALL, load_config

CASES = [(name, w, h) for name, sizes in SMALL.items() for w, h in sizes]
SEED = 2**31 + 123


def pool_of(name, w, h, n=2):
    cfg = dict(load_config(name), width=w, height=h, pool_images=n)
    return cfg, make_pool(cfg, SEED, "cpu")


@pytest.mark.parametrize("name,w,h", CASES)
def test_blob_and_pixels(name, w, h):
    cfg, pool = pool_of(name, w, h)
    s = ref.Settings.from_config(cfg["settings"])
    q = cfg["settings"]["quantization"]
    for img in pool:
        enc = ref.Encoder(torch.from_numpy(img), s)
        blob = ako_tpu_torch.encode(img, port_settings(cfg["settings"]), device="cpu")
        assert enc.blob_at(q) == blob
        pixels = ako_tpu_torch.decode(blob, device="cpu")[0]
        assert np.array_equal(enc.pixels_at(q).numpy(), pixels)


@pytest.mark.parametrize("name,w,h", CASES[:1] + CASES[-1:])
def test_rate_search(name, w, h):
    cfg, pool = pool_of(name, w, h, n=1)
    q, blob = ref.encode_with_ratio(
        ref.Encoder(torch.from_numpy(pool[0]), ref.Settings.from_config(cfg["settings"])), 12)
    assert (blob, q) == encode_with_ratio(pool[0], port_settings(cfg["settings"]), 12,
                                          device="cpu")


FACTORS = sorted({*range(0, 130), *(4**k for k in range(9)),
                  *np.random.default_rng(5).integers(1, 70000, 300).tolist()})


@pytest.mark.parametrize("tw,th,channels", [(128, 128, 4), (1632, 2464, 3), (200, 136, 4)])
def test_q_tables(tw, th, channels):
    """Every factor a rate search of these shapes can probe, and the
    gate at the same factors."""
    for f in FACTORS:
        s = ref.Settings("DD137", "YCOCG", "CLAMP", "KAGARI", 0, f, f, 1, False)
        assert ref.level_table(tw, th, channels, s) == [
            (list(qs), list(gs)) for qs, gs in tile_qg(tw, th, channels, f, f, 1)], f


def test_stores_wrap_like_c():
    x = torch.tensor([32767 + 1, -32769, 200, -129], dtype=torch.int32)
    assert ref.store16(x).tolist() == [-32768, 32767, 200, -129]
    assert ref.store8(x).tolist() == [0, -1, -56, 127]
