"""ako_tpu_torch.parallel.tiles on a mesh of four CPU devices against
the benchmark's plain reference (portbench/reference/codec.py, plain
PyTorch: no JAX here), on seeded photographs (portbench/harness/pool.py)
at small sizes with four tile shapes and pad tiles: blobs byte for byte,
pixels bit for bit, on both decode routes. Then the route's spans while
a profiler records (one `ako.shard.*` span a call, group or shard run)
and none without one, and its counters `shard_tiles` and
`shard_pad_tiles` against the plan, on the tractor's own grid too."""

import time

import numpy as np
import pytest
import torch

from ako_tpu_torch.core import geometry
from ako_tpu_torch.parallel import make_mesh
from ako_tpu_torch.parallel import tiles as ptiles
from ako_tpu_torch.utils import metrics, tracing
from portbench.harness.main import port_settings
from portbench.harness.pool import photo
from portbench.reference import codec as ref

SHARDS = 4
#: (width, height, channels, tiles_dimension): 24 tiles in shape groups
#: of 15, 5, 3 and 1 (8 pad tiles over 4 shards), and an RGBA image with
#: a constant alpha (the staging's fill) in groups of 6, 3, 2 and 1
CASES = [(232, 360, 3, 64), (200, 136, 4, 64)]
SETTINGS = {"wavelet": "DD137", "color": "YCOCG", "wrap": "CLAMP", "compression": "KAGARI",
            "quantization": 16, "gate": 0, "chroma_loss": 1, "discard_non_visible": False}


def mesh():
    return make_mesh((SHARDS,), ("tiles",), devices=[torch.device("cpu")] * SHARDS)


def image(w: int, h: int, c: int, seed: int) -> np.ndarray:
    gen = torch.Generator().manual_seed(seed)
    return photo(gen, h, w, c, 2.0, "cpu").numpy()


def settings(td: int) -> dict:
    return dict(SETTINGS, tiles_dimension=td)


def plan(w: int, h: int, td: int) -> list:
    """(tiles, padded tiles, shard runs with real tiles) of each shape
    group."""
    out = []
    for _, tiles in geometry.group_by_shape(geometry.tile_grid(w, h, td)).items():
        n = len(tiles)
        padded = ptiles.pad_batch(n, SHARDS)
        per = padded // SHARDS
        out.append((n, padded, sum(1 for s in range(SHARDS) if s * per < n)))
    return out


@pytest.mark.parametrize("device_entropy", [True, False])
@pytest.mark.parametrize("w,h,c,td", CASES)
def test_blob_and_pixels_equal_the_reference(w, h, c, td, device_entropy):
    img = image(w, h, c, 2**31 + 20 + c)
    cfg = settings(td)
    enc = ref.Encoder(torch.from_numpy(img), ref.Settings.from_config(cfg))
    m = mesh()
    blob = ptiles.encode_image_sharded(img, port_settings(cfg), m)
    assert blob == enc.blob_at(cfg["quantization"])
    pixels, s, channels = ptiles.decode_image_sharded(blob, m, device_entropy=device_entropy)
    assert channels == c and s.tiles_dimension == td
    assert np.array_equal(pixels, enc.pixels_at(cfg["quantization"]).numpy())


def test_the_plans_groups_and_pads():
    assert [p[:2] for p in plan(*CASES[0][:2], 64)] == [(15, 16), (5, 8), (3, 4), (1, 4)]
    # the tractor at 128-px tiles: runs of 57, 5, 3 and 1 tiles a card
    assert plan(1632, 2464, 128) == [(228, 228, 4), (19, 20, 4), (12, 12, 4), (1, 4, 1)]


def test_counters_on_the_tractors_grid():
    metrics.reset()
    for n, _, _ in plan(1632, 2464, 128):
        runs = ptiles._runs(n, SHARDS)
        assert [hi - lo for lo, hi in runs] == [runs[0][1]] * SHARDS
    c = metrics.counters()
    assert (c[metrics.SHARD_TILES], c[metrics.SHARD_PAD_TILES]) == (260, 4)


def shard_spans(since_ns: int) -> dict:
    """{name: [(start, end)]} of the ako.shard.* spans logged since."""
    out: dict = {}
    for name, _, a, b in tracing.recorded_spans(since_ns):
        if name.startswith("ako.shard."):
            out.setdefault(name, []).append((a, b))
    return out


def test_spans_and_counters_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    w, h, c, td = CASES[0]
    img = image(w, h, c, 2**31 + 31)
    m = mesh()
    s = port_settings(settings(td))
    metrics.reset()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        blob = ptiles.encode_image_sharded(img, s, m)
        ptiles.decode_image_sharded(blob, m, device_entropy=True)
    got = shard_spans(t0)
    groups = plan(w, h, td)
    assert {k: len(v) for k, v in got.items()} == {
        "ako.shard.encode": 1,
        "ako.shard.encode.stage": len(groups),
        "ako.shard.encode.dispatch": SHARDS * len(groups),
        "ako.shard.encode.collect": sum(real for _, _, real in groups),
        "ako.shard.decode": 1,
        "ako.shard.decode.scan": 1,
        "ako.shard.decode.dispatch": SHARDS * len(groups),
        "ako.shard.decode.place": SHARDS * len(groups),
    }
    for side in ("encode", "decode"):
        (lo, hi), = got[f"ako.shard.{side}"]
        inner = [s for k, v in got.items() if k.startswith(f"ako.shard.{side}.") for s in v]
        assert all(lo <= a <= b <= hi for a, b in inner)
    tiles = sum(n for n, _, _ in groups)
    pads = sum(p - n for n, p, _ in groups)
    assert (tiles, pads) == (24, 8)
    c = metrics.counters()
    assert (c[metrics.SHARD_TILES], c[metrics.SHARD_PAD_TILES]) == (2 * tiles, 2 * pads)


def test_no_spans_without_a_profiler():
    w, h, c, td = CASES[1]
    t0 = time.time_ns()
    m = mesh()
    blob = ptiles.encode_image_sharded(image(w, h, c, 2**31 + 32), port_settings(settings(td)), m)
    ptiles.decode_image_sharded(blob, m)
    assert shard_spans(t0) == {}
    assert tracing.span("ako.shard.encode") is tracing.span("ako.shard.decode")
