"""ako_tpu_torch.encode / decode on the device-entropy path, on the CPU,
against ako_tpu's device-entropy path (device_entropy=True under JAX on
the CPU): blobs byte-identical, pixels bit-identical and the same
fallback counts, in both lift wirings. Covers lossy and lossless, odd
image sides, a constant alpha plane, a noise tile past the pack budget,
the quirk route of the decoder, and broken blobs."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import ako_tpu
import ako_tpu_torch
from ako_tpu.utils import metrics as ref_metrics
from ako_tpu_torch import Compression, Settings, Wavelet
from ako_tpu_torch.core import geometry
from ako_tpu_torch.encode import stage_tiles
from ako_tpu_torch.ops import lift_kernels
from ako_tpu_torch.utils import metrics
from ako_tpu_torch.utils.corpus import corpus


def _ref_settings(s: Settings) -> ako_tpu.Settings:
    ref_default = ako_tpu.Settings()
    return ako_tpu.Settings(**{
        f.name: type(getattr(ref_default, f.name))(int(getattr(s, f.name)))
        for f in dataclasses.fields(Settings)
    })


def _noise_tile():
    img = corpus(21, 1, 64, 128, 4)[0]
    img[:, 64:, :] = np.random.default_rng(21).integers(0, 256, size=(64, 64, 4), dtype=np.uint8)
    return img


def _constant_alpha():
    img = corpus(22, 1, 64, 80, 4)[0]
    img[..., 3] = 255
    return img


# (image maker, settings); few tile shapes, since the JAX programs
# compile per shape
CASES = {
    # 32x32 and 16x32 tiles: two shape groups
    "lossy_t32_const_alpha": (_constant_alpha, Settings(quantization=16, tiles_dimension=32)),
    # odd sides at every level
    "lossless_odd_whole": (lambda: corpus(23, 1, 41, 38, 3)[0], Settings(quantization=0, gate=0)),
    "noise_past_budget_t64": (_noise_tile, Settings(quantization=16, tiles_dimension=64)),
    "gray_whole_tile": (lambda: corpus(24, 1, 40, 36, 1)[0], Settings(quantization=24)),
    "wavelet_none_t16": (lambda: corpus(25, 1, 32, 32, 3)[0],
                         Settings(wavelet=Wavelet.NONE, tiles_dimension=16)),
}

_REFS: dict = {}


def _reference(name):
    """ako_tpu's device-entropy blob, pixels and fallback counts (once
    per case: the JAX programs compile per tile shape)."""
    if name not in _REFS:
        make, s = CASES[name]
        img = make()
        ref_metrics.reset()
        blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=True)
        pix = ako_tpu.decode(blob, device_entropy=True)[0]
        _REFS[name] = (img, blob, pix, ref_metrics.fallback_summary())
    return _REFS[name]


@pytest.mark.parametrize("mode", lift_kernels.MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_codec_vs_reference(monkeypatch, name, mode):
    monkeypatch.setenv("AKO_TORCH_LIFT_MODE", mode)
    img, ref_blob, ref_pix, ref_counts = _reference(name)
    s = CASES[name][1]
    metrics.reset()
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True)
    assert blob == ref_blob
    pix = ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]
    np.testing.assert_array_equal(pix, ref_pix)
    assert metrics.fallback_summary() == ref_counts
    if s.quantization == 0 and s.gate == 0:
        np.testing.assert_array_equal(pix, img)


def test_noise_tile_takes_the_host_coder():
    """The noise tile is past the pack budget: counted, and the blob
    stays the host path's."""
    img, blob, _, counts = _reference("noise_past_budget_t64")
    assert counts[metrics.ENC_HOST_FALLBACK] == 1
    assert counts[metrics.ENC_DEVICE] == 1
    s = CASES["noise_past_budget_t64"][1]
    assert ako_tpu_torch.encode(img, s, device="cpu", device_entropy=False) == blob


def test_cpu_default_is_host_entropy():
    """device_entropy=None on the CPU is the host path, as ako_tpu's
    rule for its CPU backend: no device-entropy tile is counted."""
    img, blob, pix, _ = _reference("lossy_t32_const_alpha")
    metrics.reset()
    assert ako_tpu_torch.encode(img, CASES["lossy_t32_const_alpha"][1], device="cpu") == blob
    np.testing.assert_array_equal(ako_tpu_torch.decode(blob, device="cpu")[0], pix)
    assert set(metrics.fallback_summary().values()) == {0}


def test_decode_quirk_tiles_on_the_host(monkeypatch):
    """Tiles whose sync scan reports codes over 31 bits decode on the
    host, are counted, and stay exact (the flag is forced, as in
    tests/test_metrics.py)."""
    port_decode = importlib.import_module("ako_tpu_torch.decode")
    orig = port_decode.kagari_sync

    def flagged(*a, **k):
        r = orig(*a, **k)
        return None if r is None else (*r[:5], 33)

    monkeypatch.setattr(port_decode, "kagari_sync", flagged)
    _, blob, pix, _ = _reference("lossy_t32_const_alpha")
    metrics.reset()
    got = ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]
    np.testing.assert_array_equal(got, pix)
    c = metrics.fallback_summary()
    assert c[metrics.DEC_HOST_FALLBACK] == 6  # 4 tiles of 32x32, 2 of 16x32
    assert c[metrics.DEC_DEVICE] == 0


def test_manbavaran_flag_vs_reference():
    """The reserved flag carries Kagari bytes on both paths; its decode
    takes the host entropy path."""
    img = _constant_alpha()
    s = dataclasses.replace(
        CASES["lossy_t32_const_alpha"][1], compression=Compression.MANBAVARAN
    )
    ref_blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=True)
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True)
    assert blob == ref_blob
    np.testing.assert_array_equal(
        ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0],
        ako_tpu.decode(blob, device_entropy=True)[0],
    )


def test_events_match_reference():
    """Events fire per shape group, as in ako_tpu's fused path."""
    img, blob, _, _ = _reference("lossy_t32_const_alpha")
    s = CASES["lossy_t32_const_alpha"][1]
    got, ref = [], []
    ako_tpu_torch.encode(img, s, lambda *a: got.append(a[:3]), device="cpu", device_entropy=True)
    ako_tpu.encode(img, _ref_settings(s), lambda *a: ref.append(a[:3]), device_entropy=True)
    ako_tpu_torch.decode(blob, lambda *a: got.append(a[:3]), device="cpu", device_entropy=True)
    ako_tpu.decode(blob, lambda *a: ref.append(a[:3]), device_entropy=True)
    assert [(t, n, int(e)) for t, n, e in got] == [(t, n, int(e)) for t, n, e in ref]


@pytest.mark.parametrize("h,w,td", [(64, 80, 32), (41, 38, 16), (40, 36, 0)])
def test_stage_tiles_equals_per_tile_cut(h, w, td):
    """One strided copy per shape group gives each tile's pixels, in the
    group's order; a list that is no row-major rectangle raises."""
    src = torch.from_numpy(corpus(26, 1, h, w, 4)[0])[..., :-1]
    for (tw, th), tiles in geometry.group_by_shape(geometry.tile_grid(w, h, td)).items():
        want = torch.stack([src[t.y : t.y + th, t.x : t.x + tw] for t in tiles])
        assert torch.equal(stage_tiles(src, tiles, tw, th), want)
        if len(tiles) > 1:
            with pytest.raises(ValueError, match="rectangle"):
                stage_tiles(src, tiles[::-1], tw, th)


def test_flipped_image_view():
    """A view with negative strides encodes as its copy does."""
    img = corpus(27, 1, 32, 48, 4)[0]
    img[..., 3] = 7
    s = Settings(quantization=16, tiles_dimension=16)
    view = img[::-1, ::-1]
    want = ako_tpu_torch.encode(view.copy(), s, device="cpu", device_entropy=True)
    assert ako_tpu_torch.encode(view, s, device="cpu", device_entropy=True) == want


@pytest.mark.parametrize("cut", [17, 200, -1])
def test_broken_blobs_raise_like_reference(cut):
    _, blob, _, _ = _reference("lossy_t32_const_alpha")
    broken = blob[:cut]
    with pytest.raises(ako_tpu.AkoError) as ref:
        ako_tpu.decode(broken, device_entropy=True)
    with pytest.raises(ako_tpu_torch.AkoError) as got:
        ako_tpu_torch.decode(broken, device="cpu", device_entropy=True)
    assert int(got.value.status) == int(ref.value.status)
