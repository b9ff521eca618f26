"""ako_tpu_torch.encode / decode on the CPU against ako_tpu's host
entropy path (device_entropy=False) and the committed golden files:
blobs byte-identical, pixels bit-identical, each package decoding the
other's blobs."""

import dataclasses
import os

import numpy as np
import pytest

import ako_tpu
import ako_tpu_torch
from ako_tpu_torch import Color, Compression, Settings, Wavelet, Wrap
from ako_tpu_torch.core.settings import from_reference
from ako_tpu_torch.utils.corpus import corpus

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_SETTINGS = {
    "q16": Settings(quantization=16),
    "lossless": Settings(quantization=0, gate=0),
    "tiled_q16": Settings(quantization=16, tiles_dimension=16),
}


def _ref_settings(s: Settings) -> ako_tpu.Settings:
    ref_default = ako_tpu.Settings()
    return ako_tpu.Settings(**{
        f.name: type(getattr(ref_default, f.name))(int(getattr(s, f.name)))
        for f in dataclasses.fields(Settings)
    })


def _image(seed, h, w, ch):
    return corpus(seed, 1, h, w, ch)[0]


def _check_against_reference(img, s: Settings):
    ref_blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    blob = ako_tpu_torch.encode(img, s, device="cpu")
    assert blob == ref_blob

    ref_pix, ref_s, ref_ch = ako_tpu.decode(ref_blob, device_entropy=False)
    pix, got_s, ch = ako_tpu_torch.decode(ref_blob, device="cpu")
    np.testing.assert_array_equal(pix, ref_pix)
    assert got_s == from_reference(ref_s)
    assert ch == ref_ch
    # and the reference decodes the port's blob
    np.testing.assert_array_equal(ako_tpu.decode(blob, device_entropy=False)[0], pix)
    return blob, pix


@pytest.fixture(scope="module")
def golden_image():
    return np.load(os.path.join(GOLDEN, "image_40x48_rgb.npy"))


@pytest.mark.parametrize("name", list(GOLDEN_SETTINGS))
def test_encode_matches_golden(golden_image, name):
    blob = ako_tpu_torch.encode(golden_image, GOLDEN_SETTINGS[name], device="cpu")
    with open(os.path.join(GOLDEN, f"{name}.ako"), "rb") as f:
        assert blob == f.read()


@pytest.mark.parametrize("name", list(GOLDEN_SETTINGS))
def test_decode_matches_golden(name):
    with open(os.path.join(GOLDEN, f"{name}.ako"), "rb") as f:
        out, _, _ = ako_tpu_torch.decode(f.read(), device="cpu")
    np.testing.assert_array_equal(out, np.load(os.path.join(GOLDEN, f"{name}_decoded.npy")))


@pytest.mark.parametrize("name", list(GOLDEN_SETTINGS))
def test_golden_image_vs_reference(golden_image, name):
    _check_against_reference(golden_image, GOLDEN_SETTINGS[name])


CASES = {
    # ragged tiles with odd sides (99 = 3*32 + 3, 131 = 4*32 + 3)
    "rgba_99x131_t32": ((99, 131, 4), Settings(quantization=16, tiles_dimension=32)),
    "gray_40x36": ((40, 36, 1), Settings(quantization=24)),
    "gray_alpha_discard": ((33, 40, 2), Settings(quantization=8, discard_non_visible=True)),
    "lossless_q0_t16": ((40, 44, 3), Settings(quantization=0, gate=0, tiles_dimension=16)),
    "dd137_mirror_gate": ((41, 38, 3), Settings(wavelet=Wavelet.DD137, wrap=Wrap.MIRROR, gate=4)),
    "cdf53_repeat": ((37, 45, 3), Settings(wavelet=Wavelet.CDF53, wrap=Wrap.REPEAT, quantization=12)),
    "haar_zero_subg": (
        (36, 43, 4),
        Settings(wavelet=Wavelet.HAAR, wrap=Wrap.ZERO, color=Color.SUBTRACT_G, chroma_loss=3),
    ),
    "wavelet_none_t16": ((24, 40, 3), Settings(wavelet=Wavelet.NONE, tiles_dimension=16)),
    "compression_none": ((30, 34, 3), Settings(compression=Compression.NONE, quantization=4)),
    "manbavaran_flag": ((30, 34, 4), Settings(compression=Compression.MANBAVARAN)),
    "corpus_256x320_t128": ((256, 320, 4), Settings(quantization=16, tiles_dimension=128)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_codec_vs_reference(name):
    (h, w, ch), s = CASES[name]
    img = _image(sum(map(ord, name)), h, w, ch)
    if s.discard_non_visible:
        img[: h // 3, :, -1] = 0
    blob, pix = _check_against_reference(img, s)
    if s.quantization == 0 and s.gate == 0:
        np.testing.assert_array_equal(pix, img)


def test_decodes_reference_rans_payloads(monkeypatch):
    """ako_tpu's MANBAVARAN extension writes real rANS payloads under
    the reserved flag; the port decodes them (and writes Kagari bytes)."""
    img = _image(9, 40, 48, 4)
    s = Settings(compression=Compression.MANBAVARAN, tiles_dimension=16)
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    ref_blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    monkeypatch.delenv("AKO_TPU_MANBAVARAN")
    assert ref_blob != ako_tpu_torch.encode(img, s, device="cpu")
    ref_pix = ako_tpu.decode(ref_blob, device_entropy=False)[0]
    np.testing.assert_array_equal(ako_tpu_torch.decode(ref_blob, device="cpu")[0], ref_pix)


def test_incompressible_tile_fails_like_reference():
    """97 = 3*32 + 1: the 1-px remainder tiles have no lift levels and
    their raw LP plane does not fit the Kagari budget."""
    img = _image(11, 97, 131, 4)
    s = Settings(quantization=16, tiles_dimension=32)
    with pytest.raises(ako_tpu.AkoError) as ref:
        ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    with pytest.raises(ako_tpu_torch.AkoError) as got:
        ako_tpu_torch.encode(img, s, device="cpu")
    assert int(got.value.status) == int(ref.value.status) == int(ako_tpu_torch.Status.ERROR)


def test_events_match_reference():
    img = _image(5, 40, 52, 3)
    s = Settings(quantization=16, tiles_dimension=16)
    got, ref = [], []
    blob = ako_tpu_torch.encode(img, s, lambda *a: got.append(a[:3]), device="cpu")
    ako_tpu.encode(img, _ref_settings(s), lambda *a: ref.append(a[:3]), device_entropy=False)
    ako_tpu_torch.decode(blob, lambda *a: got.append(a[:3]), device="cpu")
    ako_tpu.decode(blob, lambda *a: ref.append(a[:3]), device_entropy=False)
    assert [(t, n, int(e)) for t, n, e in got] == [(t, n, int(e)) for t, n, e in ref]


BREAKS = {
    "short_header": lambda b: b[:10],
    "header_only": lambda b: b[:16],
    "bad_magic": lambda b: b"Akx" + b[3:],
    "truncated_block": lambda b: b[:-1],
    "corrupt_block_head": lambda b: b[:16] + b"\xff\xff\xff\x7f" + b[20:],
}


@pytest.mark.parametrize("name", list(BREAKS))
def test_broken_blobs_raise_like_reference(name):
    with open(os.path.join(GOLDEN, "tiled_q16.ako"), "rb") as f:
        blob = BREAKS[name](f.read())
    with pytest.raises(ako_tpu.AkoError) as ref:
        ako_tpu.decode(blob, device_entropy=False)
    with pytest.raises(ako_tpu_torch.AkoError) as got:
        ako_tpu_torch.decode(blob, device="cpu")
    assert int(got.value.status) == int(ref.value.status)


def test_default_device_needs_cuda(golden_image, monkeypatch):
    """device=None means the card: without one, encode/decode raise
    instead of running on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ako_tpu_torch.encode(golden_image)
    with open(os.path.join(GOLDEN, "q16.ako"), "rb") as f:
        blob = f.read()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ako_tpu_torch.decode(blob)
