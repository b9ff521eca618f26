"""The MANBAVARAN extension on ako_tpu_torch's host-entropy path: with
AKO_TPU_MANBAVARAN=1 and Compression.MANBAVARAN the port writes ako_tpu's
rANS payloads (byte for byte, on the CPU), both packages decode them, and
without the env both write the reference's Kagari parity bytes. The
port's device-entropy encode writes the same rANS bytes
(tests/test_torch_manba_device.py holds that path to ako_tpu's)."""

import numpy as np
import pytest

import ako_tpu
import ako_tpu_torch
from ako_tpu_torch import Compression, Settings
from ako_tpu_torch.core import container
from ako_tpu_torch.runtime import kagari
from ako_tpu_torch.utils.corpus import corpus
from tests.test_torch_codec import _ref_settings

CASES = {
    "rgba_t128": ((128, 256, 4), Settings(quantization=16, tiles_dimension=128,
                                         compression=Compression.MANBAVARAN)),
    "gray": ((72, 56, 1), Settings(quantization=24, compression=Compression.MANBAVARAN)),
    "lossless": ((64, 48, 3), Settings(quantization=0, gate=0,
                                       compression=Compression.MANBAVARAN)),
}


def _image(name):
    (h, w, ch), _ = CASES[name]
    return corpus(0x3A7 + h, 1, h, w, ch)[0]


@pytest.mark.parametrize("name", list(CASES))
def test_manba_host_matches_reference(name, monkeypatch):
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    img, s = _image(name), CASES[name][1]
    ref_blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=False)
    assert blob == ref_blob
    # rANS payloads, not Kagari: the env-off blob differs
    monkeypatch.delenv("AKO_TPU_MANBAVARAN")
    assert ako_tpu_torch.encode(img, s, device="cpu", device_entropy=False) != blob
    ref_pix = ako_tpu.decode(blob, device_entropy=False)[0]
    pix = ako_tpu_torch.decode(blob, device="cpu")[0]
    np.testing.assert_array_equal(pix, ref_pix)
    if s.quantization == 0:
        np.testing.assert_array_equal(pix, img.reshape(pix.shape))


@pytest.mark.parametrize("name", list(CASES))
def test_manba_off_writes_kagari(name, monkeypatch):
    monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
    img, s = _image(name), CASES[name][1]
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=False)
    assert blob == ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    # the same Kagari blocks as Compression.KAGARI, under the reserved flag
    kag = ako_tpu_torch.encode(img, s.replace(compression=Compression.KAGARI), device="cpu",
                               device_entropy=False)
    assert blob[container.HEAD_SIZE:] == kag[container.HEAD_SIZE:] and blob != kag


def test_manba_device_entropy_matches_host(monkeypatch):
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    img, s = _image("gray"), CASES["gray"][1]
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True)
    assert blob == ako_tpu_torch.encode(img, s, device="cpu", device_entropy=False)
    assert kagari.effective_method(Compression.MANBAVARAN) == Compression.MANBAVARAN
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "0")
    assert kagari.effective_method(Compression.MANBAVARAN) == Compression.KAGARI
    assert kagari.manba_encode(np.zeros(4, np.int16), 0) is None
