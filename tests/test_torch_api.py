"""The rest of ako_tpu's codec API in ako_tpu_torch, on the CPU, against
ako_tpu under JAX on the CPU: the all-native modes AKO_TPU_ENCODE=host
and AKO_TPU_DECODE=host, per-tile events (AKO_TPU_EVENTS=tile), the
streaming decode decode_tiles_iter, the native per-tile functions of
runtime/hostcodec.py, and the utils (tracing, debug, developer). Bytes,
pixels and event sequences must be equal."""

import json

import numpy as np
import pytest

import ako_tpu
import ako_tpu_torch
from ako_tpu.decode import decode_tiles_iter as ref_decode_tiles_iter
from ako_tpu.runtime import hostcodec as ref_hostcodec
from ako_tpu.utils import debug as ref_debug
from ako_tpu.utils import developer as ref_developer
from ako_tpu.utils import metrics as ref_metrics
from ako_tpu_torch import Color, Compression, Settings, Wavelet, Wrap
from ako_tpu_torch.core import geometry
from ako_tpu_torch.decode import decode_tiles_iter
from ako_tpu_torch.encode import tile_events_mode, tile_qg
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.utils import debug, developer, metrics, tracing
from ako_tpu_torch.utils.corpus import corpus
from tests.test_torch_entropy import _constant_alpha, _noise_tile, _ref_settings


def _events(log):
    return lambda tile, total, event, user: log.append((tile, total, int(event)))


# ---------------------------------------------------------------- host modes

HOST_CASES = {
    "rgba_t32": (lambda: corpus(31, 1, 64, 80, 4)[0],
                 Settings(quantization=16, tiles_dimension=32)),
    "gray_whole": (lambda: corpus(32, 1, 40, 36, 1)[0], Settings(quantization=24)),
    "lossless_odd": (lambda: corpus(33, 1, 41, 38, 3)[0], Settings(quantization=0, gate=0)),
    "wavelet_none_t16": (lambda: corpus(34, 1, 32, 32, 3)[0],
                         Settings(wavelet=Wavelet.NONE, tiles_dimension=16)),
    "raw_blocks": (lambda: corpus(35, 1, 24, 20, 3)[0],
                   Settings(quantization=16, compression=Compression.NONE)),
    "manbavaran_t32": (lambda: corpus(36, 1, 64, 48, 3)[0],
                       Settings(quantization=16, tiles_dimension=32,
                                compression=Compression.MANBAVARAN)),
}


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_encode_mode(name, monkeypatch):
    monkeypatch.setenv("AKO_TPU_ENCODE", "host")
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    make, s = HOST_CASES[name]
    img = make()
    got_ev, ref_ev = [], []
    blob = ako_tpu_torch.encode(img, s, _events(got_ev), device="cpu")
    assert blob == ako_tpu.encode(img, _ref_settings(s), _events(ref_ev))
    assert got_ev == ref_ev
    assert len(got_ev) == 6 * len(geometry.tile_grid(img.shape[1], img.shape[0],
                                                     s.tiles_dimension))
    # the same blob as the default paths
    monkeypatch.delenv("AKO_TPU_ENCODE")
    assert blob == ako_tpu_torch.encode(img, s, device="cpu")


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_decode_mode(name, monkeypatch):
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    make, s = HOST_CASES[name]
    img = make()
    blob = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    want = ako_tpu_torch.decode(blob, device="cpu")[0]
    monkeypatch.setenv("AKO_TPU_DECODE", "host")
    got_ev, ref_ev = [], []
    pix, got_s, ch = ako_tpu_torch.decode(blob, _events(got_ev), device="cpu")
    ref_pix = ako_tpu.decode(blob, _events(ref_ev))[0]
    np.testing.assert_array_equal(pix, ref_pix)
    np.testing.assert_array_equal(pix, want)
    assert got_ev == ref_ev and ch == img.shape[2]


def test_host_decode_mode_truncated(monkeypatch):
    monkeypatch.setenv("AKO_TPU_DECODE", "host")
    make, s = HOST_CASES["rgba_t32"]
    blob = ako_tpu.encode(make(), _ref_settings(s), device_entropy=False)
    for cut in (17, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ako_tpu.AkoError) as ref:
            ako_tpu.decode(blob[:cut])
        with pytest.raises(ako_tpu_torch.AkoError) as got:
            ako_tpu_torch.decode(blob[:cut], device="cpu")
        assert int(got.value.status) == int(ref.value.status)


# ---------------------------------------------------------------- per-tile events

TILE_CASES = {
    "const_alpha_t32": (_constant_alpha, Settings(quantization=16, tiles_dimension=32)),
    "noise_past_budget_t64": (_noise_tile, Settings(quantization=16, tiles_dimension=64)),
}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_events(name, monkeypatch):
    """AKO_TPU_EVENTS=tile: per-tile event pairs on the device-entropy
    Kagari path, the same blob, pixels and fallback counts as ako_tpu."""
    monkeypatch.setenv("AKO_TPU_EVENTS", "tile")
    make, s = TILE_CASES[name]
    img = make()
    ref_enc, ref_dec, got_enc, got_dec = [], [], [], []
    ref_metrics.reset()
    ref_blob = ako_tpu.encode(img, _ref_settings(s), _events(ref_enc), device_entropy=True)
    ref_pix = ako_tpu.decode(ref_blob, _events(ref_dec), device_entropy=True)[0]
    metrics.reset()
    blob = ako_tpu_torch.encode(img, s, _events(got_enc), device="cpu", device_entropy=True)
    pix = ako_tpu_torch.decode(blob, _events(got_dec), device="cpu", device_entropy=True)[0]
    assert blob == ref_blob
    np.testing.assert_array_equal(pix, ref_pix)
    assert got_enc == ref_enc and got_dec == ref_dec
    assert metrics.fallback_summary() == ref_metrics.fallback_summary()
    tiles = len(geometry.tile_grid(img.shape[1], img.shape[0], s.tiles_dimension))
    assert len(got_enc) == len(got_dec) == 6 * tiles


def test_tile_events_mode_needs_a_callback(monkeypatch):
    monkeypatch.setenv("AKO_TPU_EVENTS", "tile")
    assert tile_events_mode(lambda *a: None) and not tile_events_mode(None)
    monkeypatch.setenv("AKO_TPU_EVENTS", "group")
    assert not tile_events_mode(lambda *a: None)


# ---------------------------------------------------------------- streaming decode


def _iter_blob():
    img = corpus(37, 1, 72, 100, 3)[0]
    s = Settings(quantization=16, tiles_dimension=32)  # 32/4 px columns, 32/8 px rows
    return ako_tpu.encode(img, _ref_settings(s), device_entropy=False)


@pytest.mark.parametrize("max_batch", [1, 2, 32])
def test_decode_tiles_iter(max_batch):
    blob = _iter_blob()
    got = list(decode_tiles_iter(blob, max_batch, device="cpu"))
    ref = list(ref_decode_tiles_iter(blob, max_batch))
    assert [t.index for t, _ in got] == [t.index for t, _ in ref] == list(range(len(ref)))
    for (_, p), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(p, np.asarray(r))
    # the tiles assemble to decode's image
    image = ako_tpu_torch.decode(blob, device="cpu")[0]
    for t, p in got:
        np.testing.assert_array_equal(image[t.y : t.y + t.h, t.x : t.x + t.w], p)


@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_decode_tiles_iter_truncated(frac):
    """A truncated blob yields the tiles that fit, then raises AkoError."""
    blob = _iter_blob()
    broken = blob[: int(len(blob) * frac)]
    got, ref = [], []
    with pytest.raises(ako_tpu_torch.AkoError):
        for t, p in decode_tiles_iter(broken, 4, device="cpu"):
            got.append((t.index, p))
    with pytest.raises(ako_tpu.AkoError):
        for t, p in ref_decode_tiles_iter(broken, 4):
            ref.append((t.index, np.asarray(p)))
    assert [i for i, _ in got] == [i for i, _ in ref] and got
    for (_, p), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(p, r)


# ---------------------------------------------------------------- native per-tile functions


@pytest.mark.parametrize("color", [Color.YCOCG_Q, Color.YCOCG, Color.NONE])
@pytest.mark.parametrize("wavelet", [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR])
def test_hostcodec_per_tile(color, wavelet):
    tile = corpus(38, 1, 37, 29, 4)[0]
    ref_color = type(ako_tpu.Settings().color)(int(color))
    ref_wavelet = type(ako_tpu.Settings().wavelet)(int(wavelet))
    ref_wrap = type(ako_tpu.Settings().wrap)(int(Wrap.CLAMP))
    planes = hostcodec.u8_to_planes(tile, color, True)
    np.testing.assert_array_equal(planes, ref_hostcodec.u8_to_planes(tile, ref_color, True))
    qg = tile_qg(29, 37, 4, 16, 2, 1)
    stream = hostcodec.tile_lift(planes, wavelet, Wrap.CLAMP, qg)
    np.testing.assert_array_equal(stream, ref_hostcodec.tile_lift(planes, ref_wavelet, ref_wrap,
                                                                  qg))
    back = hostcodec.tile_unlift(stream, 29, 37, 4, wavelet, Wrap.CLAMP)
    np.testing.assert_array_equal(back, ref_hostcodec.tile_unlift(stream, 29, 37, 4, ref_wavelet,
                                                                  ref_wrap))
    np.testing.assert_array_equal(hostcodec.planes_to_u8(back, color),
                                  ref_hostcodec.planes_to_u8(back, ref_color))
    with pytest.raises(ako_tpu_torch.AkoError):
        hostcodec.tile_unlift(stream[:-1], 29, 37, 4, wavelet, Wrap.CLAMP)


# ---------------------------------------------------------------- utils


def test_traced_writes_a_trace_per_call(tmp_path, monkeypatch):
    monkeypatch.setenv("AKO_TPU_TRACE_DIR", str(tmp_path))
    img = corpus(39, 1, 24, 20, 3)[0]
    blob = ako_tpu_torch.encode(img, device="cpu")
    ako_tpu_torch.decode(blob, device="cpu")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert [f.split("-")[0] for f in files] == ["decode", "encode"]
    for f in files:
        trace = json.loads((tmp_path / f).read_text())
        assert trace["traceEvents"]
    # a call made while another is traced runs untraced
    assert tracing._trace_lock.acquire(blocking=False)
    try:
        ako_tpu_torch.encode(img, device="cpu")
    finally:
        tracing._trace_lock.release()
    assert len(list(tmp_path.iterdir())) == 2
    monkeypatch.delenv("AKO_TPU_TRACE_DIR")
    ako_tpu_torch.encode(img, device="cpu")
    assert len(list(tmp_path.iterdir())) == 2


@pytest.mark.parametrize("dev", ["", "0", "1"])
def test_dev_printf(dev, capsys, monkeypatch):
    monkeypatch.setenv("AKO_TPU_DEV", dev)
    outs = []
    for mod in (debug, ref_debug):
        mod.dev_printf("dec: %d/%d quirk", 3, 80)
        mod.dev_printf("plain")
        for tile in (0, 9, 10):
            mod.dev_tile_printf(tile, "tile %d", tile)
        outs.append(capsys.readouterr())
        assert mod.dev_enabled() == (dev == "1")
    assert outs[0] == outs[1]
    assert outs[0].out == ""
    assert (outs[0].err != "") == (dev == "1")


def test_save_pgm_i16(tmp_path):
    plane = np.random.default_rng(40).integers(-300, 600, size=(7, 11)).astype(np.int16)
    developer.save_pgm_i16(plane, str(tmp_path / "got.pgm"))
    ref_developer.save_pgm_i16(plane, str(tmp_path / "ref.pgm"))
    assert (tmp_path / "got.pgm").read_bytes() == (tmp_path / "ref.pgm").read_bytes()
    with pytest.raises(ValueError):
        developer.save_pgm_i16(np.zeros((2, 2, 2), np.int16), str(tmp_path / "bad.pgm"))
