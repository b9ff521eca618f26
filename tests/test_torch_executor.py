"""The port's streaming executor (ako_tpu_torch/runtime/executor.py) on
the CPU against ako_tpu under JAX on the CPU: every blob of
PipelineEncoder byte-equal to ako_tpu.encode's and to ako_tpu's own
PipelineEncoder's (the host-entropy path, ako_tpu's CPU default), and
every image of PipelineDecoder and roundtrip_iter bit-equal to
ako_tpu.decode's, on each of the executor's routes: device entropy (the
plain K3/K4/K6 on the CPU, through the executor's slots and their host
buffers), host entropy, and the native span modes AKO_TPU_ENCODE=host and
AKO_TPU_DECODE=host. Also the span plans against ako_tpu's, the
MANBAVARAN dispatch/collect split, roundtrip_iter's order, early exit and
error propagation, and the locks the executor's two launching threads
need. Images from numpy seeds (utils/corpus.py)."""

import contextlib
import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ako_tpu
import ako_tpu_torch
from ako_tpu.decode import _host_decode_plan as ref_host_decode_plan
from ako_tpu.encode import _host_span_plan as ref_host_span_plan
from ako_tpu.runtime.executor import PipelineEncoder as RefPipelineEncoder
from ako_tpu_torch import AkoError, Color, Compression, Settings, Wavelet
from ako_tpu_torch.core import container
from ako_tpu_torch.decode import host_decode_plan
from ako_tpu_torch.encode import (
    checked_settings,
    collect_tiles_manba,
    dispatch_tiles_manba,
    encode_tiles_blocks_manba,
    host_span_plan,
)
from ako_tpu_torch.ops import kagari_device as kd
from ako_tpu_torch.runtime import kernels
from ako_tpu_torch.runtime.executor import PipelineDecoder, PipelineEncoder, Slot, roundtrip_iter
from ako_tpu_torch.utils import metrics
from ako_tpu_torch.utils.corpus import corpus
from tests.test_torch_entropy import _noise_tile, _ref_settings

CPU = torch.device("cpu")


def _const_alpha(seed):
    images = corpus(seed, 3, 40, 32, 4)
    for img in images:
        img[..., 3] = 255
    return images


# (images, settings, AKO_TPU_MANBAVARAN): 40x32 at 16-px tiles has two
# shape groups (16x16 and the 16x8 border row); few shapes, since the JAX
# programs compile per shape
CASES = {
    "rgb_t16": (lambda: corpus(51, 3, 40, 32, 3), Settings(quantization=16, tiles_dimension=16),
                False),
    "rgba_const_alpha_t16": (lambda: _const_alpha(52),
                             Settings(quantization=16, tiles_dimension=16), False),
    "lossless_t16": (lambda: corpus(53, 3, 40, 32, 3),
                     Settings(quantization=0, gate=0, tiles_dimension=16), False),
    "raw_none_t16": (lambda: corpus(54, 2, 40, 32, 1),
                     Settings(quantization=0, tiles_dimension=16, compression=Compression.NONE,
                              color=Color.NONE), False),
    "manba_t16": (lambda: corpus(55, 3, 40, 32, 3),
                  Settings(quantization=16, tiles_dimension=16,
                           compression=Compression.MANBAVARAN), True),
    # one 64x64 tile of noise past K3's budget: the host coder's fallback
    "noise_fallback_t64": (lambda: [_noise_tile()], Settings(quantization=16, tiles_dimension=64),
                           False),
}

_REFS: dict = {}


@contextlib.contextmanager
def _manba(on: bool):
    old = os.environ.get("AKO_TPU_MANBAVARAN")
    os.environ["AKO_TPU_MANBAVARAN"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["AKO_TPU_MANBAVARAN"]
        else:
            os.environ["AKO_TPU_MANBAVARAN"] = old


def _reference(name):
    """(images, blobs, pixels) from ako_tpu under JAX (once per case): the
    blobs of ako_tpu.encode, which ako_tpu's PipelineEncoder must give
    too, and the pixels of ako_tpu.decode."""
    if name not in _REFS:
        make, s, manba = CASES[name]
        images = make()
        rs = _ref_settings(s)
        with _manba(manba):
            blobs = [ako_tpu.encode(img, rs) for img in images]
            assert RefPipelineEncoder(rs, workers=2).encode_batch(images) == blobs
            pixels = [ako_tpu.decode(blob)[0] for blob in blobs]
        _REFS[name] = (images, blobs, pixels)
    return _REFS[name]


ROUTES = ("device_entropy", "host_entropy", "host_mode")


def _route_env(monkeypatch, route, var):
    if route == "host_mode":
        monkeypatch.setenv(var, "host")
    else:
        monkeypatch.delenv(var, raising=False)
    return route == "device_entropy"


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(CASES))
def test_encoder_blobs(monkeypatch, name, route):
    images, blobs, _ = _reference(name)
    s, manba = CASES[name][1:]
    device_entropy = _route_env(monkeypatch, route, "AKO_TPU_ENCODE")
    metrics.reset()
    with _manba(manba):
        got = PipelineEncoder(s, workers=2, device_entropy=device_entropy,
                              device="cpu").encode_batch(images)
    assert got == blobs
    if route == "device_entropy" and s.compression != Compression.NONE:
        fallback = 1 if name == "noise_fallback_t64" else 0
        tiles = sum(map(len, _grids(images, s)))
        assert metrics.fallback_summary()[metrics.ENC_HOST_FALLBACK] == fallback
        assert metrics.fallback_summary()[metrics.ENC_DEVICE] == tiles - fallback


def _grids(images, s):
    from ako_tpu_torch.core import geometry

    return [geometry.tile_grid(img.shape[1], img.shape[0], s.tiles_dimension) for img in images]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(CASES))
def test_decoder_pixels(monkeypatch, name, route):
    _, blobs, pixels = _reference(name)
    manba = CASES[name][2]
    device_entropy = _route_env(monkeypatch, route, "AKO_TPU_DECODE")
    with _manba(manba):
        got = list(PipelineDecoder(workers=2, device="cpu").decode_iter(
            blobs, device_entropy=device_entropy))
    assert len(got) == len(pixels)
    for g, want in zip(got, pixels):
        np.testing.assert_array_equal(g, want)


def test_lossless_roundtrip_is_the_input():
    images, blobs, _ = _reference("lossless_t16")
    for img, (blob, pix) in zip(images, roundtrip_iter(images, CASES["lossless_t16"][1],
                                                       workers=2, device="cpu")):
        np.testing.assert_array_equal(pix, img)


def test_decoder_quirk_tiles_on_the_host(monkeypatch):
    """Tiles whose sync scan reports codes over 31 bits decode on the host
    and go up through the slot's buffer; the pixels stay exact."""
    port_decode = importlib.import_module("ako_tpu_torch.decode")
    orig = port_decode.kagari_sync

    def flagged(*a, **k):
        r = orig(*a, **k)
        return None if r is None else (*r[:5], 33)

    monkeypatch.setattr(port_decode, "kagari_sync", flagged)
    _, blobs, pixels = _reference("rgb_t16")
    metrics.reset()
    got = list(PipelineDecoder(workers=2, device="cpu").decode_iter(blobs, device_entropy=True))
    for g, want in zip(got, pixels):
        np.testing.assert_array_equal(g, want)
    assert metrics.fallback_summary()[metrics.DEC_HOST_FALLBACK] == 6 * len(blobs)


# ------------------------------------------------------------ roundtrip_iter


@pytest.mark.parametrize("device_entropy", (False, True))
def test_roundtrip_iter_in_order(device_entropy):
    images, blobs, pixels = _reference("rgba_const_alpha_t16")
    s = CASES["rgba_const_alpha_t16"][1]
    got = list(roundtrip_iter(images, s, workers=2, depth=2, device_entropy=device_entropy,
                              device="cpu"))
    assert [b for b, _ in got] == blobs
    for (_, pix), want in zip(got, pixels):
        np.testing.assert_array_equal(pix, want)


def test_keep_residue_pairs():
    """encode_iter(keep_residue=True) yields (blob, None), and
    decode_iter(paired=True) takes such pairs, as ako_tpu's API."""
    images, blobs, pixels = _reference("rgb_t16")
    s = CASES["rgb_t16"][1]
    pairs = list(PipelineEncoder(s, device_entropy=True, device="cpu").encode_iter(
        images, keep_residue=True))
    assert pairs == [(b, None) for b in blobs]
    got = list(PipelineDecoder(device="cpu").decode_iter(pairs, paired=True, device_entropy=True))
    for g, want in zip(got, pixels):
        np.testing.assert_array_equal(g, want)


def test_roundtrip_iter_early_exit_bounded():
    """A consumer that stops early stops the encoder: only the images in
    flight are pulled from an endless input, and close() returns."""
    img = corpus(56, 1, 24, 24, 3)[0]
    pulled = 0

    def stream():
        nonlocal pulled
        while True:
            pulled += 1
            yield img

    it = roundtrip_iter(stream(), Settings(quantization=16), workers=2, depth=1, device="cpu")
    blob, pix = next(it)
    assert blob == ako_tpu_torch.encode(img, Settings(quantization=16), device="cpu")
    it.close()
    # the encoder's slots, the queue and the decoder's bound the pulls
    assert pulled < 12, pulled
    assert not [t for t in threading.enumerate() if t.name == "ako-roundtrip-encoder"]


def test_roundtrip_iter_propagates_encoder_error():
    """An image the encoder refuses raises in the stream's order: the
    images before it come out first, then the error."""
    images, blobs, _ = _reference("rgb_t16")
    s = CASES["rgb_t16"][1]
    bad = np.zeros((0, 4, 3), np.uint8)  # no pixels: the container refuses it
    got = []
    with pytest.raises(AkoError):
        for pair in roundtrip_iter([*images, bad], s, workers=2, depth=2, device="cpu"):
            got.append(pair[0])
    assert got == blobs[: len(got)] and len(got) >= 1
    with pytest.raises(AkoError):
        list(roundtrip_iter([bad], Settings(), device="cpu"))


def test_no_card_raises(monkeypatch):
    """device=None means the CUDA card: without one every entry point
    raises, with no quiet CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineDecoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(roundtrip_iter([np.zeros((8, 8, 3), np.uint8)]))


# ------------------------------------------------------------- span plans


@pytest.mark.parametrize("w, h, ch, t, wavelet, q, gate, chroma", [
    (32, 40, 3, 16, Wavelet.DD137, 16, 0, 0),
    (1024, 1280, 4, 128, Wavelet.DD137, 16, 0, 0),
    (37, 23, 4, 16, Wavelet.CDF53, 24, 3, 1),
    (40, 36, 1, 0, Wavelet.DD137, 0, 0, 0),
    (32, 32, 3, 16, Wavelet.NONE, 16, 0, 0),
])
def test_span_plans_equal_ako_tpus(w, h, ch, t, wavelet, q, gate, chroma):
    ref_wavelet = ako_tpu.Wavelet(int(wavelet))
    got = host_span_plan(w, h, ch, t, wavelet, q, gate, chroma)
    want = ref_host_span_plan(w, h, ch, t, ref_wavelet, q, gate, chroma)
    assert got.total_bytes == want.total_bytes
    for name in got._fields[:-1]:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and not a.flags.writeable, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    got_d = host_decode_plan(w, h, ch, t, wavelet)
    want_d = ref_host_decode_plan(w, h, ch, t, ref_wavelet)
    for name in got_d._fields:
        a, b = getattr(got_d, name), getattr(want_d, name)
        assert a.dtype == b.dtype and not a.flags.writeable, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_span_calls_check_their_arrays():
    """The span calls read through raw pointers: wrong dtypes and rects
    outside the image raise before the C call."""
    from ako_tpu_torch.runtime import hostcodec

    img = corpus(57, 1, 32, 32, 3)[0]
    s = checked_settings(Settings(quantization=16, tiles_dimension=16))
    plan = host_span_plan(32, 32, 3, 16, s.wavelet, s.quantization, s.gate, s.chroma_loss)
    out = np.empty(plan.total_bytes, np.uint8)
    sizes = np.zeros(4, np.int64)
    args = (plan.qg_off, plan.qs, plan.gs, plan.counts, plan.caps, out, plan.out_off, sizes,
            s.wavelet, s.wrap, s.color)
    with pytest.raises(ValueError, match="rects"):
        hostcodec.tile_encode_spans(img, plan.rects.astype(np.int64), *args)
    with pytest.raises(ValueError, match="outside"):
        hostcodec.tile_encode_spans(img[:16], plan.rects, *args)
    hostcodec.tile_encode_spans(img, plan.rects, *args)
    assert sizes.all()


# --------------------------------------------- the MANBAVARAN encode split


@pytest.mark.parametrize("slot", (False, True))
def test_manba_split_equals_the_one_shot(monkeypatch, slot):
    """dispatch_tiles_manba then collect_tiles_manba (plain, and through
    a CPU slot's buffers) give encode_tiles_blocks_manba's blocks, which
    frame ako_tpu's blobs; both shape groups."""
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    images, blobs, _ = _reference("manba_t16")
    s = checked_settings(CASES["manba_t16"][1])
    host = Slot(CPU) if slot else None
    for img, blob in zip(images, blobs):
        grid, dispatched = dispatch_tiles_manba(img, s, CPU, host)
        assert len(dispatched) == 2
        blocks = collect_tiles_manba(grid, dispatched, s, host)
        assert blocks == encode_tiles_blocks_manba(img, s, CPU)
        head = container.head_write(img.shape[2], img.shape[1], img.shape[0], s)
        assert head + b"".join(blocks) == blob


def test_slot_buffers_reused_and_grown():
    slot = Slot(CPU)
    a = slot.buffer("k", (4, 5), torch.int32)
    assert slot.buffer("k", (2, 10), torch.int32).data_ptr() == a.data_ptr()
    assert slot.buffer("k", (25,), torch.int32).data_ptr() == a.data_ptr()  # the quarter's room
    b = slot.buffer("k", (26,), torch.int32)
    assert b.numel() == 26 and b.data_ptr() != a.data_ptr()
    t = torch.arange(6, dtype=torch.int16).view(2, 3)
    up = slot.upload("u", t, CPU)
    assert torch.equal(up, t) and torch.equal(slot.download("d", up), t)
    slot.record(), slot.wait(), slot.sync()  # no stream on the CPU: nothing to wait for


# -------------------------------------------------- locks of the launch path


def _hammer(fn, threads: int = 32):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=fn) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)


def test_launch_counts_exact_across_threads():
    counts = {"x": 0}

    def bump():
        for _ in range(2000):
            kernels.count_launch(counts, "x")

    _hammer(bump)
    assert counts["x"] == 32 * 2000


def test_k3_epochs_distinct_across_threads():
    """Every call on one (device, stream) takes its own epoch, as the K3
    wrapper takes it (under the scratch lock)."""
    dev, stream = CPU, 11
    epochs = []

    def take():
        for _ in range(200):
            with kd._SCRATCH_LOCK:
                epochs.append(kd.encode_scratch(dev, stream, 2, 2)[3])

    try:
        _hammer(take)
    finally:
        kd._SCRATCH.pop((dev.index, stream), None)
    assert sorted(epochs) == list(range(1, 32 * 200 + 1))
