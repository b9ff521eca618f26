"""ako_tpu_torch's pyramid route (ops/lifting.py forward_tiles /
inverse_tiles, with the plain versions of the lift_pyramid /
unlift_pyramid kernels of ops/lift_kernels.py) against ako_tpu under JAX
on the CPU: colorspace.to_planar_yuv + lifting.forward_tile, and
lifting.inverse_tile + colorspace.to_interleaved_u8. Every start level
of the pyramid is run through lift_kernels (levels before it per level,
the rest through the pyramid wrapper's plain version), so a wrong offset
or q/g table shows. Inputs come from numpy seeds; every comparison is
exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.core.settings import Color as RefColor
from ako_tpu.ops import colorspace as ref_colorspace
from ako_tpu.ops import lifting as ref_lifting
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels, lifting, quantization
from ako_tpu_torch.ops.colorspace import to_interleaved_u8, to_planar_yuv

# (w, h, channels, wavelet, wrap, colour, discard_non_visible, q, gate,
# chroma_loss): every wavelet, wrap and colour, 1-4 channels, q 0 / 1 /
# 16, gates and chroma losses above 0, zero alphas under discard, and
# tiles with fewer rows than channels (an image's edge row of tiles)
CASES = [
    (128, 128, 4, Wavelet.DD137, Wrap.CLAMP, Color.YCOCG_Q, False, 16, 0, 1),
    (127, 97, 3, Wavelet.DD137, Wrap.MIRROR, Color.YCOCG, False, 0, 0, 1),
    (33, 17, 4, Wavelet.CDF53, Wrap.REPEAT, Color.SUBTRACT_G, True, 1, 3, 2),
    (5, 9, 2, Wavelet.HAAR, Wrap.ZERO, Color.NONE, True, 16, 5, 1),
    (2, 2, 4, Wavelet.DD137, Wrap.CLAMP, Color.YCOCG_Q, False, 16, 0, 1),
    (33, 17, 1, Wavelet.HAAR, Wrap.MIRROR, Color.YCOCG_Q, False, 16, 2, 0),
    (127, 97, 4, Wavelet.CDF53, Wrap.ZERO, Color.SUBTRACT_G, True, 16, 1, 3),
    (5, 9, 3, Wavelet.DD137, Wrap.REPEAT, Color.NONE, False, 1, 0, 1),
    (128, 3, 4, Wavelet.DD137, Wrap.CLAMP, Color.YCOCG_Q, True, 16, 2, 1),
    (128, 1, 3, Wavelet.CDF53, Wrap.MIRROR, Color.YCOCG, False, 16, 0, 1),
]
IDS = [f"{w}x{h}x{c}-{wav.name}-{wr.name}-{col.name}" for w, h, c, wav, wr, col, *_ in CASES]
TILES = 2


def _tiles(w, h, ch, discard, seed):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, size=(TILES, h, w, ch)).astype(np.uint8)
    if discard:
        tiles[..., -1][rng.random((TILES, h, w)) < 0.3] = 0
    return tiles


def _forward_from(tiles, schedule, start, wavelet, wrap, qg, color, discard):
    """The streams with levels [0, start) per level and the rest through
    forward_pyramid, as forward_tiles wires them at its pyramid_start."""
    stream = torch.empty((tiles.shape[0], schedule.coeff_count(tiles.shape[-1])),
                         dtype=torch.int16)
    x = tiles
    if start:
        planes = to_planar_yuv(tiles, color, discard).contiguous()
        x = lift_kernels.lift_levels(planes, stream, schedule, range(start), wavelet, wrap, qg,
                                     lift_kernels.lift2d_level)
    lift_kernels.forward_pyramid(x, stream, schedule, start, wavelet, wrap, qg, color, discard)
    return stream


def _inverse_from(coeffs, schedule, start, wavelet, wrap, ch, color):
    """The tiles with the levels from `start` through inverse_pyramid and
    the rest per level, as inverse_tiles wires them at its pyramid_start."""
    out = lift_kernels.inverse_pyramid(coeffs, schedule, start, wavelet, wrap, ch, color)
    if not start:
        return out
    planes = lift_kernels.unlift_levels(out, coeffs, schedule, range(start), wavelet, wrap,
                                        lift_kernels.unlift2d_level)
    return to_interleaved_u8(planes, color, ch)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_tiles_vs_ako_tpu(case):
    w, h, ch, wavelet, wrap, color, discard, q, gate, chroma = case
    tiles = _tiles(w, h, ch, discard, 10 * w + h + ch)
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, q, gate, chroma)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(jax.jit(lambda t: ref_lifting.forward_tile(
        ref_colorspace.to_planar_yuv(t, RefColor(color), discard), ref_sched, wavelet, wrap, qg,
        False))(jnp.asarray(tiles)))

    before = dict(lift_kernels.LAUNCHES)
    x = torch.from_numpy(tiles)
    for start in range(len(schedule.levels) + 1):
        got = _forward_from(x, schedule, start, wavelet, wrap, qg, color, discard)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"start level {start}")
    per_level = lifting.forward_tile(to_planar_yuv(x, color, discard).contiguous(), schedule,
                                     wavelet, wrap, qg)
    np.testing.assert_array_equal(per_level.numpy(), ref, err_msg="every level per level")
    route = lifting.forward_tiles(x, schedule, wavelet, wrap, qg, color, discard)
    np.testing.assert_array_equal(route.numpy(), ref, err_msg="forward_tiles")
    # CPU tensors take the plain versions: no kernel launch counted
    assert lift_kernels.LAUNCHES == before


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_inverse_tiles_vs_ako_tpu(case):
    """The encoded streams, and random streams with q heads of 0, 1 and
    above 1 whose dequantize multiply wraps."""
    w, h, ch, wavelet, wrap, color, discard, q, gate, chroma = case
    tiles = torch.from_numpy(_tiles(w, h, ch, discard, 20 * w + h + ch))
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, q, gate, chroma)
    encoded = lifting.forward_tiles(tiles, schedule, wavelet, wrap, qg, color, discard).numpy()
    rng = np.random.default_rng(30 * w + h)
    noise = rng.integers(-32768, 32768, size=encoded.shape).astype(np.int16)
    for k, off in enumerate(lift_kernels.level_offsets(schedule, ch)):
        lvl = schedule.levels[k]
        n = 1 + 3 * lvl.target_h * lvl.target_w
        noise[:, off : off + ch * n : n] = rng.choice([0, 1, 7, 300, -5], size=(TILES, ch))

    ref_sched = ref_geometry.lift_schedule(w, h)
    ref_fn = jax.jit(lambda c: ref_colorspace.to_interleaved_u8(
        ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, False), RefColor(color), ch))
    for stream in (encoded, noise):
        ref = np.asarray(ref_fn(jnp.asarray(stream)))
        c = torch.from_numpy(stream)
        for start in range(len(schedule.levels) + 1):
            got = _inverse_from(c, schedule, start, wavelet, wrap, ch, color)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"start level {start}")
        per_level = to_interleaved_u8(lifting.inverse_tile(c, schedule, wavelet, wrap, ch), color,
                                      ch)
        np.testing.assert_array_equal(per_level.numpy(), ref, err_msg="every level per level")
        route = lifting.inverse_tiles(c, schedule, wavelet, wrap, ch, color)
        np.testing.assert_array_equal(route.numpy(), ref, err_msg="inverse_tiles")


@pytest.mark.parametrize(
    "w,h,ch,want",
    [(128, 128, 4, 0), (1024, 1280, 4, 3), (128, 128, 8, 0), (128, 128, 9, None),
     (100000, 2, 4, None), (97, 127, 3, 0), (256, 256, 3, 1)],
)
def test_pyramid_start(w, h, ch, want):
    """The first level both kernels hold in a block's shared-memory
    budget: the north star's 128-px tiles from level 0, the default whole
    1024x1280 (w x h) tile from level 3 (128x160); none for a tile whose
    LP planes alone do not fit, or with more channels than a cluster."""
    schedule = geometry.lift_schedule(w, h)
    start = lift_kernels.pyramid_start(schedule, ch)
    assert start == want
    if start is not None:
        assert max(lift_kernels.pyramid_smem(schedule, ch, start)) <= lift_kernels.SMEM_BYTES
    if start:
        assert max(lift_kernels.pyramid_smem(schedule, ch, start - 1)) > lift_kernels.SMEM_BYTES


def test_level_offsets_cover_the_stream():
    """Chunks tile the stream from the LP planes to its end, in wire
    order (smallest level first)."""
    w, h, ch = 97, 33, 3
    schedule = geometry.lift_schedule(w, h)
    offs = lift_kernels.level_offsets(schedule, ch)
    ends = [off + ch * (1 + 3 * lvl.target_h * lvl.target_w)
            for off, lvl in zip(offs, schedule.levels)]
    assert offs[-1] == ch * schedule.lp_h * schedule.lp_w
    assert list(offs[:-1]) == ends[1:]
    assert ends[0] == schedule.coeff_count(ch)


def test_pyramid_wrappers_reject_devices_without_kernel():
    schedule = geometry.lift_schedule(16, 16)
    tiles = torch.zeros((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    stream = torch.zeros((1, schedule.coeff_count(3)), dtype=torch.int16, device="meta")
    qg = [((1, 1, 1), (0, 0, 0))] * len(schedule.levels)
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.forward_pyramid(tiles, stream, schedule, 0, Wavelet.DD137, Wrap.CLAMP, qg,
                                     Color.YCOCG_Q, False)
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.inverse_pyramid(stream, schedule, 0, Wavelet.DD137, Wrap.CLAMP, 3,
                                     Color.YCOCG_Q)


def test_pyramid_args_table():
    """The kernel's table for the default whole tile from level 3: the
    launch's plane, the effective wavelets (DD 13/7 -> CDF 5/3 below
    8x8), the chunk offsets and the q/g of each level and channel."""
    w, h, ch = 1024, 1280, 4
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, 16, 2, 1)
    a = lift_kernels._pyramid_args(schedule, ch, 3, Wavelet.DD137, Wrap.CLAMP, tuple(qg),
                                   Color.YCOCG_Q, False)
    assert (a.levels, a.height, a.width, a.u8) == (len(schedule.levels) - 3, 160, 128, 0)
    assert (a.rows, a.pitch) == lift_kernels.smem_plane(schedule, 3)
    offs = lift_kernels.level_offsets(schedule, ch)
    for s, lvl in enumerate(schedule.levels[3:]):
        small = lvl.target_w < 8 or lvl.target_h < 8
        assert a.wavelet[s] == (Wavelet.CDF53 if small else Wavelet.DD137)
        assert a.off[s] == offs[3 + s]
        assert tuple(a.q[s][:ch]) == qg[3 + s][0]
        assert tuple(a.g[s][:ch]) == qg[3 + s][1]
