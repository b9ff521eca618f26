"""Plain PyTorch reference of the Ako codec on the benchmark's settings.

Written from the codec's published behaviour (the reference C library's
head.c, format.c, lifting.c, wavelet-dd137.c, wavelet-cdf53.c,
quantization.c and kagari.c), in whole-tensor torch operations that run
on any device, and sharing no code with the program under test. It
covers what the benchmark's configurations state: DD 13/7 (with CDF 5/3
on levels under 8x8), the YCoCg colour transform (its x2-premultiplied
variant when lossy), CLAMP edges, Kagari coding and any tile size.
Anything else raises ValueError, so that a configuration this file does
not cover fails loudly instead of being judged by a wrong reference.

Integer semantics are C's: arithmetic in int32, every store to a
coefficient array through `store` (a wrap to int16, the codec's stated
precision), and division truncating toward zero. `store` is a
parameter so that the benchmark's control can run the same arithmetic
at the next precision down (int8) and show that the comparison fails it.

The encoder works in two steps, as a rate search wants: `raw_pyramid`
lifts every tile once without quantization (the LL path never sees the
quantizer, so the raw quadrants are the ones every q quantizes), and
`serialize` quantizes, gates and lays the coefficients out in wire
order. The decoder's expected pixels follow from the serialized streams
alone (dequantize, unlift, inverse colour), so no entropy decoder is
needed: a blob equal to the reference's codes those streams, and a
program that decodes it has to give these pixels.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np
import torch

#: enum values packed into the container flags (library/ako.h)
WAVELETS = {"DD137": 0, "CDF53": 1, "HAAR": 2, "NONE": 3}
COLORS = {"YCOCG": 0, "SUBTRACT_G": 1, "NONE": 2, "YCOCG_Q": 3}
WRAPS = {"CLAMP": 0, "MIRROR": 1, "REPEAT": 2, "ZERO": 3}
COMPRESSIONS = {"KAGARI": 0, "MANBAVARAN": 1, "NONE": 2}
FORMAT_VERSION = 2
HEAD = struct.Struct("<3sBIII")
BLOCK_HEAD = struct.Struct("<I")
#: Kagari cuts a run every FLUSH repeats (token FLUSH - 1)
FLUSH = 65534


def store16(x):
    """C's store of an int32 value to an int16 array."""
    return x.to(torch.int16).to(torch.int32)


def store8(x):
    """The control's store: the same at int8, the next precision down."""
    return x.to(torch.int8).to(torch.int32)


def tdiv(x, d: int):
    return torch.div(x, d, rounding_mode="trunc")


@dataclass(frozen=True)
class Settings:
    """A configuration file's `settings`, checked against what this
    reference covers."""

    wavelet: str
    color: str
    wrap: str
    compression: str
    tiles_dimension: int
    quantization: int
    gate: int
    chroma_loss: int
    discard_non_visible: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Settings":
        s = cls(**cfg)
        if s.wavelet != "DD137" or s.wrap != "CLAMP" or s.compression != "KAGARI":
            raise ValueError(f"reference covers DD137, CLAMP and KAGARI only: {cfg}")
        if s.color not in ("YCOCG", "YCOCG_Q") or s.discard_non_visible:
            raise ValueError(f"reference covers YCoCg without discard only: {cfg}")
        return s

    def at(self, q: int) -> "Settings":
        """The settings at quantization q, with the encoder's colour switch
        (encode.c:60-64): YCoCg becomes its x2-premultiplied variant when
        q or the gate is positive."""
        lossy = q > 0 or self.gate > 0
        return Settings(self.wavelet, "YCOCG_Q" if lossy else "YCOCG", self.wrap,
                        self.compression, self.tiles_dimension, q, self.gate, self.chroma_loss,
                        self.discard_non_visible)


# ------------------------------------------------------------------ geometry


def halve(v: int) -> int:
    return (v + 1) // 2


def levels_of(w: int, h: int) -> list:
    """[(current_w, current_h, target_w, target_h)] in encode order."""
    out = []
    while w > 2 and h > 2:
        out.append((w, h, halve(w), halve(h)))
        w, h = halve(w), halve(h)
    return out


def tile_bytes(w: int, h: int, channels: int) -> int:
    """Bytes of one tile's serialized stream: per level three quadrants
    and a 2-byte q head a channel, then the lowpass planes."""
    levels = levels_of(w, h)
    lw, lh = levels[-1][2:] if levels else (w, h)
    return (sum(tw * th * 2 * 3 + 2 for _, _, tw, th in levels) + lw * lh * 2) * channels


def tiles(width: int, height: int, td: int) -> list:
    """[(x, y, w, h)] row-major; border tiles are the remainders."""
    if td == 0:
        return [(0, 0, width, height)]
    return [(x, y, min(td, width - x), min(td, height - y))
            for y in range(0, height, td) for x in range(0, width, td)]


# ------------------------------------------------------------------ q curve


def _f(x: float) -> float:
    """Round a double to the nearest float32."""
    return float(np.float32(x))


def _curve(factor: float, tw: int, th: int, cw: int, ch: int) -> float:
    """The quantization/gate curve of quantization.c, every operation in
    float32 (each result rounded from the exact double one)."""
    root0 = _f(math.sqrt(_f(float(tw) * float(th))))
    root = _f(math.sqrt(_f(float(cw) * float(ch))))
    total = _f(_f(math.log2(root0)) - 1.0)
    cur = _f(_f(math.log2(root)) - 1.0)
    linear = _f(cur / total)
    degrade = _f(_f(math.pow(_f(linear + 1.0), 6.0)) / 64.0)
    base = _f(_f(math.pow(2.0, _f(cur - 1.0))) * degrade)
    x = _f(base * _f(factor / _f(512.0 * _f(0.73))))
    return math.floor(x + 0.5) if x >= 0 else -math.floor(-x + 0.5)


def _level_value(factor: int, mul: int, lo: float, tw: int, th: int, cw: int, ch: int) -> int:
    """The curve at factor x mul, clamped to [lo, 32765] as the codec's
    int16 store of it."""
    x = _curve(_f(float(factor) * float(mul)), tw, th, cw, ch)
    return int(min(max(x, lo), 32765.0))


def level_table(w: int, h: int, channels: int, s: Settings) -> list:
    """Per encode-order level, ([q per channel], [g per channel]): luma
    takes factor x1, every other channel x (chroma_loss + 1); q is 1 and
    g 0 where their factor is not positive."""
    out = []
    muls = [1] + [s.chroma_loss + 1] * (channels - 1)
    for cw, ch, _, _ in levels_of(w, h):
        qs = [1 if s.quantization <= 0 else
              _level_value(s.quantization, m, 1.0, w, h, cw, ch) for m in muls]
        gs = [0 if s.gate <= 0 else _level_value(s.gate, m, 0.0, w, h, cw, ch) for m in muls]
        out.append((qs, gs))
    return out


# ------------------------------------------------------------------ colour


def forward_colour(tiles_u8, color: str, store=store16):
    """(T, h, w, C) uint8 -> (T, C, h, w) int32 planes (int16 values)."""
    p = tiles_u8.permute(0, 3, 1, 2).to(torch.int32)
    if p.shape[1] < 3:
        return p
    r, g, b = p[:, 0], p[:, 1], p[:, 2]
    co = store(r - b)
    t = store(b + tdiv(co, 2))
    cg = store(g - t)
    y = store(t + tdiv(cg, 2))
    if color == "YCOCG_Q":
        y = store(y * 2)
    return torch.cat([torch.stack([y, co, cg], 1), p[:, 3:]], 1)


def inverse_colour(planes, color: str, store=store16):
    """(T, C, h, w) int32 planes -> (T, h, w, C) uint8, saturated."""
    p = planes
    if p.shape[1] >= 3:
        y, co, cg = p[:, 0], p[:, 1], p[:, 2]
        if color == "YCOCG_Q":
            y = store(tdiv(y, 2))
        t = store(y - tdiv(cg, 2))
        g = store(cg + t)
        b = store(t - tdiv(co, 2))
        r = store(b + co)
        p = torch.cat([torch.stack([r, g, b], 1), p[:, 3:]], 1)
    return p.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ lift


def _taps(x, dim: int):
    """tap(k) = x shifted by k along dim, CLAMP edges (index clamped)."""
    n = x.shape[dim]
    i = torch.arange(n, device=x.device)

    def tap(k: int):
        return x.index_select(dim, (i + k).clamp(0, n - 1))

    return tap


def _lift1d(x, dim: int, dd137: bool, store):
    """Split x along dim into even and odd samples (an odd length gets a
    fake last odd sample equal to the last even one), lift, and return
    (lowpass, highpass)."""
    n = x.shape[dim]
    ev = x.index_select(dim, torch.arange(0, n, 2, device=x.device))
    od = x.index_select(dim, torch.arange(1, n, 2, device=x.device))
    if n % 2:
        od = torch.cat([od, ev.narrow(dim, ev.shape[dim] - 1, 1)], dim)
    e = _taps(ev, dim)
    if dd137:
        hp = store(od + tdiv(e(-1) + e(2) - 9 * (ev + e(1)), 16))
        h = _taps(hp, dim)
        lp = store(ev + tdiv(-h(-2) - h(1) + 9 * (h(-1) + hp), 32))
    else:
        hp = store(od - tdiv(ev + e(1), 2))
        h = _taps(hp, dim)
        lp = store(ev + tdiv(h(-1) + hp, 4))
    return lp, hp


def _unlift1d(lp, hp, dim: int, out_len: int, dd137: bool, store):
    """Inverse of _lift1d: the evens and odds interleaved along dim,
    cut to out_len (the fake odd sample dropped)."""
    h = _taps(hp, dim)
    if dd137:
        ev = store(lp - tdiv(-h(-2) - h(1) + 9 * (h(-1) + hp), 32))
        e = _taps(ev, dim)
        od = store(hp - tdiv(e(-1) + e(2) - 9 * (ev + e(1)), 16))
    else:
        ev = store(lp - tdiv(h(-1) + hp, 4))
        e = _taps(ev, dim)
        od = store(hp + tdiv(ev + e(1), 2))
    both = torch.stack([ev, od], dim + 1).flatten(dim, dim + 1)
    return both.narrow(dim, 0, out_len)


def _dd137_at(tw: int, th: int, wavelet: str) -> bool:
    """DD 13/7 levels whose target is under 8x8 use CDF 5/3."""
    return wavelet == "DD137" and tw >= 8 and th >= 8


def lift2d(x, tw: int, th: int, wavelet: str, store=store16):
    """(..., h, w) planes -> (ll, b, c, d), each (..., th, tw): the rows
    first (an odd height gets its last row doubled), then the columns of
    both halves."""
    dd = _dd137_at(tw, th, wavelet)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., -1:, :]], -2)
    lo, hi = _lift1d(x, x.ndim - 1, dd, store)
    ll, c = _lift1d(lo, x.ndim - 2, dd, store)
    b, d = _lift1d(hi, x.ndim - 2, dd, store)
    return ll, b, c, d


def unlift2d(ll, b, c, d, cw: int, ch: int, wavelet: str, store=store16):
    tw, th = ll.shape[-1], ll.shape[-2]
    dd = _dd137_at(tw, th, wavelet)
    n = ll.ndim
    left = _unlift1d(ll, c, n - 2, 2 * th, dd, store)
    right = _unlift1d(b, d, n - 2, 2 * th, dd, store)
    out = _unlift1d(left, right, n - 1, cw, dd, store)
    return out[..., :ch, :]


# ------------------------------------------------------------------ streams


@dataclass
class Pyramid:
    """One tile-shape group's raw lift: the LP planes and, per level in
    encode order, its (c, b, d) quadrants, none quantized."""

    w: int
    h: int
    lp: torch.Tensor
    quads: list


def raw_pyramid(tiles_u8, s: Settings, store=store16) -> Pyramid:
    """(T, h, w, C) uint8 tiles of one shape -> their raw Pyramid."""
    h, w = tiles_u8.shape[1:3]
    cur = forward_colour(tiles_u8, s.color, store)
    quads = []
    for _, _, tw, th in levels_of(w, h):
        ll, b, c, d = lift2d(cur, tw, th, s.wavelet, store)
        quads.append((c, b, d))
        cur = ll
    return Pyramid(w, h, cur, quads)


def serialize(p: Pyramid, s: Settings, store=store16):
    """(T, n) int32 streams of int16 values in wire order: the LP planes,
    then per level smallest first and per channel [q head][C][B][D],
    each quadrant gated (|x| <= g -> 0) and divided by q."""
    T, C = p.lp.shape[:2]
    parts = [p.lp.reshape(T, -1)]
    table = level_table(p.w, p.h, C, s)
    for k in reversed(range(len(p.quads))):
        qs, gs = table[k]
        q = torch.tensor(qs, dtype=torch.int32, device=p.lp.device).view(1, C, 1, 1)
        g = torch.tensor(gs, dtype=torch.int32, device=p.lp.device).view(1, C, 1, 1)
        quant = [store(torch.where((x < -g) | (x > g), tdiv(x, q.clamp(min=1)), 0))
                 for x in p.quads[k]]
        head = q.view(1, C, 1).expand(T, C, 1)
        parts.append(torch.cat([head] + [x.flatten(2) for x in quant], 2).reshape(T, -1))
    return torch.cat(parts, 1)


def streams_to_tiles(streams, w: int, h: int, channels: int, color: str, wavelet: str,
                     store=store16):
    """(T, n) streams -> (T, h, w, C) uint8 tiles: each quadrant
    multiplied back by its level's q head (when over 1), the unlift
    largest level last, the inverse colour transform."""
    T = streams.shape[0]
    levels = levels_of(w, h)
    lw, lh = (levels[-1][2], levels[-1][3]) if levels else (w, h)
    at = channels * lw * lh
    cur = streams[:, :at].reshape(T, channels, lh, lw)
    for cw, ch, tw, th in reversed(levels):
        n = tw * th
        chunk = streams[:, at:at + channels * (1 + 3 * n)].reshape(T, channels, 1 + 3 * n)
        at += channels * (1 + 3 * n)
        q = chunk[:, :, :1].unsqueeze(-1)
        quads = chunk[:, :, 1:].reshape(T, channels, 3, th, tw)
        quads = torch.where(q.unsqueeze(2) > 1, store(quads * q.unsqueeze(2)), quads)
        c, b, d = quads[:, :, 0], quads[:, :, 1], quads[:, :, 2]
        cur = unlift2d(cur, b, c, d, cw, ch, wavelet, store)
    return inverse_colour(cur, color, store)


# ------------------------------------------------------------------ Kagari


def _tokens(streams):
    """Kagari's tokens of each row of (T, n) int16-valued streams:
    (values, row of each token). A value that differs from the one before
    it is a literal zigzag(v) + 1 (mod 2^16); a run of L repeats after it
    codes as literals while L < 2, else as two literals and a count token
    (repeats - 2) + 1, cut every FLUSH repeats."""
    T, n = streams.shape
    dev = streams.device
    flat = streams.reshape(-1)
    start = torch.ones(T * n, dtype=torch.bool, device=dev)
    start[1:] = flat[1:] != flat[:-1]
    start[::n] = True
    first = torch.nonzero(start).squeeze(1)
    length = torch.diff(first, append=torch.tensor([T * n], device=dev))
    v = flat[first] & 0xFFFF
    v = torch.where(v >= 32768, v - 65536, v)
    z = ((((v << 1) & 0xFFFF) ^ ((v >> 15) & 0xFFFF)) + 1) & 0xFFFF
    reps = length - 1
    full, rem = reps // FLUSH, reps % FLUSH
    count = 1 + 3 * full + torch.where(rem == 0, 0, torch.where(rem == 1, 1, 3))
    run = torch.repeat_interleave(torch.arange(len(first), device=dev), count)
    offset = torch.cumsum(count, 0) - count
    j = torch.arange(len(run), device=dev) - offset[run] - 1
    block, pos = torch.div(j, 3, rounding_mode="floor"), torch.remainder(j, 3)
    tok = torch.where(block < full[run], FLUSH - 1, rem[run] - 1)
    values = torch.where((j >= 0) & (pos == 2), tok, z[run])
    return values, first[run] // n


def _gamma_bits(v):
    """Elias-gamma code length of v (0 and 1 take one bit)."""
    floor_log2 = sum((v >= (1 << b)).to(torch.int64) for b in range(1, 16))
    return 2 * floor_log2 + 1


def payload_bits(streams):
    """(T,) bits of each row's Kagari payload."""
    values, row = _tokens(streams)
    bits = torch.zeros(streams.shape[0], dtype=torch.int64, device=streams.device)
    return bits.index_add_(0, row, _gamma_bits(values))


def kagari_payloads(streams) -> list:
    """Each row's Kagari payload: the gamma codes MSB first, each row's
    last byte zero-padded."""
    values, row = _tokens(streams)
    nbits = _gamma_bits(values)
    T = streams.shape[0]
    bits = torch.zeros(T, dtype=torch.int64, device=streams.device).index_add_(0, row, nbits)
    nbytes = (bits + 7) // 8
    row_bit0 = 8 * (torch.cumsum(nbytes, 0) - nbytes)
    pos = row_bit0[row] + torch.cumsum(nbits, 0) - nbits - (
        torch.cumsum(bits, 0) - bits)[row]
    out = torch.zeros(int(nbytes.sum()) * 8, dtype=torch.uint8, device=streams.device)
    for b in range(16):
        on = ((values >> b) & 1).bool()
        out[pos[on] + nbits[on] - 1 - b] = 1
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=streams.device)
    packed = (out.view(-1, 8).to(torch.int32) * weights).sum(1).to(torch.uint8).cpu().numpy()
    cuts = np.concatenate([[0], np.cumsum(nbytes.cpu().numpy())])
    return [packed[a:b].tobytes() for a, b in zip(cuts[:-1], cuts[1:])]


# ------------------------------------------------------------------ container


def head(width: int, height: int, channels: int, s: Settings) -> bytes:
    td = s.tiles_dimension
    field = 0 if td == 0 else int(math.log2(td)) - 2
    flags = (channels - 1) | WRAPS[s.wrap] << 4 | WAVELETS[s.wavelet] << 6
    flags |= COLORS[s.color] << 8 | COMPRESSIONS[s.compression] << 10 | field << 12
    return HEAD.pack(b"Ako", FORMAT_VERSION, width, height, flags)


class ReferenceLimit(ValueError):
    """A tile whose payload comes near its capacity: the codec's exact
    failure bound there is the entropy coder's, which this reference does
    not model. The benchmark's traffic never comes near it."""


class Encoder:
    """One image, encoded at any q from its raw pyramids (one lift per
    colour variant), as a rate search probes it."""

    def __init__(self, image_u8, settings: Settings, store=store16):
        self.image = image_u8
        self.base = settings
        self.store = store
        self.h, self.w, self.channels = image_u8.shape
        self._pyramids: dict = {}

    def groups(self, s: Settings) -> list:
        """[(tile rects, Pyramid)] per tile shape, in first-seen order."""
        if s.color not in self._pyramids:
            by_shape: dict = {}
            for rect in tiles(self.w, self.h, s.tiles_dimension):
                by_shape.setdefault(rect[2:], []).append(rect)
            out = []
            for (w, h), rects in by_shape.items():
                batch = torch.stack([self.image[y:y + h, x:x + w] for x, y, _, _ in rects])
                out.append((rects, raw_pyramid(batch, s, self.store)))
            self._pyramids[s.color] = out
        return self._pyramids[s.color]

    def streams(self, q: int) -> list:
        """[(tile rects, (T, n) streams)] at quantization q."""
        s = self.base.at(q)
        return [(rects, serialize(p, s, self.store)) for rects, p in self.groups(s)]

    def _capacity(self, rects) -> int:
        return tile_bytes(rects[0][2], rects[0][3], self.channels) - BLOCK_HEAD.size

    def size_at(self, q: int) -> int:
        """Blob bytes at q: the head, and a block head and payload a tile."""
        total = HEAD.size
        for rects, st in self.streams(q):
            nbytes = (payload_bits(st) + 7) // 8
            if int(nbytes.max()) + 16 >= self._capacity(rects):
                raise ReferenceLimit("payload near its tile's capacity")
            total += int(nbytes.sum()) + BLOCK_HEAD.size * len(rects)
        return total

    def blob_at(self, q: int) -> bytes:
        s = self.base.at(q)
        order = {r: i for i, r in enumerate(tiles(self.w, self.h, s.tiles_dimension))}
        blocks: list = [b""] * len(order)
        for rects, st in self.streams(q):
            cap = self._capacity(rects)
            for rect, payload in zip(rects, kagari_payloads(st)):
                if len(payload) + 16 >= cap:
                    raise ReferenceLimit("payload near its tile's capacity")
                blocks[order[rect]] = BLOCK_HEAD.pack(len(payload)) + payload
        return head(self.w, self.h, self.channels, s) + b"".join(blocks)

    def pixels_at(self, q: int):
        """(h, w, C) uint8 image that decoding blob_at(q) gives."""
        s = self.base.at(q)
        out = torch.empty_like(self.image)
        for rects, st in self.streams(q):
            w, h = rects[0][2], rects[0][3]
            px = streams_to_tiles(st, w, h, self.channels, s.color, s.wavelet, self.store)
            for (x, y, _, _), tile in zip(rects, px):
                out[y:y + h, x:x + w] = tile
        return out


def encode_with_ratio(enc: Encoder, ratio: int) -> tuple:
    """(q, blob) of the reference encoder's rate search (tools/akoenc.cpp
    EncodePass) for ratio > 1: target (w h c) / ratio bytes with a 4%
    margin; a q=0 ceiling, a x4 descent to a floor under the target, then
    bisection while the bracket is wider than the margin and its q's more
    than 1 apart; the endpoint nearer the target wins. The blob is the
    last probe's when its size equals the winner's (the reference reuses
    its buffer), else the winner's."""
    target = enc.w * enc.h * enc.channels // ratio
    margin = target * 4 // 100
    last_q, last = 0, enc.size_at(0)
    floor_q, floor = 0, last
    q = 1
    while True:
        q *= 4
        ceil_q, ceil = floor_q, floor
        floor_q, floor = q, enc.size_at(q)
        last_q, last = floor_q, floor
        if floor <= target:
            break
    while abs(floor - ceil) > margin and abs(floor_q - ceil_q) > 1:
        q = (ceil_q + floor_q) // 2
        last_q, last = q, enc.size_at(q)
        if last > target:
            ceil_q, ceil = q, last
        else:
            floor_q, floor = q, last
    if abs(floor - target) < abs(ceil - target):
        chosen, size = floor_q, floor
    else:
        chosen, size = ceil_q, ceil
    return chosen, enc.blob_at(last_q if last == size else chosen)
