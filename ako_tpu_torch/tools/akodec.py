"""akodec: .ako -> PNG.

The counterpart of ako_tpu/tools/akodec.py, a behavioral rebuild of
reference tools/akodec.cpp:253-343 — flags -i -o -e (PNG effort) -b -ch
-quiet -version; the PNG is written by pngout.py. It decodes on the CUDA
card (`main(device=None)`; raises without one) unless the caller passes
device="cpu".

    python -m ako_tpu_torch.tools.akodec -i in.ako -o out.png"""

from __future__ import annotations

import sys

import numpy as np

import ako_tpu_torch
from ako_tpu_torch.core.events import EventsData
from ako_tpu_torch.tools.misc import adler32, read_blob
from ako_tpu_torch.tools.options import OptionsManager, OptionError


def build_options() -> OptionsManager:
    om = OptionsManager("akodec", "Ako TPU decoding tool")
    om.add_string("-i", "", None, "Input/output", "input .ako filename", "--input")
    om.add_string("-o", "", None, "Input/output", "output PNG filename", "--output")
    om.add_int("-e", 7, 1, 10, "Encoding", "PNG effort 1-10", "--effort")
    om.add_bool("-b", "Extra", "benchmark (per-stage timings)", "--benchmark")
    om.add_bool("-ch", "Extra", "print output Adler32 checksum", "--checksum")
    om.add_bool("-quiet", "Extra", "no output except errors", "--quiet")
    om.add_bool("-v", "Extra", "print version and exit", "--version")
    om.add_bool("-h", "Extra", "print this help", "--help")
    return om


def save_png(path: str, image: np.ndarray, effort: int) -> None:
    # effort 1-10 -> zlib level/strategy + per-row filter strategy,
    # the reference's ZLIB_PRESET/PNG_FILTER_PRESET semantics
    # (tools/akodec.cpp:44-68,213-214): 1 = stored+unfiltered,
    # 2..9 = MINSUM heuristic, 10 = per-row brute force.
    from ako_tpu_torch.tools.pngout import write_png

    write_png(path, image[:, :, :4], effort)


def main(argv=None, device=None) -> int:
    """The akodec command line; `device` is decode's (None: the CUDA
    card)."""
    om = build_options()
    try:
        om.parse_arguments(sys.argv[1:] if argv is None else argv)
    except OptionError as e:
        print(f"akodec: {e}", file=sys.stderr)
        return 1

    if om["-h"].value:
        om.print_help()
        return 0
    if om["-v"].value:
        print(f"akodec (ako_tpu_torch) v{ako_tpu_torch.__version__}")
        print(f"format version {ako_tpu_torch.FORMAT_VERSION}")
        return 0

    quiet = om["-quiet"].value
    in_path = om["-i"].value
    out_path = om["-o"].value
    if not in_path:
        print("akodec: no input filename (-i)", file=sys.stderr)
        return 1

    try:
        blob = read_blob(in_path)
    except OSError as e:
        print(f"akodec: {e}", file=sys.stderr)
        return 1

    events_data = EventsData() if om["-b"].value else None
    events = events_data.callback if events_data else None
    try:
        image, settings, channels = ako_tpu_torch.decode(blob, events=events, device=device)
    except ako_tpu_torch.AkoError as e:
        print(f"akodec: {e}", file=sys.stderr)
        return 1
    h, w = image.shape[:2]

    if events_data and not quiet:
        print(events_data.summary())
    if om["-ch"].value and not quiet:
        print(f"output checksum: 0x{adler32(image):08X}")
    if not quiet:
        print(f"{in_path}: {len(blob) / 1000.0:.2f} kB -> {w}x{h} px, {channels} ch")

    if out_path:
        save_png(out_path, image, om["-e"].value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
