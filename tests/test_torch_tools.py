"""The port's CLI tools on the CPU (ako_tpu_torch/tools: options, misc,
pngout, akoenc, akodec) against ako_tpu's: option defaults, parsing and
errors; the Adler-32 checksum; write_png's bytes at every effort and
channel count; and akoenc.main / akodec.main on temp files, their output
files byte-equal and their stdout and stderr equal to ako_tpu's CLIs' but
for the version lines (and the timings of -b). The port's CLIs take
device="cpu"; ako_tpu's run under JAX on the CPU."""

import re

import numpy as np
import pytest
from PIL import Image

from ako_tpu.core.events import EventsData as RefEventsData
from ako_tpu.tools import akodec as ref_akodec
from ako_tpu.tools import akoenc as ref_akoenc
from ako_tpu.tools.misc import adler32 as ref_adler32
from ako_tpu.tools.pngout import write_png as ref_write_png
from ako_tpu_torch.core.events import Event, EventsData
from ako_tpu_torch.tools import akodec, akoenc
from ako_tpu_torch.tools.misc import adler32, read_blob, write_blob
from ako_tpu_torch.tools.options import OptionError, OptionsManager
from ako_tpu_torch.tools.pngout import write_png
from ako_tpu_torch.utils.corpus import corpus


def _om():
    om = OptionsManager("test")
    om.add_int("-q", 16, 0, 100, "cat", "")
    om.add_string("-w", "DD137", ["DD137", "CDF53"], "cat", "")
    om.add_bool("-b", "cat", "")
    return om


def test_options_defaults():
    om = _om()
    om.parse_arguments([])
    assert (om["-q"].value, om["-w"].value, om["-b"].value) == (16, "DD137", False)


def test_options_parse():
    om = _om()
    om.parse_arguments(["-q", "0x2a", "-w", "cdf53", "-b"])
    assert om["-q"].value == 42
    assert om["-w"].index == 1  # the index doubles as the enum value
    assert om["-b"].value is True


@pytest.mark.parametrize("argv,message", [
    (["-nope"], "unknown option '-nope'"),
    (["-q", "101"], "value for '-q' out of range [0, 100]"),
    (["-q"], "missing value for '-q'"),
    (["-q", "x"], "'x' is not a valid integer for '-q'"),
    (["-w", "HAAR"], "'HAAR' is not a valid value for '-w' (allowed: DD137, CDF53)"),
])
def test_options_errors(argv, message):
    with pytest.raises(OptionError) as e:
        _om().parse_arguments(argv)
    assert str(e.value) == message


@pytest.mark.parametrize("tool,ref", [(akoenc, ref_akoenc), (akodec, ref_akodec)],
                         ids=["akoenc", "akodec"])
def test_help_equals_ako_tpu(tool, ref):
    import io

    assert tool.main(["-h"], device="cpu") == 0
    ours, want = io.StringIO(), io.StringIO()
    tool.build_options().print_help(file=ours)
    ref.build_options().print_help(file=want)
    assert ours.getvalue() == want.getvalue() and "Input/output:" in want.getvalue()


@pytest.mark.parametrize("tool,name", [(akoenc, "akoenc"), (akodec, "akodec")])
def test_version_names_the_port(tool, name, capsys):
    import ako_tpu_torch

    assert tool.main(["-v"], device="cpu") == 0
    assert capsys.readouterr().out == (f"{name} (ako_tpu_torch) v{ako_tpu_torch.__version__}\n"
                                       f"format version {ako_tpu_torch.FORMAT_VERSION}\n")


def test_adler32():
    assert adler32(b"Wikipedia") == 0x11E60398
    img = corpus(3, 1, 17, 23, 3)[0]
    assert adler32(img) == ref_adler32(img) == adler32(img.tobytes())
    assert adler32(img[:, ::-1]) == ref_adler32(img[:, ::-1])  # a strided view, its pixels


def test_blob_io(tmp_path):
    path = str(tmp_path / "x.ako")
    write_blob(path, b"\x00ako\xff")
    assert read_blob(path) == b"\x00ako\xff"


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("effort", list(range(1, 11)))
def test_write_png_bytes(effort, channels, tmp_path):
    """The same bytes as ako_tpu's writer, and Pillow reads the pixels back."""
    rng = np.random.default_rng(effort * 10 + channels)
    img = np.clip(corpus(5, 1, 21, 19, 4)[0][:, :, :channels] + rng.normal(0, 3, (21, 19, channels)),
                  0, 255).astype(np.uint8)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    write_png(ours, img if channels > 1 else img[:, :, 0], effort)
    ref_write_png(ref, img, effort)
    assert read_blob(ours) == read_blob(ref)
    back = np.asarray(Image.open(ours))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_events_data_summary():
    """-b's stage timers accumulate over START/END pairs and print as
    ako_tpu's do."""
    ev, ref = EventsData(), RefEventsData()
    for data in (ev, ref):
        for e in (Event.FORMAT_START, Event.FORMAT_END, Event.WAVELET_START, Event.WAVELET_END,
                  Event.COMPRESSION_START, Event.COMPRESSION_END, Event.WAVELET_END):
            data.callback(0, 1, e, None)
        data.format.total, data.wavelet.total, data.compression.total = 0.00125, 0.5, 2.0
    assert ev.summary() == ref.summary() == (
        "Benchmark: 1.25 ms format, 500.00 ms wavelet transformation, 2000.00 ms compression")
    assert ev.wavelet.milliseconds == 500.0


# ---------------------------------------------------------------- the CLIs

_BENCH = re.compile(r"Benchmark: [0-9.]+ ms format, [0-9.]+ ms wavelet transformation, "
                    r"[0-9.]+ ms compression")


def _run(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, _BENCH.sub("Benchmark: <timings>", out), err


def _both(tool, ref, argv, tmp_path, capsys, outputs=("-o",)):
    """(rc, stdout, stderr, output bytes) of the port's CLI and of
    ako_tpu's on the same arguments, each writing its own output files."""
    results = []
    for name, main, kw in (("ours", tool.main, {"device": "cpu"}), ("ref", ref.main, {})):
        args = list(argv)
        for flag in outputs:
            if flag in args:
                i = args.index(flag) + 1
                args[i] = str(tmp_path / f"{name}_{args[i]}")
        rc, out, err = _run(main, args, capsys, **kw)
        files = [read_blob(args[args.index(f) + 1]) if f in args and rc == 0 and
                 "-dev-no-write" not in args else None for f in outputs]
        results.append((rc, out.replace(str(tmp_path / f"{name}_"), "<out>"), err, files))
    return results


def _input_png(tmp_path, channels=3, alpha_holes=False) -> str:
    img = np.clip(corpus(9, 1, 40, 56, 4)[0][:, :, :channels].astype(np.int64)
                  + np.random.default_rng(4).normal(0, 3, (40, 56, channels)), 0, 255).astype(np.uint8)
    if alpha_holes:
        img[3:20, 5:30, -1] = 0
    path = str(tmp_path / "in.png")
    Image.fromarray(img if channels > 1 else img[:, :, 0]).save(path)
    return path


ENC_ARGS = {
    "q16": ["-q", "16"],
    "lossless": ["-q", "0", "-ch"],
    "tiles_gate_chroma": ["-q", "16", "-t", "32", "-g", "8", "-chroma-loss", "3", "-verbose"],
    "wavelet_wrap_color": ["-w", "cdf53", "-wr", "MIRROR", "-c", "SUBTRACT-G", "-q", "30"],
    "discard_rgba": ["-d", "-q", "16", "-ch"],
    "rate": ["-dev-r", "8", "-t", "32", "-verbose"],
    "rate_gate": ["-dev-r", "12", "-g", "16"],
    "compression_none": ["-dev-compression", "NONE", "-q", "4"],
    "manbavaran_reserved": ["-dev-compression", "MANBAVARAN", "-q", "16"],
    "benchmark": ["-b", "-q", "16"],
    "quiet": ["-quiet", "-q", "16"],
    "no_write": ["-dev-no-write", "-q", "16"],
}


@pytest.mark.parametrize("case", list(ENC_ARGS))
def test_akoenc_equals_ako_tpu(case, tmp_path, capsys):
    src = _input_png(tmp_path, channels=4 if case == "discard_rgba" else 3,
                     alpha_holes=case == "discard_rgba")
    ours, ref = _both(akoenc, ref_akoenc, ["-i", src, "-o", "x.ako", *ENC_ARGS[case]], tmp_path,
                      capsys)
    assert ours == ref
    assert ours[0] == 0
    if case == "no_write":
        assert not (tmp_path / "ours_x.ako").exists()
    if case == "benchmark":
        assert "Benchmark: <timings>" in ours[1]


@pytest.mark.parametrize("argv", [[], ["-i"], ["-i", "in.png", "-q", "70000"], ["-z"],
                                  ["-i", "in.png", "-w", "DD97"]],
                         ids=["no_input", "missing_value", "out_of_range", "unknown", "bad_wavelet"])
def test_akoenc_errors_equal_ako_tpu(argv, tmp_path, capsys):
    ours, ref = _both(akoenc, ref_akoenc, argv, tmp_path, capsys)
    assert ours == ref and ours[0] == 1 and ours[2].startswith("akoenc: ")


def test_akoenc_names_pillow_when_missing(tmp_path, capsys, monkeypatch):
    """Without Pillow the image cannot be read: an akoenc: error that
    names it, and exit 1."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    src = _input_png(tmp_path)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    rc, out, err = _run(akoenc.main, ["-i", src, "-o", str(tmp_path / "x.ako")], capsys,
                        device="cpu")
    assert rc == 1 and err.startswith("akoenc: ") and "Pillow (PIL)" in err
    assert not (tmp_path / "x.ako").exists()


@pytest.mark.parametrize("args", [[], ["-e", "1", "-ch"], ["-e", "10", "-b"], ["-quiet"]],
                         ids=["default", "effort1_checksum", "effort10_benchmark", "quiet"])
def test_akodec_equals_ako_tpu(args, tmp_path, capsys):
    src = _input_png(tmp_path, channels=4)
    ako = str(tmp_path / "in.ako")
    assert ref_akoenc.main(["-i", src, "-o", ako, "-q", "16", "-t", "32", "-quiet"]) == 0
    ours, ref = _both(akodec, ref_akodec, ["-i", ako, "-o", "out.png", *args], tmp_path, capsys)
    assert ours == ref and ours[0] == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours_out.png")),
                                  np.asarray(Image.open(tmp_path / "ref_out.png")))


@pytest.mark.parametrize("cut", ["truncated", "empty", "missing"])
def test_akodec_errors_equal_ako_tpu(cut, tmp_path, capsys):
    src = _input_png(tmp_path)
    ako = str(tmp_path / "in.ako")
    assert ref_akoenc.main(["-i", src, "-o", ako, "-quiet"]) == 0
    blob = read_blob(ako)
    bad = str(tmp_path / "bad.ako")
    if cut != "missing":
        write_blob(bad, blob[: len(blob) // 2] if cut == "truncated" else b"")
    ours, ref = _both(akodec, ref_akodec, ["-i", bad, "-o", "out.png"], tmp_path, capsys)
    assert ours == ref and ours[0] == 1 and ours[2].startswith("akodec: ")


def test_cli_roundtrip_lossless(tmp_path, capsys):
    """akoenc -q 0 then akodec: the input pixels, through the port alone."""
    src = _input_png(tmp_path, channels=4)
    ako, png = str(tmp_path / "x.ako"), str(tmp_path / "x.png")
    assert akoenc.main(["-i", src, "-o", ako, "-q", "0", "-quiet"], device="cpu") == 0
    assert akodec.main(["-i", ako, "-o", png, "-quiet"], device="cpu") == 0
    np.testing.assert_array_equal(np.asarray(Image.open(png)), np.asarray(Image.open(src)))


@pytest.mark.parametrize("tool", [akoenc, akodec], ids=["akoenc", "akodec"])
def test_cli_needs_the_card_unless_cpu(tool, tmp_path):
    """main(device=None) codes on the CUDA card: with none it raises, and
    writes nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = _input_png(tmp_path)
    ako = str(tmp_path / "in.ako")
    assert akoenc.main(["-i", src, "-o", ako, "-quiet"], device="cpu") == 0
    argv = (["-i", src, "-o", str(tmp_path / "x.ako")] if tool is akoenc
            else ["-i", ako, "-o", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv + ["-quiet"])
    assert not (tmp_path / "x.ako").exists() and not (tmp_path / "x.png").exists()
