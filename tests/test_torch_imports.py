"""ako_tpu_torch stands without JAX: the machine with the card has
none, so neither the package nor chip_smoke.py may import it, directly
or through ako_tpu."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.ops import quantization as ref_quantization
from ako_tpu.utils import corpus as ref_corpus
from ako_tpu_torch.utils import corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ako_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|ako_tpu)(\.|\s|$)", re.MULTILINE)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_neither_jax_nor_ako_tpu():
    offenders = []
    for path in _sources():
        with open(path) as f:
            if FORBIDDEN.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []


def test_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import ako_tpu_torch\n"
        "from ako_tpu_torch.core import geometry\n"
        "from ako_tpu_torch.ops.quantization import level_qg\n"
        "print(level_qg(geometry.lift_schedule(64, 48), 3, 16, 0, 1))\n"
        "img = np.arange(24 * 20 * 3, dtype=np.uint8).reshape(24, 20, 3)\n"
        "blob = ako_tpu_torch.encode(img, ako_tpu_torch.Settings(quantization=0), device='cpu')\n"
        "assert (ako_tpu_torch.decode(blob, device='cpu')[0] == img).all()\n"
        "import os\n"
        "for mode in ('fused', 'split'):\n"
        "    os.environ['AKO_TORCH_LIFT_MODE'] = mode\n"
        "    blob = ako_tpu_torch.encode(img, ako_tpu_torch.Settings(quantization=0), device='cpu',\n"
        "                                device_entropy=True)\n"
        "    pix = ako_tpu_torch.decode(blob, device='cpu', device_entropy=True)[0]\n"
        "    assert (pix == img).all()\n"
        "from ako_tpu_torch.utils import metrics\n"
        "assert metrics.counters()['dec_device_tiles'] == 2\n"
        "assert not any(m == 'ako_tpu' or m.startswith('ako_tpu.') for m in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    ref = ref_quantization.level_qg(ref_geometry.lift_schedule(64, 48), 3, 16, 0, 1)
    assert res.stdout.strip() == repr(ref)


def test_builds_only_sources_of_the_port():
    """Every source the port compiles (the native runtime, the CUDA
    kernels and the header they include) lies inside ako_tpu_torch/."""
    from ako_tpu_torch.runtime import build, kernels

    paths = [build.SRC, *kernels.SOURCES, *kernels.DEPENDS]
    for path in paths:
        real = os.path.realpath(path)
        assert os.path.isfile(real), path
        assert os.path.commonpath([real, os.path.realpath(PKG)]) == os.path.realpath(PKG), path
    assert os.path.basename(build.SRC) == "akort.c"
    names = {os.path.basename(p) for p in kernels.SOURCES}
    assert {"manba_encode.cu", "manba_decode.cu"} <= names


def test_manba_and_api_modules_run_with_jax_blocked():
    """The Manbavaran device coder, the host modes, per-tile events, the
    streaming decode and the utils import and run without JAX or
    ako_tpu."""
    code = (
        "import os, sys, tempfile; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import ako_tpu_torch\n"
        "from ako_tpu_torch.ops import manba_device\n"
        "from ako_tpu_torch.utils import debug, developer, tracing\n"
        "from ako_tpu_torch.decode import decode_tiles_iter\n"
        "img = np.arange(24 * 20 * 3, dtype=np.uint8).reshape(24, 20, 3)\n"
        "s = ako_tpu_torch.Settings(quantization=0, tiles_dimension=16,\n"
        "                           compression=ako_tpu_torch.Compression.MANBAVARAN)\n"
        "os.environ['AKO_TPU_MANBAVARAN'] = '1'\n"
        "os.environ['AKO_TPU_TRACE_DIR'] = tempfile.mkdtemp()\n"
        "blob = ako_tpu_torch.encode(img, s, device='cpu', device_entropy=True)\n"
        "assert (ako_tpu_torch.decode(blob, device='cpu', device_entropy=True)[0] == img).all()\n"
        "assert os.listdir(os.environ.pop('AKO_TPU_TRACE_DIR'))\n"
        "for mode in ('ENCODE', 'DECODE', 'EVENTS'):\n"
        "    os.environ['AKO_TPU_' + mode] = 'tile' if mode == 'EVENTS' else 'host'\n"
        "ev = []\n"
        "blob2 = ako_tpu_torch.encode(img, s, lambda *a: ev.append(a), device='cpu')\n"
        "assert blob2 == blob and len(ev) == 6 * 4\n"
        "assert (ako_tpu_torch.decode(blob, device='cpu')[0] == img).all()\n"
        "assert [t.index for t, _ in decode_tiles_iter(blob, 2, device='cpu')] == [0, 1, 2, 3]\n"
        "assert not any(m == 'ako_tpu' or m.startswith('ako_tpu.') for m in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


def test_reads_no_file_of_ako_tpu():
    """Importing the port and coding an image on both entropy paths
    opens no file under ako_tpu/ (an audit hook records every open)."""
    code = (
        "import os, sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == 'open' else None)\n"
        "import numpy as np\n"
        "import ako_tpu_torch\n"
        "from ako_tpu_torch.runtime import build\n"
        "build.load()\n"
        "img = np.arange(24 * 20 * 3, dtype=np.uint8).reshape(24, 20, 3)\n"
        "for de in (False, True):\n"
        "    blob = ako_tpu_torch.encode(img, device='cpu', device_entropy=de)\n"
        "    ako_tpu_torch.decode(blob, device='cpu', device_entropy=de)\n"
        "ref = os.path.realpath('ako_tpu') + os.sep\n"
        "bad = [p for p in opened if os.path.realpath(p).startswith(ref)]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


def test_corpus_matches_reference():
    got = corpus.corpus(42, 2, 40, 56, 4)
    ref = ref_corpus.corpus(42, 2, 40, 56, 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_the_card(tmp_path, alone):
    """With no CUDA device (or without the repo beside it) the smoke
    run exits non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    res = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120, env=env
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
