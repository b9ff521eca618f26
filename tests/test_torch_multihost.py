"""ako_tpu_torch.parallel.multihost in real processes on the CPU: 2 and 4
processes joined over gloo (torch.distributed), each running
HostShardedPipeline on its round-robin shard of a deterministic image
stream, with the assertions of tests/test_multihost.py:

- every process sees the process-wide mesh {"hosts": n, "tiles": 2};
- the union of the shards covers the image stream exactly once;
- every shard's blob is byte-identical to ako_tpu.encode's, and every
  decoded image to the port's one-process decode.

Run as a script, this file is the worker:
    python tests/test_torch_multihost.py <coord> <nproc> <pid> <outfile>
It imports torch and ako_tpu_torch, never JAX."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES = 5


def _images():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, size=(40, 48, 3)) // 4 * 4).astype(np.uint8)
            for _ in range(N_IMAGES)]


def worker(coord: str, nproc: int, pid: int, outfile: str) -> None:
    import torch

    import ako_tpu_torch
    from ako_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=coord, num_processes=nproc, process_id=pid)
    assert multihost.process_info() == (pid, nproc)
    mesh = multihost.global_mesh(devices=[torch.device("cpu")] * 2)
    settings = ako_tpu_torch.Settings(quantization=16)
    images = _images()
    pipe = multihost.HostShardedPipeline(settings, workers=2, device="cpu")
    blobs = dict(pipe.encode_shard(images))
    all_blobs = [ako_tpu_torch.encode(img, settings, device="cpu") for img in images]
    pixels_ok = True
    for gidx, img in pipe.decode_shard(all_blobs):
        want = ako_tpu_torch.decode(all_blobs[gidx], device="cpu")[0]
        pixels_ok = pixels_ok and np.array_equal(img, want)
    with open(outfile, "wb") as f:
        pickle.dump({"blobs": blobs, "pixels_ok": pixels_ok, "mesh_shape": dict(mesh.shape),
                     "process": (pid, nproc)}, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_pipeline(nproc, tmp_path):
    import ako_tpu

    coord = f"127.0.0.1:{_free_port()}"
    outfiles = [str(tmp_path / f"out{pid}.pkl") for pid in range(nproc)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), coord, str(nproc), str(pid),
                          outfiles[pid]], env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, stderr in outs:
        assert rc == 0, f"worker failed:\n{stderr.decode()[-2000:]}"

    results = []
    for f in outfiles:
        with open(f, "rb") as fh:
            results.append(pickle.load(fh))
    for pid, r in enumerate(results):
        assert r["process"] == (pid, nproc)
        assert r["mesh_shape"] == {"hosts": nproc, "tiles": 2}
        assert r["pixels_ok"]
    assert sorted(i for r in results for i in r["blobs"]) == list(range(N_IMAGES))
    settings = ako_tpu.Settings(quantization=16)
    expected = [ako_tpu.encode(img, settings) for img in _images()]
    for r in results:
        for gidx, blob in r["blobs"].items():
            assert blob == expected[gidx], f"blob {gidx} diverges"


def test_single_process_degrades_to_local():
    """No group: initialize() is a no-op, the process is (0, 1), and the
    pipeline covers the whole stream."""
    import torch

    import ako_tpu_torch
    from ako_tpu_torch.parallel import multihost

    multihost.initialize()
    assert multihost.process_info() == (0, 1)
    assert multihost.shard_stream(list(range(7)), 1, 3) == [1, 4]
    assert multihost.global_mesh(devices=[torch.device("cpu")]).shape == {"hosts": 1, "tiles": 1}
    settings = ako_tpu_torch.Settings(quantization=16)
    images = _images()[:2]
    pipe = multihost.HostShardedPipeline(settings, workers=2, device="cpu")
    blobs = dict(pipe.encode_shard(images))
    assert blobs == {i: ako_tpu_torch.encode(img, settings, device="cpu")
                     for i, img in enumerate(images)}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
