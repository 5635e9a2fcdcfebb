"""Kernel loading and launch counting on many threads at once (the
tuner's trials fit on host threads): counts are never lost, and threads
that reach a cold kernel library together start one compile and load
the one library it published.  The compiler here is a stand-in script,
so the build machinery runs without the CUDA toolkit."""

import os
import stat
import sys
import threading

import pytest

from synapseml_tpu_torch.kernels import _build, launches
import torch_workers  # noqa: F401  (shares the cores among xdist workers)


def _run_threads(n, fn):
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors


def test_counts_from_eight_threads_are_exact():
    launches.reset()
    try:
        def worker(i):
            for _ in range(20_000):
                launches.count("k_threads", S=i % 2)
        _run_threads(8, worker)
        assert launches.total("k_threads") == 160_000
        assert launches.shapes("k_threads") == {
            launches.launch_key("k_threads", S=0): 80_000,
            launches.launch_key("k_threads", S=1): 80_000}
    finally:
        launches.reset()


def test_replays_and_recordings_from_threads():
    """``add`` (a graph replay) is exact under threads, and a recording
    keeps only its own thread's counts while others count meanwhile."""
    launches.reset()
    try:
        rec = {}

        def worker(i):
            if i == 0:
                with launches.recording() as into:
                    for _ in range(1000):
                        launches.count("k_rec")
                rec.update(into)
            else:
                for _ in range(1000):
                    launches.add({launches.launch_key("k_add"): 2})
                    launches.count("k_rec")
        _run_threads(8, worker)
        assert rec == {launches.launch_key("k_rec"): 1000}
        assert launches.total("k_add") == 7 * 1000 * 2
        assert launches.total("k_rec") == 7 * 1000
    finally:
        launches.reset()


@pytest.fixture()
def fake_compiler(tmp_path, monkeypatch):
    """A stand-in ``nvcc``: logs one line per run, sleeps so concurrent
    runs would overlap, and writes its ``-o`` file in two steps (a torn
    library, were two runs to share a temporary file)."""
    log = tmp_path / "compiles.log"
    script = tmp_path / "fake_nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write('compile\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'w') as f:\n"
        "    f.write('half')\n"
        "    f.flush()\n"
        "    time.sleep(0.3)\n"
        "    f.write(' whole')\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "fake.cu"
    src.write_text("// a source\n")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setitem(_build.SOURCES, "fake_threads", str(src))
    monkeypatch.setattr(_build, "_build_dir", tmp_path / "build")
    return log


def test_eight_cold_builds_start_one_compile(fake_compiler):
    paths = []

    def worker(i):
        paths.append(_build.build_all(["fake_threads"])["fake_threads"]
                     ["path"])
    _run_threads(8, worker)
    assert fake_compiler.read_text().count("compile") == 1
    assert len(set(paths)) == 1
    with open(paths[0]) as f:
        assert f.read() == "half whole"
    left = os.listdir(os.path.dirname(paths[0]))
    assert left == [os.path.basename(paths[0])]   # no temporary file left


def test_loaded_once_runs_the_loader_once(fake_compiler):
    calls = []

    @_build.loaded_once
    def loader():
        calls.append(1)
        return _build.build_all(["fake_threads"])["fake_threads"]["path"]

    got = []
    _run_threads(8, lambda i: got.append(loader()))
    assert len(calls) == 1 and len(set(got)) == 1
    assert loader.cache_info().currsize == 1
    assert fake_compiler.read_text().count("compile") == 1
