"""CPU tests of the GPU bring-up pieces: chip_smoke.py's refusal to run
without a GPU and its result/comparison helpers, the compile-cache
location, the mesh size check, the host-keyed native build, the
one-device-per-process pin of multihost.initialize, and the seeded inputs."""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _gitignored(path: str) -> bool:
    r = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
    return r.returncode == 0


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_result_line():
    import chip_smoke
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_chip_smoke_compare_dirs(tmp_path):
    import chip_smoke
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    (a / "x.fastq").write_bytes(b"l1\nl2\n")
    (b / "x.fastq").write_bytes(b"l1\nl2\n")
    assert chip_smoke.compare_dirs(str(a), str(b)) == []
    (b / "x.fastq").write_bytes(b"l2\nl1\n")
    assert chip_smoke.compare_dirs(str(a), str(b)) == ["x.fastq differs"]
    assert chip_smoke.compare_dirs(str(a), str(b), sort_lines=True) == []
    (a / "y.fastq").write_bytes(b"")
    assert any("file names differ" in d
               for d in chip_smoke.compare_dirs(str(a), str(b), True))


def _record_config_updates(monkeypatch):
    import jax
    from kmernator_tpu.utils import jaxconfig
    calls = []
    monkeypatch.setattr(jaxconfig, "_done", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    return jaxconfig, calls


def test_compilation_cache_honours_env(monkeypatch, tmp_path):
    jaxconfig, calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jaxconfig.enable_compilation_cache()
    assert calls == []
    assert jaxconfig.compilation_cache_dir() == str(tmp_path)


def test_compilation_cache_default_is_fixed_checkout_path(monkeypatch):
    jaxconfig, calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxconfig.enable_compilation_cache()
    want = os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", want)]
    assert jaxconfig.compilation_cache_dir() == want
    assert _gitignored(".jax_cache/")


@pytest.mark.parametrize("n", [0, 9])
def test_make_mesh_raises_past_device_count(n):
    import jax
    from kmernator_tpu.parallel.mesh import make_mesh
    assert len(jax.devices()) == 8
    assert make_mesh(8).devices.size == 8
    with pytest.raises(ValueError):
        make_mesh(n)


def test_native_build_is_host_keyed():
    from kmernator_tpu.io import native
    flags = native.host_target_flags()
    here = native.native_build_path("io_native", True, flags)
    assert here == native.native_build_path("io_native", True, flags)
    other = native.native_build_path("io_native", True, flags + " -mavx9")
    assert os.path.dirname(other) != os.path.dirname(here)
    assert os.path.basename(other) == os.path.basename(here)
    assert here.endswith(".so") and not native.native_build_path(
        "baseline_count", False, flags).endswith(".so")
    assert native.build_native("io_native", shared=True) == here
    assert native.get_lib() is not None
    assert _gitignored(os.path.relpath(here, REPO))


def test_multihost_initialize_pins_one_device(monkeypatch):
    import jax
    from kmernator_tpu.parallel import multihost
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("KMERNATOR_TPU_RANK", "")
    multihost.initialize("localhost:1234", 4, 2)
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": [2]}
    seen.clear()
    multihost.initialize(None, 1, 0)
    assert seen == {}


def test_bench_refuses_without_gpu(monkeypatch, tmp_path):
    import bench
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.gpu_identity()


def test_phix_paired_fastq_seeded(tmp_path):
    from kmernator_tpu.io.reads import load_reads
    from kmernator_tpu.io.synth import phix_paired_fastq
    a = phix_paired_fastq(str(tmp_path / "a.fastq"))
    b = phix_paired_fastq(str(tmp_path / "b.fastq"))
    assert open(a, "rb").read() == open(b, "rb").read()
    rs = load_reads([a])
    assert rs.n == 1000
    assert rs.identify_pairs() == 500
    lens = rs.lengths()
    assert lens.max() == 100 and 50 <= lens.min() < 100


def test_random_genome_fastq_size(tmp_path):
    from kmernator_tpu.io.synth import random_genome_fastq
    p = random_genome_fastq(str(tmp_path / "r.fastq"), 1)
    size = os.path.getsize(p)
    assert 0.9e6 < size <= 1e6
    with open(p, "rb") as f:
        assert f.read().count(b"\n") == 4 * int(1e6 / 215)
