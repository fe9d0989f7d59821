import os

import pytest

# The CPU run uses a virtual 8-device mesh; JAX reads both variables when
# its backends first initialize, which is after this import.
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture(scope="session")
def phix_fastq(tmp_path_factory):
    """1000 reads (500 interleaved pairs) sampled by seed from PhiX174 with
    substitutions and low-quality tails (kmernator_tpu/io/synth.py)."""
    from kmernator_tpu.io.synth import phix_paired_fastq
    return phix_paired_fastq(
        str(tmp_path_factory.mktemp("phix") / "phix1000.fastq"))


@pytest.fixture(scope="session")
def phix_seeds(tmp_path_factory):
    """Five 76-base PhiX174 seed contigs for the assembler."""
    from kmernator_tpu.io.synth import phix_seeds_fasta
    return phix_seeds_fasta(str(tmp_path_factory.mktemp("seeds") / "5.fa"))


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]
