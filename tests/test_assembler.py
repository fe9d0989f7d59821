"""DistributedNucleatingAssembler extension-consistency: PhiX174 seed
contigs extended against a seeded PhiX read set must grow and remain exact
substrings of the (circular) PhiX174 genome."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def load_fasta(path):
    seqs = {}
    name = None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            name = line[1:]
            seqs[name] = ""
        else:
            seqs[name] += line
    return seqs


def test_extension_consistency(tmp_path, phix_fastq, phix_seeds):
    out = str(tmp_path / "asm.fa")
    subprocess.run(
        [sys.executable, "-m", "kmernator_tpu.apps.nucleating_assembler",
         "--contig-file", phix_seeds, "--out", out,
         "--max-iterations", "2", "25", phix_fastq],
        check=True, env=ENV, capture_output=True)
    contigs = load_fasta(out)
    assert len(contigs) == 5

    phix = "".join(l.strip() for l in
                   open(os.path.join(REPO, "kmernator_tpu/data/phix174.fasta"))
                   if not l.startswith(">"))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(phix))
    g = phix + phix[:1000]
    grc = rc + rc[:1000]

    grew = 0
    for name, seq in contigs.items():
        assert seq in g or seq in grc, "contig %s diverged from phiX" % name
        if len(seq) > 76:
            grew += 1
            assert "-l" in name and "r" in name.rsplit("-l", 1)[1]
    assert grew >= 4, "expected most seeds to extend"


def test_mesh_matches_host_assembly(tmp_path, phix_fastq, phix_seeds):
    """--mesh 4 (distributed matcher over the virtual mesh) must produce
    byte-identical contigs to the host matcher path."""
    host_out = str(tmp_path / "host.fa")
    mesh_out = str(tmp_path / "mesh.fa")
    base = [sys.executable, "-m", "kmernator_tpu.apps.nucleating_assembler",
            "--contig-file", phix_seeds, "--max-iterations", "2",
            "25", phix_fastq]
    env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    subprocess.run(base + ["--out", host_out], check=True, env=env,
                   capture_output=True)
    subprocess.run(base + ["--out", mesh_out, "--mesh", "4",
                           "--jax-platform", "cpu"],
                   check=True, env=env, capture_output=True)
    assert open(mesh_out, "rb").read() == open(host_out, "rb").read()


def test_contig_extender_cli(tmp_path, phix_fastq, phix_seeds):
    """Standalone ContigExtender app (ref: apps/ContigExtender.cpp): seeds
    extend into exact phiX substrings, names get -l<n>r<m> suffixes."""
    out = str(tmp_path / "extended.fa")
    subprocess.run(
        [sys.executable, "-m", "kmernator_tpu.apps.contig_extender",
         "--contig-file", phix_seeds, "--out", out, "25",
         phix_fastq],
        check=True, env=ENV, capture_output=True)
    contigs = load_fasta(out)
    assert len(contigs) == 5
    seeds = load_fasta(phix_seeds)
    phix = "".join(l.strip() for l in
                   open(os.path.join(REPO, "kmernator_tpu/data/phix174.fasta"))
                   if not l.startswith(">"))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    circ = phix + phix
    rc = "".join(comp[c] for c in reversed(phix))
    circ_rc = rc + rc
    grew = 0
    for name, seq in contigs.items():
        assert "-l" in name and "r" in name.rsplit("-l", 1)[1]
        assert seq in circ or seq in circ_rc
        base = name.rsplit("-l", 1)[0]
        if len(seq) > len(seeds[base]):
            grew += 1
    assert grew >= 4
