"""The port's converters (``python -m pindel_tpu_torch.<tool>`` for
pindel2vcf, pindel2vcf4tcga, sam2pindel, bam2pindel and somatic) on the
CPU.  They are copies of the reference's modules with the imports
rewritten (tests/test_torch_standalone.py holds them to their sources);
here each must write the same bytes as the reference's module on the same
input: reports of a two-sample scene that the port's NumPy backend wrote,
test_sam2pindel.py's SAM text, and a BAM scene of the port's."""
import os
import subprocess
import sys

import numpy as np
import pytest

from pindel_tpu_torch.__main__ import main as port_main
from pindel_tpu_torch.testing.scenes import BAM_SCENES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def two_sample_reports(tmp_path_factory):
    """A two-sample scene (tumor reads, and noise reads as the normal
    sample) searched by the port's NumPy backend: (dir, fasta, prefix)."""
    from pindel_tpu_torch.testing.bamwriter import make_fai
    from pindel_tpu_torch.testing.simulate import (standard_scene,
                                                   write_fasta)
    d = str(tmp_path_factory.mktemp("convert"))
    ref, _events, reads = standard_scene(
        seed=5, kinds=["DEL", "SI", "DEL", "SI", "DEL", "INV", "TD"],
        chrom_len=60_000, reads_per_event=25, n_noise=10)
    reads.metas = [(d_, ch, pos, mq, ins, "tumor")
                   for (d_, ch, pos, mq, ins, _) in reads.metas]
    reads.metas[-10:] = [(d_, ch, pos, mq, ins, "normal")
                         for (d_, ch, pos, mq, ins, _) in reads.metas[-10:]]
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    make_fai(fa)
    reads_txt = os.path.join(d, "reads.txt")
    reads.write(reads_txt)
    prefix = os.path.join(d, "calls")
    assert port_main(["-f", fa, "-p", reads_txt, "-o", prefix,
                      "--backend", "numpy"]) == 0
    assert "ChrID" in open(prefix + "_D").read()
    return d, fa, prefix


def _modules(name):
    import importlib
    return (importlib.import_module(f"pindel_tpu.{name}"),
            importlib.import_module(f"pindel_tpu_torch.{name}"))


@pytest.mark.parametrize("name,extra", [
    ("pindel2vcf", ["-P"]), ("pindel2vcf", ["-p"]),
    ("pindel2vcf4tcga", ["-P"])])
def test_vcf_converters(two_sample_reports, name, extra):
    d, fa, prefix = two_sample_reports
    inp = prefix if extra == ["-P"] else prefix + "_D"
    out = {}
    for tag, mod in zip(("ref", "port"), _modules(name)):
        vcf = os.path.join(d, f"{name}_{extra[0][1]}_{tag}.vcf")
        assert mod.main(["-r", fa, "-R", "TESTREF", "-d", "20260818",
                         *extra, inp, "-v", vcf]) == 0
        out[tag] = open(vcf).read().replace(vcf, "OUT")
    assert out["port"] == out["ref"]
    assert "SVTYPE=DEL" in out["port"] or "TYPEOFSV=DEL" in out["port"]


def test_somatic(two_sample_reports, capsys):
    d, fa, prefix = two_sample_reports
    head = os.path.join(d, "all.head")
    with open(head, "w") as fh:
        for suffix in ("_D", "_SI"):
            for line in open(prefix + suffix):
                if "ChrID" in line:
                    fh.write(line)
    out = {}
    for tag, mod in zip(("ref", "port"), _modules("somatic")):
        cfg = os.path.join(d, f"somatic_{tag}.cfg")
        vcf = os.path.join(d, f"somatic_{tag}.vcf")
        with open(cfg, "w") as fh:
            fh.write(f"indel.filter.input = {head}\n"
                     "indel.filter.vaf = 0.1\nindel.filter.cov = 0\n"
                     "indel.filter.hom = 6\n"
                     "indel.filter.pindel2vcf = (in-process)\n"
                     f"indel.filter.reference = {fa}\n"
                     "indel.filter.referencename = refT\n"
                     "indel.filter.referencedate = 20260818\n"
                     f"indel.filter.output = {vcf}\n")
        assert mod.main([cfg]) == 0
        out[tag] = (open(vcf).read(), capsys.readouterr().out)
    assert out["port"] == out["ref"]
    assert "##fileformat" in out["port"][0]


def test_sam2pindel(tmp_path):
    from test_sam2pindel import make_sam
    sam = tmp_path / "in.sam"
    sam.write_text(make_sam(np.random.default_rng(5)))
    out = {}
    for tag, mod in zip(("ref", "port"), _modules("sam2pindel")):
        path = str(tmp_path / f"{tag}.pindel")
        assert mod.main([str(sam), path, "300", "T1", "0",
                         "Illumina-PairEnd"]) == 0
        out[tag] = open(path, errors="surrogateescape").read()
    assert out["port"] == out["ref"] and "@r0" in out["port"]
    # the module entry, on standard input
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    path = str(tmp_path / "stdin.pindel")
    subprocess.run([sys.executable, "-m", "pindel_tpu_torch.sam2pindel", "-",
                    path, "300", "T1", "0", "Illumina-PairEnd"],
                   input=sam.read_text(), text=True, timeout=120, check=True,
                   env=env, cwd=str(tmp_path))
    assert open(path, errors="surrogateescape").read() == out["ref"]


def test_bam2pindel(tmp_path):
    paths = BAM_SCENES["bam_seed3"].build(str(tmp_path))
    bam = open(paths["cfg"]).read().split()[0]
    out = {}
    for tag, mod in zip(("ref", "port"), _modules("bam2pindel")):
        prefix = str(tmp_path / tag)
        assert mod.main(["-i", bam, "-o", prefix, "-s", "S1",
                         "-m", "500"]) == 0
        d = os.path.dirname(prefix)
        out[tag] = {n[len(tag):]: open(os.path.join(d, n)).read()
                    for n in sorted(os.listdir(d))
                    if n.startswith(tag + "_")}
    assert out["port"] == out["ref"] and out["port"]
    assert all(body.count("@") > 0 for body in out["port"].values())
