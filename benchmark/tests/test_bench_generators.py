"""The benchmark's frozen generators write what the port's scene builders
(``pindel_tpu_torch/testing/scenes.py``) write, at their seeds; a layout is
found by name and takes exactly its keys; the proper pairs are the records
``BamRecord`` packs, coordinate-sorted."""
import hashlib
import json
import os
import struct

import numpy as np
import pytest

from gen import bam_bd, samples
from gen.bamwriter import BamRecord

from conftest import BENCH
from pindel_tpu_torch.testing import scenes
from refpindel.bam import inflate


def digests(d):
    """sha256 of each file; a BAM's of its inflated payload, since the
    port's test writer puts one more than the BGZF block size in each
    member's header, and the benchmark's writer the size the SAM
    specification asks for."""
    out = {}
    for name in sorted(os.listdir(d)):
        data = open(os.path.join(d, name), "rb").read()
        if name.endswith(".bam"):
            data = inflate(data)
        out[name] = hashlib.sha256(data).hexdigest()
    return out


def generator(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return dict(json.load(fh)["generator"])


def test_text_sample_is_scene1(tmp_path):
    old, new = tmp_path / "old", tmp_path / "new"
    old.mkdir()
    new.mkdir()
    scenes.write_scene(str(old), **scenes.SCENE1)
    g = generator("colo15_text")
    g.update(chrom=scenes.SCENE1["chrom"],
             chrom_len=scenes.SCENE1["chrom_len"], events_per_kind=60,
             n_noise=scenes.SCENE1["n_noise"])
    sample = samples.build(g, scenes.SCENE1["seed"], str(new))
    assert sample.pairs == 50_000
    assert digests(old) == digests(new)


def test_bam_bd_sample_is_scene3_cut(tmp_path):
    """Without proper pairs (scene 3 has none) the layout is scene 3."""
    old, new = tmp_path / "old", tmp_path / "new"
    old.mkdir()
    new.mkdir()
    paths = scenes.build_scene3(str(old), chrom_len=600_000)
    g = generator("colo15_bam_bd")
    g.update(chrom_len=600_000, proper_pair_depth=0)
    sample = samples.build(g, 2009, str(new))
    assert sample.pairs == int(paths["pairs"])
    a, b = digests(old), digests(new)
    renamed = {"scene3.bam": "reads.bam", "scene3.bd": "calls.bd",
               "scene3_reads.txt": "reads.txt", "ref.fa": "ref.fa",
               "ref.fa.fai": "ref.fa.fai"}
    assert {renamed[k]: v for k, v in a.items() if k in renamed} == \
        {k: v for k, v in b.items() if k in renamed.values()}


def test_same_seed_same_bytes_large_seed(tmp_path):
    g = generator("colo15_bam_bd")
    g["chrom_len"] = 300_000
    seed = 2 ** 31 + 12345
    got = []
    for side in ("a", "b"):
        d = tmp_path / side
        d.mkdir()
        samples.build(g, seed, str(d))
        got.append({k: v for k, v in digests(d).items() if k != "bam.cfg"})
    assert got[0] == got[1]


def test_proper_pairs_are_packed_records():
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 20_000))
    pos, rows = bam_bd.proper_pairs(ref, 150, 500, np.random.default_rng(1))
    assert rows.shape[0] == 300 and np.all(np.diff(pos) >= 0)
    names = {}
    for i in range(rows.shape[0]):
        raw = bytes(rows[i])
        (_bs, _tid, p, lrn, _mq, _bin, _nc, flag, _ls, _mt, mpos,
         tlen) = struct.unpack_from("<iiiBBHHHiiii", raw)
        assert p == pos[i]
        name = raw[36:36 + lrn - 1].decode()
        names.setdefault(name, []).append((p, flag, mpos, tlen))
        rec = BamRecord(name, flag, 0, p, 60, [(100, "M")], 0, mpos, tlen,
                        ref[p:p + 100], tags={"NM": 0})
        assert rec.pack() == raw
    assert len(names) == 150
    for (a, fa, ma, ta), (b, fb, mb, tb) in names.values():
        assert (fa, fb) == (99, 147) and (ma, mb) == (b, a)
        assert ta == -tb == b + 100 - a and 200 <= ta <= 1000


def test_depth_gives_its_pairs_sorted(tmp_path):
    g = generator("colo15_bam_bd")
    g["chrom_len"] = 300_000
    sample = samples.build(g, 77, str(tmp_path))
    from refpindel.bam import BamReader
    r = BamReader(sample.files["bam"])
    proper = 300_000 * g["proper_pair_depth"] // 200
    assert sample.pairs * 2 == r.offs.size
    assert sample.pairs > proper
    assert np.all(np.diff(r.pos) >= 0)
    assert int(((r.flag & 0x2) != 0).sum()) == 2 * proper


def test_a_layout_is_found_by_name_and_takes_its_keys():
    g = generator("colo15_text")
    assert samples.load(g).__file__ == os.path.join(BENCH, "gen", "text.py")
    with pytest.raises(ValueError, match="unknown"):
        samples.load(dict(g, extra=1))
    with pytest.raises(ValueError, match="missing"):
        samples.load({k: v for k, v in g.items() if k != "n_noise"})
    with pytest.raises(ValueError, match="no generator"):
        samples.load(dict(g, kind="no_such_layout"))
