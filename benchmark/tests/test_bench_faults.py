"""A run with the timed path broken underneath comes out not correct: the
harness drives the port on the CPU (its look for a card skipped) with one
fault planted in the program, and judges its passes against the plain
reference.  The faults a pass of these cells can have: an answer altered
where it is produced (close-end kernel results), half of the reads left
out, and a pass that returns with its work undone.  The same run without a
fault is correct."""
import time

import pytest

import harness
from small import small_cell


def altered_close(monkeypatch):
    from pindel_tpu_torch.ops import engine_fused
    real = engine_fused._close_kernel

    def close(chrom, payload, maxmm, **static):
        out = real(chrom, payload, maxmm, **static).clone()
        # one read in 64: its representative (its close end's offset)
        # moved by one base
        out[::64, static["lmax"] // 32] += 1
        return out

    monkeypatch.setattr(engine_fused, "_close_kernel", close)


def half_the_reads(monkeypatch):
    from pindel_tpu_torch.pipeline import Pipeline
    for name in ("_window_reads", "_window_reads_bam"):
        real = getattr(Pipeline, name)

        def halved(self, chrom, window, _real=real, _bam=name.endswith(
                "bam")):
            out = _real(self, chrom, window)
            if _bam:
                return (out[0][::2],) + tuple(out[1:])
            return out[::2]

        monkeypatch.setattr(Pipeline, name, halved)


def undone(monkeypatch):
    from pindel_tpu_torch.pipeline import Pipeline
    monkeypatch.setattr(Pipeline, "run", lambda self: None)


FAULTS = {"none": None, "altered_close": altered_close,
          "half_the_reads": half_the_reads, "undone": undone}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("workload", ["colo15_bam_bd.sample",
                                      "colo15_text.sample"])
def test_fault_is_caught(monkeypatch, workload, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = harness.run(small_cell(workload), 31337, 0.1, False,
                      time.monotonic(), device="cpu")
    assert out["attempted"] >= 1
    assert out["correct"] is (fault == "none"), out
    if fault != "none":
        assert out["report_lines_differing"] > 0
        assert out["report_files_differing"] > 0


def test_reordered_report_is_not_correct(tmp_path):
    """Lines all there, in another order: the lines' count reads 0, the
    files' count 1, and the verdict is not correct."""
    import judge
    for side, lines in (("ref", [b"a", b"b", b"c"]),
                        ("pass", [b"c", b"a", b"b"])):
        (tmp_path / side).mkdir()
        (tmp_path / side / "out_D").write_bytes(b"\n".join(lines) + b"\n")
        (tmp_path / side / "out_SI").write_bytes(b"x\n")
    verdict = judge.judge([str(tmp_path / "pass" / "out")],
                          str(tmp_path / "ref" / "out"))
    assert verdict["report_lines_differing"] == 0
    assert verdict["report_files_differing"] == 1
    assert verdict["suffixes_differing"] == ["D"]
    assert not judge.correct(verdict)
