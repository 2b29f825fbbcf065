"""Seconds a pass in the entry and per-pass set-up (``pipeline.run_files``,
``Pipeline.run``): the program's spans "entry: reference" (the FASTA),
"entry: inputs" (output files, native libraries, the input's config and
index), "entry: chromosome" (the chromosome's device state), "entry: region"
(the region's sequence and mask) and "entry: finish" (the interchromosomal
merge and closing the reports), summed, the mean over the window's passes;
nothing where the program has no such spans."""
UNIT = "s/pass"
LAYER = "entry and per-pass set-up"
SOURCE = "program_span"
MOVES = "pairs_per_s"

SPANS = ("entry: reference", "entry: inputs", "entry: chromosome",
         "entry: region", "entry: finish")


def read(run):
    return run.phase_per_pass(*SPANS)
