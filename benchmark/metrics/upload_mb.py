"""Megabytes the program sent host to device in the window's last pass:
``fused_cuda.UPLOAD_BYTES`` (the search launches' payloads, the per-lane
search's lanes and each chromosome's state), which the harness resets
before every pass; nothing where the program has no such counter."""
UNIT = "MB/pass"
LAYER = "host-to-device copies"
SOURCE = "program_counter"
MOVES = "pairs_per_s"


def read(run):
    from pindel_tpu_torch.ops import fused_cuda
    nbytes = getattr(fused_cuda, "UPLOAD_BYTES", None)
    if nbytes is None or not run.passes:
        return None
    return nbytes / 1e6
