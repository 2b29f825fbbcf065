"""Backend factory and ``run_files`` for the port.

Mirrors ``pindel_tpu/pipeline.py``'s ``make_backend_factory`` and
``run_files`` for the pindel-text discovery path and reuses its
``Pipeline`` unchanged: the port only swaps the device backend.
"""
from __future__ import annotations

from typing import Optional

import torch

from pindel_tpu.config import Settings
from pindel_tpu.genome import Genome
from pindel_tpu.pipeline import Pipeline
from pindel_tpu.profiling import g_fallback, g_log, g_timer


def resolve_device(device) -> torch.device:
    """The torch device to search on; asking for CUDA without a card
    raises (the port never runs on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def make_backend_factory(settings: Settings, device):
    """chrom -> TorchFusedBackend on ``device``."""
    from pindel_tpu_torch.ops.engine_fused import TorchFusedBackend
    dev = resolve_device(device)

    def factory(chrom):
        return TorchFusedBackend(settings, settings.max_mismatch(),
                                 chrom.seq, chrom_name=chrom.name,
                                 device=dev)
    return factory


def check_supported(settings: Settings) -> None:
    """Refuse settings whose search path is not ported yet."""
    if settings.breakdancer_filename:
        raise NotImplementedError(
            "-b BreakDancer windows are not ported: ROADMAP Queue 1 item 6")
    if settings.max_range_index > 4:
        raise NotImplementedError(
            "-x > 4 (per-lane far rounds) is not ported: ROADMAP Queue 1 "
            "item 6")


def run_files(reference_fa: str, pindel_file: Optional[str],
              output_prefix: str, settings: Optional[Settings] = None,
              device="cuda", pindel_config: Optional[str] = None
              ) -> Settings:
    """Convenience entry: -f/-p|-P/-o equivalent on a torch device."""
    s = settings or Settings()
    check_supported(s)
    s.reference_filename = reference_fa
    s.pindel_filename = pindel_file or ""
    s.bam_config_filename = ""
    s.pindel_config_filename = pindel_config or ""
    s.output_prefix = output_prefix
    factory = make_backend_factory(s, device)
    # per-run reset so repeated runs in one process report per-run costs
    # and per-run fallback counts
    g_timer.reset()
    g_fallback.reset()
    if s.log_filename:                    # -L (pindel.cpp:839-842)
        g_log.redirect(s.log_filename)
    genome = Genome.from_fasta(reference_fa)
    pipe = Pipeline(s, genome, backend_factory=factory)
    pipe.create_output_files()
    if pindel_config:
        pipe.load_pindel_config(pindel_config)
    elif pindel_file:
        pipe.load_pindel_input(pindel_file)
    else:
        raise ValueError("need a pindel file (-p) or pindel config (-P)")
    try:
        pipe.run()
    finally:
        pipe.close()
        # exit-time phase report (reference dumps timers at pindel.cpp:2010)
        g_timer.report(stream=g_log, coarse_only=not s.profile)
        g_log.close()
    return s
