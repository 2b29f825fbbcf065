"""PyTorch + CUDA port of pindel_tpu's pindel-text discovery path.

The host layer (config, genome, reads, text intake, the Searcher, the
detectors and the reporters) is imported unchanged from ``pindel_tpu``;
this package owns the device layer: the fused search backend
(``ops/engine_fused.py``), its hand-written CUDA scan kernel
(``csrc/scan.cu``), the backend factory and ``run_files``
(``pipeline.py``) and the CLI (``python -m pindel_tpu_torch``).

Nothing here imports jax: the machine that runs the port has none.
"""
