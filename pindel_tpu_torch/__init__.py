"""PyTorch + CUDA port of pindel_tpu: structural-variant discovery from
split reads, with reports byte-identical to the JAX package's.

The package stands on its own.  Its host layer (config, genome, reads,
text and BAM intake, RP/BreakDancer evidence, the Searcher, the detectors,
the reporters, ``-q``/``-z``/``-g``) is a copy of the JAX package's
non-jax modules under the same relative paths, with only the imports
rewritten, and its native C++ (``native/*.cpp``) is built into
``build/native/`` at first use.  The device layer is its own: the fused
search backend (``ops/engine_fused.py``) and its hand-written CUDA scan
kernel (``csrc/scan.cu``), the legacy per-lane backend
(``ops/engine_jax.py``), the multi-GPU data-parallel backend
(``parallel/mesh_fused.py``), the entry points (``pipeline.py``) and the
CLI (``python -m pindel_tpu_torch``).

Nothing here imports jax or the JAX package: the machine that runs the
port has no jax.  Only the tests import both, to hold the port against the
reference.
"""
