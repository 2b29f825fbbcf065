"""A frozen copy of pindel_tpu_torch's host layer and plain search, the
benchmark's reference for the reports a pass writes.

Copied from the port's modules of the same relative paths with the package
name changed, then cut to the discovery path (``run_files`` over
``fused``, ``jax`` and ``numpy``), and made plain where the port is not:

* the search always runs the plain torch compositions
  (``ops/engine_fused.py``'s ``_close_kernel_ref``, ``_far_kernel_ref``,
  ``_far_win_kernel_ref`` over ``ops/scan.py``'s ``scan_rows_ref``; the
  per-lane fallback ``ops/engine_jax.py``'s ``_search_kernel``), never a
  CUDA kernel, on whichever device it is given;
* the payload packer (``ops/engine_fused.py``), the pindel-text record
  scanner (``textindex._pt_scan``), RP merging and the detectors' loops run
  in NumPy and Python where the port runs its C++ (the last two are the
  port's own Python restatements, which it keeps as fallbacks);
* the BAM reader (``bam.py``) is written in Python and NumPy from the SAM
  specification and the semantics of pindel's reader.cpp, where the port
  has its own C++ reader.

There is no native code here.  Nothing here imports the port, JAX or the
JAX package, and the copy does not follow later changes to the port: it is
the yardstick they are held to.  ``benchmark/tests/test_bench_reference.py``
holds it to the JAX package's reports, written as data by the JAX
package's NumPy backend: the small scenes on the CPU, and scenes 1 and 3,
the cells' own layouts at full size, where a card is present.
"""
