"""pluss_torch — the PLUSS sampler in PyTorch, for NVIDIA Hopper cards.

The port of the JAX package ``pluss`` (which stays as the reference it is
held against): per-thread reuse-interval histograms of OpenMP-parallel
affine loop nests, the CRI post-pass, and the AET miss-ratio curve.  It
imports torch, numpy and scipy, never jax and never the ``pluss`` package.

Two slices are ported.  Rectangular nests end to end: ``engine.run``
(static template and ghost-merged sort windows, with the hand-written CUDA
carried-event histogram kernel) -> ``cri.distribute`` -> ``mrc.aet_mrc`` ->
the reference's ``acc`` block (``python -m pluss_torch.cli acc``).  And the
single-device streamed trace replay: ``trace.replay_file`` (with the CUDA
d24v wire decode and masked event histogram kernels) -> the ``trace``
block (``python -m pluss_torch.cli trace``), packed and device-resident
replay beside it.  Every layer reports to :mod:`pluss_torch.obs`
(telemetry), and :mod:`pluss_torch.resilience` wraps both paths in the
degradation ladder.  Runs go to the CUDA card unless the caller asks for
the CPU.
"""
