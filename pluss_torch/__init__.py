"""pluss_torch — the PLUSS sampler in PyTorch, for NVIDIA Hopper cards.

The port of the JAX package ``pluss`` (which stays as the reference it is
held against): per-thread reuse-interval histograms of OpenMP-parallel
affine loop nests, the CRI post-pass, and the AET miss-ratio curve.  It
imports torch, numpy and scipy, never jax and never the ``pluss`` package.

All of the JAX package but its XLA- and TPU-only pieces (the compile
cache, the mesh shims, the Pallas modules) is ported, with the same names,
flags and printed blocks:

- the sampler over all 29 registry families (``engine.run``: static
  templates, interleave overlays and sort windows with the hand-written
  CUDA carried-event histogram kernel; sliced and sampled runs, the plan
  cache) -> ``cri.distribute`` -> ``mrc.aet_mrc`` (``python -m
  pluss_torch.cli acc|speed|mrc|sample``);
- trace replay, streamed (``trace.replay_file``, with the CUDA d24v wire
  decode and masked event histogram kernels), packed and device-resident
  (``residency``), sharded over devices and processes (``parallel``,
  ``multihost``);
- static analysis and prediction (``analysis``), the authoring frontend
  and transforms (``frontend``), telemetry (``obs``), the degradation
  ladder (``resilience``), the serving daemon (``serve``), autotune,
  sweep, the native C++ runtime (``native``) and the soaks (``soak``).

Runs go to the CUDA card unless the caller asks for the CPU.  The package
root re-exports the spec and configuration types, as ``pluss`` does.
"""

from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.sched import ChunkSchedule
from pluss_torch.spec import Loop, LoopNestSpec, Ref

__version__ = "0.1.0"
