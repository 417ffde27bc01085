"""wfmash-tpu on PyTorch and CUDA: the port of `wfmash_tpu` to one NVIDIA
H100.

`wfmash_tpu` (JAX, Pallas TPU kernels) stays the reference. This package
imports its jax-free parts (io, sketch, index, the host mapping stages,
native, the host WFA engines, params and the CLI parser) and replaces the
parts that run on the device. Module names mirror the reference's:

  device.py            the explicit torch device (replaces the RTT probe)
  _build.py, csrc/     nvcc build of the hand-written CUDA kernels
  align/wfa_seg.py     segment WFA kernel wrapper + host solver
                       (counterpart of align/wfa_pallas_seg.py)
  align/segmented.py   SegmentedEngine over the port's solver
  align/engine.py      make_engine, run_alignment
  cli.py, __main__.py  `python -m wfmash_tpu_torch target.fa query.fa`

The package imports torch and never jax.
"""

__version__ = "0.1.0"
