"""wfmash-tpu on PyTorch and CUDA: the port of `wfmash_tpu` to one NVIDIA
H100.

`wfmash_tpu` (JAX, Pallas TPU kernels) stays the reference. This package
stands alone: it imports torch, never jax, and nothing of `wfmash_tpu`.
The host modules (io, sketch, index, the host mapping stages, native,
the host WFA engines, params, the CLI parser) are its own copies under
the reference's module names; the parts that run on the device are
written anew:

  device.py            the explicit torch device (replaces the RTT probe)
  _build.py, csrc/     nvcc build of the hand-written CUDA kernels
  align/wfa_seg.py     segment WFA kernel wrapper + host solver
                       (counterpart of align/wfa_pallas_seg.py)
  align/wfa_sweep.py   exact crossing-payload sweep kernel wrapper
                       (counterpart of align/wfa_pallas.py)
  align/wfa_exact.py   ExactWfaEngine: sweeps + host recursion
                       (counterpart of align/wfa_jax.py)
  align/segmented.py   SegmentedEngine over the port's solver
  align/engine.py      make_engine, run_alignment (WFMASH_TPU_ALIGN_MESH
                       shards the segment tiers)
  map/l1_device.py,    the mapping's device stages as torch programs
  map/l2_device.py
  parallel/mesh.py     several devices in one process: Mesh, the sharded
                       L1 (WFMASH_TPU_DEVICE_L1=mesh), the sharded
                       wavefront steps (counterpart of parallel/mesh.py)
  parallel/dryrun.py   entry() and dryrun_multichip (counterpart of
                       __graft_entry__.py)
  runner.py            run_mapping on the host or device stages
  cli.py, __main__.py  `python -m wfmash_tpu_torch target.fa query.fa`
"""

__version__ = "0.1.0"

# Version string reported by the CLI; mirrors the reference's
# skch::fixed::VERSION ("3.5.0", map_parameters.hpp:129) for feature parity.
WFMASH_COMPAT_VERSION = "3.5.0"
