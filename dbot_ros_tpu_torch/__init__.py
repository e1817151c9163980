"""dbot_ros_tpu_torch — the particle tracker on PyTorch and CUDA (Hopper).

A port of ``dbot_ros_tpu`` (JAX/Pallas on a TPU) to eager PyTorch, with
hand-written CUDA C++ kernels for ``sm_90a`` in place of the Pallas
kernels. The JAX package is the reference: every module here keeps its
counterpart's name and layout, and the tests feed both the same inputs.

Layout (the counterpart of each module has the same path in dbot_ros_tpu/):
  utils/     pose algebra, meshes, cameras
  models/    transition, beam, occlusion models; the sensor factory
  ops/       raycast, candidate pass, resampling, the fused sensor,
             the CUDA kernel wrappers (ops/kernels.py) and their build
  filters/   the RBC-PF step
  trackers/  the particle tracker facade
  runtime/   synthetic source and the streaming loop
  csrc/      CUDA C++ sources of the kernels
  interop.py numpy → torch conversion of the JAX package's state

Importing this package never imports jax. Configuration dataclasses and
per-frame metrics come from the two jax-free modules of the JAX package
(``dbot_ros_tpu.config`` and ``dbot_ros_tpu.runtime.metrics``).
"""

__version__ = "0.1.0"
