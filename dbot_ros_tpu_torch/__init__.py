"""dbot_ros_tpu_torch — the particle tracker on PyTorch and CUDA (Hopper).

A port of ``dbot_ros_tpu`` (JAX/Pallas on a TPU) to eager PyTorch, with
hand-written CUDA C++ kernels for ``sm_90a`` in place of the Pallas
kernels. The JAX package is the reference: every module here keeps its
counterpart's name and layout, and the tests feed both the same inputs.

Layout (the counterpart of each module has the same path in dbot_ros_tpu/):
  utils/     pose algebra, meshes, cameras
  config.py  tracker configuration dataclasses, YAML/JSON loading
  utils/     pose algebra, meshes, cameras
  models/    transition, beam, occlusion models; the image likelihood;
             the sensor factory ("pallas" = fused, "xla" = exact)
  ops/       raycast, candidate pass, resampling, memory budget, the
             fused sensor, the CUDA kernel wrappers (ops/kernels.py) and
             their build
  filters/   the RBC-PF step
  trackers/  the particle tracker facade with its island trial
  runtime/   sources (replay, synthetic), the streaming loop, metrics,
             checkpoint, watchdog, the 6-DoF initializer, publisher,
             overlay, and the command line (``python -m
             dbot_ros_tpu_torch record|track|simulate``)
  csrc/      CUDA C++ sources of the kernels
  interop.py numpy → torch conversion of the JAX package's state and
             checkpoints

The package imports ``torch``, never ``jax`` and nothing of
``dbot_ros_tpu``: it keeps its own copy of what it needs. Its entry
points run on the card (``device=None`` means ``cuda`` and raises
without it); pass ``device="cpu"`` / ``--device cpu`` for the CPU.
"""

__version__ = "0.2.0"
