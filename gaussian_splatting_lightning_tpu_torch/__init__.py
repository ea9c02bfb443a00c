"""PyTorch/CUDA port of ``gaussian_splatting_lightning_tpu`` for NVIDIA Hopper.

The JAX package beside this one stays the reference; this package keeps its
module paths and public names so each function's counterpart is easy to find.

- ``core``      camera, SH and splatting geometry on tensors
- ``ops``       preprocess, budget, binning (CUDA kernel K1), the compositor
                (K2 forward; K3 and K4 backward) and SSIM (K5);
                ``ops/_build.py`` builds the kernels from ``csrc/`` with
                ``nvcc`` at first use; the readable oracle rasterizer and
                the tiled route (``train.rasterizer: xla``), plain PyTorch
- ``models``    the padded-capacity ``GaussianScene`` (``reset_opacity``, SH
                warm-up), PLY interchange and ``.splat`` export
- ``data``      COLMAP / Blender parsing and view datasets (numpy)
- ``training``  the training step (render, loss, backward, Adam, densification
                statistics), densify/prune, the ``Trainer`` loop (cadences,
                adaptive budgets, NaN rollback, validation, checkpoints) and
                the YAML run configuration
- ``scripts``   the train, render, eval, scene-generator, camera-path,
                ``.splat`` export, viewer and profiler CLIs
- ``viewer``    the browser viewer page the view CLI serves
- ``utils``     the ``torch.profiler`` trace context and a step timer
- ``interop``   carries weights, Adam state and cameras over from numpy / the
                JAX fields

Entry points take ``device`` ("cuda" by default) and raise when CUDA is absent;
they run on the CPU only when asked (``device="cpu"``), and then every kernel
wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
