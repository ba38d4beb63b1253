"""swf_renderer_tpu_torch — the SWF flat-block rasterizer on PyTorch + CUDA.

A port of ``swf_renderer_tpu`` (JAX on a TPU, kept beside it as the
reference) to an NVIDIA Hopper card.  Same layout, same public contracts
((F, H, W, 4) u8 frames, chunk-major planes, packed little-endian RGBA):

* **models/** — SWF AST, shape/morph decoders, display list, geometry
  (host code, copied from the reference);
* **native/** — the C++ cell splitter and grouped packer (built with g++
  at first use);
* **ops/** — the fused flat-block kernels (CUDA C++ in ``csrc/``, with
  plain PyTorch versions beside them), paints and the batch pipelines;
* **runtime/** — ``TorchRenderer.render(stage)`` / ``render_batch``;
* **convert.py** — carries paints, draws and packed scenes across.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
