"""swf_renderer_tpu_torch — the SWF flat-block rasterizer on PyTorch + CUDA.

A port of ``swf_renderer_tpu`` (JAX on a TPU, kept beside it as the
reference) to an NVIDIA Hopper card.  Same layout, same public contracts
((F, H, W, 4) u8 frames, chunk-major planes, packed little-endian RGBA):

* **models/** — SWF AST, shape/morph decoders, display list, geometry,
  the ``.swf`` binary front end (``swf_binary``, ``sound``,
  ``screenvideo``; host code, copied from the reference);
* **native/** — the C++ cell splitter and grouped packer (built with g++
  at first use);
* **ops/** — the fused flat-block kernels (CUDA C++ in ``csrc/``, with
  plain PyTorch versions beside them), paints and the batch pipelines;
* **runtime/** — ``TorchRenderer.render(stage)`` / ``render_batch``;
  ``movie.render_movie`` / ``render_movie_timeline`` for ``.swf`` files;
* **__main__** — ``python -m swf_renderer_tpu_torch <ast.json|movie.swf>``
  writes PNG / PAM frames;
* **convert.py** — carries paints, draws and packed scenes across, and
  ``to_plain`` turns either package's parsed trees into one comparable
  form.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
