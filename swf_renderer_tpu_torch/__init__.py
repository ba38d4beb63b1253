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
  ``audio.mix_movie_audio``, a movie's sound track (host code, with the
  MP3 decoder ``models.mp3`` and ``utils.wav``);
  ``service.RendererService``, the handle and asset-id front end;
* **parallel/** — frames, tile columns and passes sharded over ranks of a
  ``torch.distributed`` group (NCCL on the card, gloo on the CPU);
* **__main__** — ``python -m swf_renderer_tpu_torch <ast.json|movie.swf>``
  writes PNG / PAM frames and, with ``--wav``, a movie's mixed audio;
* **convert.py** — carries paints, draws and packed scenes across, and
  ``to_plain`` turns either package's parsed trees into one comparable
  form.

Entry points run on the card unless the caller passes ``device="cpu"``.
The names of ``__all__`` load on first use, so importing the package
costs no renderer import: ``import swf_renderer_tpu_torch as swf;
swf.render_shape(swf.load_tag("ast.json"), device="cpu")``.
"""

__version__ = "0.1.0"

# The reference's exports that the port has (its ``TpuRenderer`` is
# ``TorchRenderer`` here), each with the module that defines it.
_EXPORTS = {
    "decode_shape": "models.decode_shape",
    "decode_morph_shape": "models.decode_morph_shape",
    "load_tag": "models.ast_io",
    "parse_define_shape": "models.ast_io",
    "parse_define_morph_shape": "models.ast_io",
    "parse_define_bitmap": "models.ast_io",
    "TorchRenderer": "runtime.renderer",
    "render_shape": "runtime.renderer",
    "render_morph_shape": "runtime.renderer",
    "Stage": "models.display",
    "ShapeInstance": "models.display",
    "MorphShapeInstance": "models.display",
    "Container": "models.display",
    "RendererService": "runtime.service",
    "render_movie": "runtime.movie",
    "render_movie_timeline": "runtime.movie",
    "load_movie_stage": "runtime.movie",
    "mix_movie_audio": "runtime.audio",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
