"""Command-line renderer:
``python -m swf_renderer_tpu_torch <ast.json|movie.swf>``.

Port of ``swf_renderer_tpu/__main__.py``, with the same options and the
same argument errors.  It loads any supported tag from an ast.json OR a
whole .swf movie (FWS, CWS or ZWS), rasterizes on the card and writes
PNG and/or PAM (``--frames DIR`` plays a movie timeline to numbered
PNGs, one batch).  ``main(argv, device="cpu")`` runs the kernels' plain
versions on the CPU instead; with no device and no card it raises.
``--wav PATH`` mixes a movie's audio on the host and writes it as a
16-bit WAV; alone it renders nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(
        prog="swf_renderer_tpu_torch",
        description="SWF shape and movie rasterizer on a CUDA card",
    )
    parser.add_argument(
        "ast", help="path to a define-shape/morph/bitmap ast.json "
                    "or a .swf movie file")
    parser.add_argument("-o", "--output", default=None,
                        help="output path (.png or .pam); default: <ast>.png")
    parser.add_argument("--ratio", type=float, default=0.0,
                        help="morph ratio in [0, 1] (morph shapes only)")
    parser.add_argument("--bitmap", action="append", default=[],
                        help="bitmap ast.json to register (repeatable)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="extra uniform scale applied to the stage")
    parser.add_argument("--stats", action="store_true",
                        help="print render statistics to stderr")
    parser.add_argument("--frames", default=None, metavar="DIR",
                        help="for .swf inputs: render the whole timeline "
                             "to numbered PNGs in DIR (one device batch)")
    parser.add_argument("--wav", default=None, metavar="PATH",
                        help="for .swf inputs: mix the movie's audio "
                             "track (events + stream) to a 16-bit WAV")
    args = parser.parse_args(argv)

    from .models import ast as ast_model
    from .models import display
    from .models.ast_io import load_tag
    from .runtime.renderer import TorchRenderer
    from .utils.pam import rgba_to_pam
    from .utils.png import write_png

    is_movie = args.ast.endswith(".swf")
    if args.frames is not None and not is_movie:
        parser.error("--frames only applies to .swf movie inputs")
    if args.wav is not None and not is_movie:
        parser.error("--wav only applies to .swf movie inputs")
    if is_movie and (args.scale != 1.0 or args.ratio != 0.0 or args.bitmap):
        # Movies carry their own placements, ratios, and bitmaps;
        # silently ignoring these options would hand back wrong output.
        parser.error("--scale/--ratio/--bitmap do not apply to .swf "
                     "inputs (movies carry their own placements, "
                     "ratios, and bitmaps)")

    def write_output(frame, dt: float) -> int:
        out = pathlib.Path(args.output or (args.ast + ".png"))
        if out.suffix == ".pam":
            out.write_bytes(rgba_to_pam(frame))
        else:
            write_png(out, frame)
        if args.stats:
            h, w = frame.shape[:2]
            print(json.dumps({
                "width": w, "height": h, "seconds": round(dt, 4),
                "mpx_per_s": round(w * h / dt / 1e6, 3),
            }), file=sys.stderr)
        print(out)
        return 0

    if is_movie:
        # A whole movie file: define tags + placements (FWS or CWS).
        from .runtime.movie import render_movie, render_movie_timeline

        if args.wav is not None:
            from .models.swf_binary import parse_movie
            from .runtime.audio import mix_movie_audio
            from .runtime.movie import _movie_bytes
            from .utils.wav import write_wav

            movie = parse_movie(_movie_bytes(args.ast))
            write_wav(args.wav, mix_movie_audio(movie))
            print(args.wav)
            if args.output is None and args.frames is None:
                # Audio-only invocation: render nothing that was not
                # asked for.
                return 0

        t0 = time.perf_counter()
        if args.frames is not None:
            frames = render_movie_timeline(args.ast, device=device)
            dt = time.perf_counter() - t0
            out_dir = pathlib.Path(args.frames)
            out_dir.mkdir(parents=True, exist_ok=True)
            for i, frame in enumerate(frames):
                write_png(out_dir / f"{i:04d}.png", frame)
            if args.stats:
                f, h, w = frames.shape[:3]
                print(json.dumps({
                    "frames": f, "width": w, "height": h,
                    "seconds": round(dt, 4),
                    "mpx_per_s": round(f * w * h / dt / 1e6, 3),
                }), file=sys.stderr)
            print(out_dir)
            return 0
        return write_output(render_movie(args.ast, device=device),
                            time.perf_counter() - t0)

    tag = load_tag(args.ast)
    t0 = time.perf_counter()

    if isinstance(tag, ast_model.DefineShape):
        stage = display.stage_for_shape(tag)
    elif isinstance(tag, ast_model.DefineMorphShape):
        stage = display.stage_for_morph_shape(tag, args.ratio)
    elif isinstance(tag, ast_model.DefineBitmap):
        # Render the decoded bitmap itself.
        from .runtime.bitmap_service import decode_x_swf_bmp

        return write_output(decode_x_swf_bmp(tag.data),
                            time.perf_counter() - t0)
    else:
        print(f"unsupported tag: {tag!r}", file=sys.stderr)
        return 2

    if args.scale != 1.0:
        import math

        from .utils.fixed import Sfixed16P16

        child = stage.children[0]
        m = child.matrix
        scaled = ast_model.Matrix(
            scale_x=Sfixed16P16.from_value(args.scale),
            scale_y=Sfixed16P16.from_value(args.scale),
            rotate_skew0=m.rotate_skew0,
            rotate_skew1=m.rotate_skew1,
            translate_x=int(m.translate_x * args.scale),
            translate_y=int(m.translate_y * args.scale),
        )
        import dataclasses

        stage = display.Stage(
            width=math.ceil(stage.width * args.scale),
            height=math.ceil(stage.height * args.scale),
            background_color=stage.background_color,
            children=(dataclasses.replace(child, matrix=scaled),),
        )

    renderer = TorchRenderer(stage.width, stage.height, device=device)
    for bmp_path in args.bitmap:
        renderer.add_bitmap(load_tag(bmp_path))
    frame = renderer.render(stage)
    return write_output(frame, time.perf_counter() - t0)


if __name__ == "__main__":
    raise SystemExit(main())
