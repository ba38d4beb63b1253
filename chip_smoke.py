#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (swf_renderer_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a CI gate

Phases, each of which exits non-zero on failure before the last line:

1. build   — g++ builds the native splitter/packer and nvcc builds the CUDA
             kernels (both from this checkout, started together);
2. kernels — each fused kernel against its plain PyTorch version on the
             card, on random packed scenes (1/4/16 layers, 1, 2 and 6
             strips per plane, the last split over several blocks at 16
             layers; nonzero/even-odd/mixed rules; colour, linear, focal
             and field paints for the styled kernel);
3. headline — ``render_batch_flatblock`` on 60 frames x 4 layers x
             1088x1920 (the benchmark's scene generator, seed 7): host
             lowering, upload, kernel (CUDA events, median of 5 after a
             warm-up), download, Gpx/s; every frame held against the plain
             version on the card;
4. renderer — ``TorchRenderer(1920, 1088).render(stage)`` and
             ``render_batch`` over stages built in code (solid, linear and
             focal gradient, and axis-aligned bitmap fills), one frame held
             against the plain version.

The launch counters of the kernel wrappers are set to 0 right before the
headline and the renderer paths and read right after.  The script prints
one JSON line describing each kernel (time, bound, plain version's time),
then the card's name and power limit as nvidia-smi prints them, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_smoke_out"   # report.json, ptxas.log
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
TOL_LEVELS = 1       # u8 levels per channel, kernel vs plain version
DEVICE = "cuda"
HEADLINE = (60, 4, 1088, 1920)   # frames, layers, height, width


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_cuda(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def byte_diff(torch, a, b):
    """(max |a - b| in u8 levels, share of differing bytes) of two packed
    RGBA int32 tensors."""
    x = a.contiguous().view(torch.uint8).to(torch.int16)
    y = b.contiguous().view(torch.uint8).to(torch.int16)
    d = (x - y).abs()
    return int(d.max().item()), float((d != 0).float().mean().item())


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from swf_renderer_tpu_torch.native import bindings
    from swf_renderer_tpu_torch.ops import cuda_lib

    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn(force=True)
            results[name] = (time.perf_counter() - t0, None)
        except Exception as exc:  # reported below, then the phase fails
            results[name] = (time.perf_counter() - t0, exc)

    threads = [threading.Thread(target=run, args=("g++ native", bindings.build_library)),
               threading.Thread(target=run, args=("nvcc kernels", cuda_lib.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (secs, exc) in results.items():
        if exc is not None:
            fail(f"{name} build: {exc}")
        log(f"build: {name} {secs:.2f} s")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(cuda_lib.build_log)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    cuda_lib.load()
    bindings.load_library()


# ---------------------------------------------------------------------------
# Shared helpers: packing and operation counts
# ---------------------------------------------------------------------------


def pack_scene(tables, height, width, device, spp=None):
    from swf_renderer_tpu_torch.convert import packed_to_device
    from swf_renderer_tpu_torch.native.bindings import pack_grouped_native
    from swf_renderer_tpu_torch.ops.flatblock import (
        plane_geometry, strips_per_plane,
    )
    from swf_renderer_tpu_torch.ops.pipeline import GROUP, lower_update_lists

    _, nc, ns = plane_geometry(height, width)
    if spp is None:
        spp = strips_per_plane(nc, ns)
    updates = lower_update_lists(tables, height, width)
    packed = pack_grouped_native(updates, height, width, group=GROUP,
                                 spp=spp)
    return packed_to_device(*packed, device=device), spp


def kernel_args(dev):
    return (dev["sidx"], dev["flags"], dev["lays"], dev["urc"], dev["ucm"],
            dev["uval"])


def work_counts(torch, dev, frames, layers, spp, rules, paints=(),
                fields=(), colors=None):
    """(bytes, f32 operations) the fused function needs on these inputs:
    every input read once, the resolved rows written once; operations
    counted per valid update, per resolved pixel-layer and per pixel."""
    from swf_renderer_tpu_torch.ops.flatblock import (
        BLK, KPAINT_FIELD, KPAINT_FOCAL, KPAINT_LINEAR, LANE, STRIP_H,
    )

    ins = list(kernel_args(dev)) + list(fields)
    if colors is not None:
        ins.append(colors)
    in_bytes = sum(t.numel() * t.element_size() for t in ins)
    ns, nc = dev["ns"], dev["nc"]
    pixels = frames * ns * spp * STRIP_H * nc * LANE
    out_bytes = pixels * 4
    ng = dev["urc"].shape[0]
    group = dev["lays"].shape[0]
    nblk = (dev["flags"] >> 2).view(ng, 1)
    slot = torch.arange(group, device=nblk.device).view(1, group)
    used = ((nblk == 0) | (slot < nblk)).repeat_interleave(BLK, dim=1)
    valid = int(((dev["uval"].view(ng, -1) != 0) & used).sum().item())
    per_layer = 0
    for lyr in range(layers):
        rule_ops = 2 if rules[lyr] == 0 else 5
        per_layer += 2 + rule_ops + 11     # prefix, carry, rule, composite
        kind = paints[lyr].kind if paints else 0
        if kind in (KPAINT_LINEAR, KPAINT_FOCAL):
            k = len(paints[lyr].stop_ratios)
            per_layer += 8 + (2 if kind == KPAINT_LINEAR else 14) + 3
            per_layer += 4 * 6 * max(k - 1, 0)
        elif kind == KPAINT_FIELD:
            per_layer += 0
    ops = valid + pixels * per_layer + pixels * 21   # quantize + pack
    return in_bytes + out_bytes, ops


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def random_paints(rng, layers, n_fields_max=4):
    from swf_renderer_tpu_torch.ops.flatblock import (
        KPAINT_FOCAL, KPAINT_LINEAR, KernelPaint,
    )

    paints, n_fields = [], 0
    for lyr in range(layers):
        kind = lyr % 4
        k = int(rng.integers(2, 6))
        ratios = sorted(rng.uniform(0, 1, k).astype("float32"))
        ratios[0], ratios[-1] = 0.0, 1.0
        stops = rng.uniform(0, 1, (k, 4)).astype("float32")
        inv = (float(rng.uniform(20, 40)), float(rng.uniform(-5, 5)),
               float(rng.uniform(-5, 5)), float(rng.uniform(20, 40)),
               float(rng.uniform(-20000, -10000)),
               float(rng.uniform(-20000, -10000)))
        if kind == 1:
            paints.append(KernelPaint.gradient(
                KPAINT_LINEAR, inv, ratios, stops, spread=lyr % 3))
        elif kind == 2:
            paints.append(KernelPaint.gradient(
                KPAINT_FOCAL, inv, ratios, stops,
                focal=float(rng.uniform(-0.9, 0.9)), spread=(lyr // 2) % 3))
        elif kind == 3 and n_fields < n_fields_max:
            paints.append(KernelPaint.field(n_fields))
            n_fields += 1
        else:
            paints.append(KernelPaint.color())
    return tuple(paints), n_fields


def phase_kernels(torch, np):
    from swf_renderer_tpu_torch.ops import cuda_lib
    from swf_renderer_tpu_torch.ops.flatblock import (
        field_to_chunkmajor, fused_styled_plain, fusedn_plain,
        render_fused_blocksn, render_fused_styled,
    )
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    lib = cuda_lib.load()
    rng = np.random.default_rng(11)
    worst = {"fusedn": 0, "styled": 0}
    frames = 2
    # (height, width) -> strips per plane: 1 at 2560 px wide, 2 at 1920,
    # 6 at 550 (the default Flash stage), where 16 layers split each
    # plane's strips over several blocks (spb < spp).
    for (height, width), want_spp in (((64, 2560), 1), ((136, 1920), 2),
                                      ((400, 550), 6)):
        for layers in (1, 4, 16):
            spb = {styled: lib.swf_strips_per_block(layers, want_spp, styled)
                   for styled in (0, 1)}
            if want_spp == 6 and layers == 16 and max(spb.values()) >= 6:
                fail(f"the narrow 16-layer case does not split its strips "
                     f"(strips per block {spb})")
            tables, colors = build_scene_edges(
                frames, layers, height, width, shapes_per_layer=6,
                seed=int(rng.integers(1 << 30)))
            dev, spp = pack_scene(tables, height, width, DEVICE)
            if spp != want_spp:
                fail(f"{height}x{width} packs {spp} strips per plane, "
                     f"expected {want_spp}")
            cols = torch.as_tensor(colors, device=DEVICE)
            ns, nc = dev["ns"], dev["nc"]
            mixed = tuple(int(x) for x in rng.integers(0, 2, layers))
            for rule in (0, 1, mixed):
                args = kernel_args(dev) + (cols, frames, layers, ns, nc)
                got = render_fused_blocksn(*args, fill_rule=rule, spp=spp)
                want = fusedn_plain(*args, fill_rule=rule, spp=spp)
                torch.cuda.synchronize()
                dmax, share = byte_diff(torch, got[:, :ns], want[:, :ns])
                tag = rule if isinstance(rule, int) else "mixed"
                log(f"kernels: fusedn L={layers} spp={spp} spb={spb[0]} "
                    f"rule={tag}: "
                    f"max diff {dmax}, differing bytes {share:.3g}")
                if dmax > TOL_LEVELS:
                    fail(f"fusedn kernel vs plain: {dmax} levels")
                worst["fusedn"] = max(worst["fusedn"], dmax)

            paints, n_fields = random_paints(rng, layers)
            fields = tuple(
                field_to_chunkmajor(
                    torch.as_tensor(rng.uniform(0, 1, (height, width, 4))
                                    .astype("float32"), device=DEVICE),
                    ns, nc, spp=spp)
                for _ in range(n_fields))
            args = kernel_args(dev) + (cols, fields, frames, layers, ns, nc,
                                       paints)
            got = render_fused_styled(*args, fill_rule=mixed, spp=spp)
            want = fused_styled_plain(*args, fill_rule=mixed, spp=spp)
            torch.cuda.synchronize()
            dmax, share = byte_diff(torch, got[:, :ns], want[:, :ns])
            log(f"kernels: styled L={layers} spp={spp} spb={spb[1]} kinds="
                f"{[p.kind for p in paints]}: max diff {dmax}, "
                f"differing bytes {share:.3g}")
            if dmax > TOL_LEVELS:
                fail(f"styled kernel vs plain: {dmax} levels")
            worst["styled"] = max(worst["styled"], dmax)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: headline
# ---------------------------------------------------------------------------


def phase_headline(torch, np, report):
    from swf_renderer_tpu_torch.ops.flatblock import (
        fusedn_plain, packed_to_frames, render_fused_blocksn,
    )
    from swf_renderer_tpu_torch.ops.pipeline import render_batch_flatblock
    from swf_renderer_tpu_torch.utils.scenes import build_scene_edges

    frames, layers, height, width = HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width, seed=7)

    # The main path, once, through the user entry point.
    render_fused_blocksn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_main = render_batch_flatblock(tables, colors, height, width,
                                      device=DEVICE)
    wall = time.perf_counter() - t0
    launches = render_fused_blocksn.launches
    if launches < 1:
        fail("render_batch_flatblock did not launch the fused kernel")
    if out_main.shape != (frames, height, width, 4):
        fail(f"headline frames {out_main.shape}")
    coverage = float((out_main[..., 3] > 0).mean())
    if not 0.05 < coverage < 1.0:
        fail(f"headline coverage share {coverage}")
    log(f"headline: render_batch_flatblock wall {wall * 1e3:.1f} ms "
        f"({frames * height * width / wall / 1e9:.3f} Gpx/s end to end), "
        f"kernel launches {launches}, covered share {coverage:.3f}")

    # Breakdown of the same path.
    t0 = time.perf_counter()
    dev_cpu, spp = pack_scene(tables, height, width, "cpu")
    t_lower = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = {k: (v.to(DEVICE) if torch.is_tensor(v) else v)
           for k, v in dev_cpu.items()}
    cols = torch.as_tensor(colors, device=DEVICE)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    ns, nc = dev["ns"], dev["nc"]
    args = kernel_args(dev) + (cols, frames, layers, ns, nc)

    def kernel():
        return render_fused_blocksn(*args, spp=spp)

    def plain():
        return fusedn_plain(*args, spp=spp)

    ms = time_cuda(torch, kernel, reps=5)
    plain_ms = time_cuda(torch, plain, reps=3)
    out = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = packed_to_frames(out, frames, ns, nc, spp, height, width)
    t_d2h = time.perf_counter() - t0
    if not np.array_equal(got, out_main):
        fail("headline: timed kernel output differs from the main path's")
    want = plain()
    dmax, share = byte_diff(torch, out[:, :ns], want[:, :ns])
    log(f"headline: kernel vs plain over all {frames} frames: max diff "
        f"{dmax}, differing bytes {share:.3g}")
    if dmax > TOL_LEVELS:
        fail(f"headline kernel vs plain: {dmax} levels")
    nbytes, ops = work_counts(torch, dev, frames, layers, spp,
                              (0,) * layers, colors=cols)
    bound_ms, bound_by = bound(nbytes, ops)
    pixels = frames * height * width
    log(f"headline: host lowering {t_lower * 1e3:.1f} ms, H2D "
        f"{t_h2d * 1e3:.1f} ms, kernel {ms:.3f} ms "
        f"({pixels / ms / 1e6:.3f} Gpx/s), D2H {t_d2h * 1e3:.1f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop)")
    report["headline"] = {
        "frames": frames, "layers": layers, "height": height,
        "width": width, "spp": spp, "groups": int(dev["urc"].shape[0]),
        "wall_ms": wall * 1e3, "host_lowering_ms": t_lower * 1e3,
        "h2d_ms": t_h2d * 1e3, "kernel_ms": ms, "d2h_ms": t_d2h * 1e3,
        "kernel_gpx_s": pixels / ms / 1e6,
        "end_to_end_gpx_s": pixels / wall / 1e9,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": nbytes, "ops": ops, "max_diff": dmax, "diff_share": share,
    }
    return {"name": "fused_flatblock_solid", "launches": launches,
            "max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------------------
# Phase 4: renderer
# ---------------------------------------------------------------------------


def _shape_tag(ast, shape_id, fill, points):
    """A DefineShape of one closed polygon (twips) with one fill."""
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    records = [ast.StyleChangeRecord(
        left_fill=None, right_fill=1, line_style=None,
        move_to=ast.Vector2D(x=points[0][0], y=points[0][1]),
        new_styles=None)]
    for (x0, y0), (x1, y1) in zip(points, points[1:] + points[:1]):
        records.append(ast.EdgeRecord(delta=ast.Vector2D(x=x1 - x0,
                                                         y=y1 - y0)))
    return ast.DefineShape(
        id=shape_id,
        bounds=ast.Rect(x_min=min(xs), x_max=max(xs), y_min=min(ys),
                        y_max=max(ys)),
        shape=ast.ShapeBody(
            initial_styles=ast.ShapeStyles(fill=[fill], line=[]),
            records=records))


def _matrix(ast, tx, ty, scale=1.0):
    from swf_renderer_tpu_torch.utils.fixed import Sfixed16P16

    s = Sfixed16P16.from_value(scale)
    z = Sfixed16P16.from_value(0.0)
    return ast.Matrix(scale_x=s, scale_y=s, rotate_skew0=z, rotate_skew1=z,
                      translate_x=int(tx), translate_y=int(ty))


def build_stages(np, n_frames=3):
    """Stages of a 1920x1088 scene: solid polygons that move from frame to
    frame, a linear and a focal gradient and an axis-aligned bitmap
    fill."""
    from swf_renderer_tpu_torch.models import ast, display
    from swf_renderer_tpu_torch.runtime.bitmap_service import (
        encode_x_swf_bmp2_argb,
    )

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 32, 4)).astype(np.uint8)
    bitmap = ast.DefineBitmap(id=9, width=32, height=24,
                              media_type="image/x-swf-bmp2",
                              data=encode_x_swf_bmp2_argb(img))
    grad = ast.Gradient(
        spread=ast.GradientSpread.PAD, color_space=ast.ColorSpace.S_RGB,
        colors=[ast.GradientStop(0, ast.StraightSRgba8(255, 0, 0, 255)),
                ast.GradientStop(128, ast.StraightSRgba8(0, 255, 0, 200)),
                ast.GradientStop(255, ast.StraightSRgba8(0, 0, 255, 255))])
    box = [(0, 0), (16000, 0), (16000, 12000), (0, 12000)]
    linear = _shape_tag(ast, 1, ast.LinearGradientFill(
        matrix=_matrix(ast, 8000, 6000, 0.5), gradient=grad), box)
    focal = _shape_tag(ast, 2, ast.FocalGradientFill(
        matrix=_matrix(ast, 20000, 12000, 0.6), gradient=grad,
        focal_point_epsilons=100), [(x + 14000, y + 6000) for x, y in box])
    bmp = _shape_tag(ast, 3, ast.BitmapFill(
        bitmap_id=9, matrix=_matrix(ast, 2000, 9000, 20.0), repeating=True,
        smoothed=True), [(x // 2 + 2000, y // 2 + 9000) for x, y in box])
    star = [(int(4000 * np.cos(a) * (1.0 if i % 2 else 0.45)),
             int(4000 * np.sin(a) * (1.0 if i % 2 else 0.45)))
            for i, a in enumerate(np.linspace(0, 2 * np.pi, 10,
                                              endpoint=False))]
    solid = _shape_tag(ast, 4, ast.SolidFill(
        ast.StraightSRgba8(40, 90, 200, 230)), star)
    stages = []
    for f in range(n_frames):
        stages.append(display.Stage(
            width=1920, height=1088,
            children=[
                display.ShapeInstance(definition=linear),
                display.ShapeInstance(definition=focal),
                display.ShapeInstance(definition=bmp),
                display.ShapeInstance(
                    definition=solid,
                    matrix=_matrix(ast, 9000 + 3000 * f, 10000 + 900 * f)),
            ]))
    return stages, bitmap


def phase_renderer(torch, np, report):
    from swf_renderer_tpu_torch.convert import packed_to_device
    from swf_renderer_tpu_torch.ops.flatblock import (
        fused_styled_plain, packed_to_frames, render_fused_styled,
    )
    from swf_renderer_tpu_torch.ops.pipeline import (
        _pack_styled, kernel_paints_for,
    )
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    stages, bitmap = build_stages(np)
    renderer = TorchRenderer(1920, 1088, device=DEVICE)
    renderer.add_bitmap(bitmap)

    # The main path, once: render(stage) and render_batch(stages).
    render_fused_styled.launches = 0
    t0 = time.perf_counter()
    frame = renderer.render(stages[0])
    t_render = time.perf_counter() - t0
    path_one = renderer.last_stats.path
    t0 = time.perf_counter()
    batch = renderer.render_batch(stages)
    t_batch = time.perf_counter() - t0
    path_batch = renderer.last_stats.path
    launches = render_fused_styled.launches
    if launches < 2:
        fail(f"renderer launched the styled kernel {launches} times")
    if path_one != "flatblock" or path_batch != "batched-styled":
        fail(f"renderer paths {path_one!r}, {path_batch!r}")
    if frame.shape != (1088, 1920, 4) or batch.shape != (3, 1088, 1920, 4):
        fail(f"renderer shapes {frame.shape}, {batch.shape}")
    if not np.array_equal(batch[0], frame):
        fail("render_batch frame 0 differs from render(stage)")
    log(f"renderer: render {t_render * 1e3:.1f} ms (path {path_one}), "
        f"render_batch x{len(stages)} {t_batch * 1e3:.1f} ms (path "
        f"{path_batch}), styled launches {launches}")

    # Hold frame 0 against the plain version on the same inputs.
    draws = renderer._compiler().compile_stage(stages[0])
    paints = [d.paint for d in draws]
    tables = [[d.edges for d in draws]]
    *arrays, spp = _pack_styled(tables, 1088, 1920, None)
    kpaints, fields, base = kernel_paints_for(paints, 1088, 1920, spp=spp,
                                              device=DEVICE)
    dev = packed_to_device(*arrays, device=DEVICE)
    cols = torch.as_tensor(base[None], device=DEVICE)
    ns, nc = dev["ns"], dev["nc"]
    layers = len(paints)
    rules = tuple(d.fill_rule for d in draws)
    args = kernel_args(dev) + (cols, fields, 1, layers, ns, nc, kpaints)

    def kernel():
        return render_fused_styled(*args, fill_rule=rules, spp=spp)

    def plain():
        return fused_styled_plain(*args, fill_rule=rules, spp=spp)

    out = kernel()
    want = plain()
    torch.cuda.synchronize()
    dmax, share = byte_diff(torch, out[:, :ns], want[:, :ns])
    got = packed_to_frames(out, 1, ns, nc, spp, 1088, 1920)[0]
    if not np.array_equal(got, frame):
        fail("renderer frame differs from a direct kernel call")
    log(f"renderer: kernel vs plain: max diff {dmax}, differing bytes "
        f"{share:.3g}, paint kinds {[p.kind for p in kpaints]}")
    if dmax > TOL_LEVELS:
        fail(f"styled kernel vs plain on the renderer frame: {dmax}")
    ms = time_cuda(torch, kernel, reps=5)
    plain_ms = time_cuda(torch, plain, reps=3)
    nbytes, ops = work_counts(torch, dev, 1, layers, spp, rules,
                              paints=kpaints, fields=fields, colors=cols)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"renderer: styled kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    report["renderer"] = {
        "render_ms": t_render * 1e3, "render_batch_ms": t_batch * 1e3,
        "batch_frames": len(stages), "layers": layers, "spp": spp,
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "max_diff": dmax, "diff_share": share,
    }
    return {"name": "fused_flatblock_styled", "launches": launches,
            "max_abs_err": dmax, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(ROOT))
    try:
        import swf_renderer_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port's package is not beside this script: {exc}")

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    report = {}
    phase_build()
    worst = phase_kernels(torch, np)
    kernels = {"fusedn": phase_headline(torch, np, report),
               "styled": phase_renderer(torch, np, report)}
    for key, k in kernels.items():
        k["max_abs_err"] = max(k["max_abs_err"], worst[key])

    meta = {
        "fusedn": ("swf_renderer_tpu/ops/flatblock.py:784",),
        "styled": ("swf_renderer_tpu/ops/flatblock.py:1083",),
    }
    line = {"kernels": [
        dict(name=k["name"], route="cuda",
             source="swf_renderer_tpu_torch/csrc/flatblock.cu",
             replaces=meta[key][0], launches=k["launches"],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"], library_ms=None)
        for key, k in kernels.items()]}
    card = card_line()
    report.update(kernels=line["kernels"], card=card,
                  seconds=time.perf_counter() - t_start)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "report.json").write_text(json.dumps(report, indent=1))
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
