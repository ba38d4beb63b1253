"""Decompose the flagship pipeline and measure design primitives.

    python3 -m swf_renderer_tpu_torch.tools.exp_scatter [A B C D E]

Port of the reference's ``tools/exp_scatter.py``; with no argument every
experiment runs.  Needs one NVIDIA card and ``nvcc``.  Times are CUDA
events (median of 5 after a warm-up; the reference took the best of 3
host-timed calls of a chained jitted loop).

  A  the reference's ``segment_sum`` of the headline scene's updates (60
     frames x 4 layers x 1088x1920, ``pack_updates``) in chunks of 4
     frames, sorted indices: ``index_put_(accumulate=True)``, the port's
     deterministic scatter;
  B  the same with ``unique_indices=True``: ``index_put_`` without
     accumulation (``pack_updates`` pads each draw with value-0 copies of
     its last update, so the winner among those equal indices is not
     defined, as in the reference);
  C  ``ops.resolve.resolve_frames`` (B12) alone on seeded planes, 15
     calls of 4 frames;
  D  the cost of one grid step: ``step_probe`` (x + 1, one CUDA block an
     (8, 128) tile, the probes library) on 16384 and 131072 tiles;
  E  the one-hot placement product (8, 32) @ (128, 32)^T over 8192 bins:
     an f32 ``bmm`` (TF32 off) against three bf16 products of the
     value's hi / mid / lo split with f32 accumulation (``dot_3``).

Prints the reference's lines, then the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from .exp_bw import geometry, launch_probe

FRAMES, LAYERS, H, W = 60, 4, 1088, 1920
LANE, STRIP_H = 128, 8
STRIDE = ((W + 1 + LANE - 1) // LANE) * LANE
HP = H + (-H % STRIP_H)
PLANE = HP * STRIDE
CF = 4                      # frames a chunk (A, B, C)
STEPS = (16384, 131072)     # D
BINS, KC = 8192, 32         # E


def segment_sum(vals, idx, num_segments: int, unique: bool = False):
    """``jax.ops.segment_sum(vals, idx, num_segments)`` over int64 ``idx``
    in [0, num_segments): every value added (``unique`` False), or each
    index written once (``unique`` True, where the reference promises
    unique indices)."""
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=not unique)


def _bf16_bmm(x, pb):
    """Batched x @ pb^T of bf16 operands with f32 accumulation and an f32
    result.  On the card ``torch.bmm(..., out_dtype=torch.float32)`` (a
    bf16 ``bmm`` would round its result to bf16); on the CPU, which has
    no such kernel, an f32 product of the same bf16 values (each product
    exact in f32)."""
    if x.device.type == "cuda":
        return torch.bmm(x, pb.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(x.float(), pb.float().transpose(1, 2))


def dot_h(a, p):
    """(bins, 8, K) x (bins, 128, K) -> (bins, 8, 128) in f32 (the
    reference's Precision.HIGHEST; TF32 must be off on the card)."""
    return torch.bmm(a, p.transpose(1, 2))


def dot_3(a, p):
    """The reference's three-pass bf16 split: a = hi + mid + lo, each a
    bf16 product with f32 accumulation, summed in f32."""
    hi = a.to(torch.bfloat16)
    mid = (a - hi.float()).to(torch.bfloat16)
    lo = (a - hi.float() - mid.float()).to(torch.bfloat16)
    pb = p.to(torch.bfloat16)
    return _bf16_bmm(hi, pb) + _bf16_bmm(mid, pb) + _bf16_bmm(lo, pb)


def step_probe(x):
    """x + 1 on (steps, 8, 128) float32, one CUDA block per (8, 128)
    tile: the cost of one step of the grid.

    Kernel: replaces ``exp_D.<locals>.kernel`` (tools/exp_scatter.py:121);
    the passthrough of csrc/probes.cu with one tile a block.  Bound:
    bytes.  On the CPU ``x + 1.0`` runs."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (STRIP_H, LANE) or \
            x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"expected contiguous float32 (steps, 8, 128), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return x + 1.0
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    geo = geometry((1, x.shape[0], 1, STRIP_H, LANE), "nsl")
    out = launch_probe("swf_passthrough", x, torch.empty_like(x), geo)
    step_probe.launches += 1
    return out


step_probe.launches = 0


def scene_updates():
    """The headline scene's padded updates: rows, cols, vals (F, L, n)
    numpy arrays, and the (F, L, 4) colours."""
    from ..ops.pipeline import lower_update_lists
    from ..ops.resolve import pack_updates
    from ..utils.scenes import build_scene_edges

    tables, colors = build_scene_edges(FRAMES, LAYERS, H, W)
    ups = [u for per in lower_update_lists(tables, H, W) for u in per]
    rows, cols, vals = pack_updates(ups)
    shape = (FRAMES, LAYERS, -1)
    return (rows.reshape(shape), cols.reshape(shape), vals.reshape(shape),
            colors)


def exp_a_b(time_ms, updates, unique: bool):
    rows, cols, vals = (torch.from_numpy(x).cuda() for x in updates[:3])
    n = rows.shape[-1]
    base = ((torch.arange(CF).view(CF, 1, 1) * LAYERS
             + torch.arange(LAYERS).view(1, LAYERS, 1)) * PLANE).cuda()

    def scatter_all():
        total = torch.zeros((), device="cuda")
        for c in range(0, FRAMES, CF):
            idx = base + rows[c:c + CF].long() * STRIDE + cols[c:c + CF].long()
            planes = segment_sum(vals[c:c + CF].reshape(-1), idx.reshape(-1),
                                 CF * LAYERS * PLANE, unique)
            total = total + torch.sum(planes * planes)
        return total

    ms = time_ms(torch, scatter_all)
    nup = FRAMES * LAYERS * n
    print(f"[{'B' if unique else 'A'}] scatter "
          f"{'unique' if unique else 'sorted'}: {ms:.1f} ms total, "
          f"{ms / nup * 1e6:.1f} ns/update ({nup} updates) "
          f"csum={float(scatter_all()):.3e}", flush=True)


def exp_c(time_ms, colors):
    from ..ops.resolve import resolve_frames

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    planes = torch.randn((CF, LAYERS, HP, STRIDE), generator=gen,
                         device="cuda")
    col = torch.as_tensor(colors[:CF], device="cuda")

    def run():
        return [resolve_frames(planes, col) for _ in range(FRAMES // CF)]

    ms = time_ms(torch, run)
    csum = sum(float(o.sum()) for o in run())
    print(f"[C] resolve alone: {ms:.1f} ms for {FRAMES} frames "
          f"({FRAMES * H * W / ms / 1e6:.2f} Gpx/s) csum={csum:.3e}",
          flush=True)


def exp_d(time_ms):
    for steps in STEPS:
        x = torch.zeros((steps, STRIP_H, LANE), device="cuda")
        ms = time_ms(torch, lambda: step_probe(x))
        print(f"[D] {steps} grid steps: {ms:.2f} ms, "
              f"{ms / steps * 1e6:.0f} ns/step "
              f"csum={float(step_probe(x).sum()):.3e}", flush=True)


def one_hot_inputs(device, bins: int = BINS, seed: int = 1):
    """E's inputs: a (bins, 8, KC) standard normal, p (bins, 128, KC) ones
    at 5% of the places, from a seeded generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a = torch.randn((bins, STRIP_H, KC), generator=gen, device=device)
    p = (torch.rand((bins, LANE, KC), generator=gen, device=device)
         < 0.05).float()
    return a, p


def exp_e(time_ms):
    torch.backends.cuda.matmul.allow_tf32 = False
    a, p = one_hot_inputs("cuda")
    for name, fn in (("HIGHEST", dot_h), ("bf16x3", dot_3)):
        ms = time_ms(torch, lambda fn=fn: fn(a, p))
        print(f"[E] {name}: {ms / BINS * 1e6:.0f} ns/bin ({BINS} bins = "
              f"{ms:.3f} ms) csum={float(fn(a, p).sum()):.3e}", flush=True)
    diff = (dot_h(a[:64], p[:64]) - dot_3(a[:64], p[:64])).abs().max()
    print(f"[E] max |HIGHEST - bf16x3| = {float(diff):.3e}", flush=True)


def main() -> None:
    from .timing import card_line, time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", choices=list("ABCDE"))
    which = set(ap.parse_args().which) or set("ABCDE")
    if not torch.cuda.is_available():
        raise SystemExit("exp_scatter needs a CUDA card")
    updates = scene_updates() if which & set("ABC") else None
    if "A" in which:
        exp_a_b(time_ms, updates, False)
    if "B" in which:
        exp_a_b(time_ms, updates, True)
    if "C" in which:
        exp_c(time_ms, updates[3])
    if "D" in which:
        exp_d(time_ms)
    if "E" in which:
        exp_e(time_ms)
    print(card_line())


if __name__ == "__main__":
    main()
